// K1: GF(2^8) matrix mix of byte shards as a GF(2) bit-matrix product.
//
// Replaces the Pallas TPU kernel seaweedfs_tpu/ops/coder_pallas.py
// apply_bitmatrix_pallas (_rs_kernel), which unpacks bytes to bit
// planes and runs an (8r x 8k) @ (8k x BN) matmul on the MXU.  Here the
// bit-matrix is packed into one 8-bit mask per (output bit row, input
// row) and every output bit is an AND/parity over packed bytes (see
// rs_bitmatrix.cuh): no unpacked planes, no matmul unit.
//
// Bound on an H100: the call reads k*n bytes and writes r*n, and does
// 8r*8k*n single-bit AND/XOR operations; at RS(10,4) that is 14 bytes of
// traffic against 2560 bit-ops per byte column, so device memory bounds
// it (bytes / 3.35 TB/s).  The integer pipes do about 8r*(k+8) 32-bit
// operations per four columns, which on this design costs more than the
// memory traffic; the tensor-core form is the next step if it matters.
//
// Used by encode (parity matrix), rebuild and degraded reads (decode
// matrix for the survivor set).  in_rows <= 32, out_rows <= 32, n a
// multiple of 16, rows contiguous and 16-byte aligned.  Launches on the
// caller's stream, does not synchronise, allocates nothing.

#include "rs_bitmatrix.cuh"

namespace {

using rsbm::kThreads;
using rsbm::kTile;
using rsbm::kWords;

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
    rs_bitmatrix_kernel(const uint8_t* __restrict__ masks, int out_rows,
                        int in_rows, const uint8_t* __restrict__ in,
                        uint8_t* __restrict__ out, long long n) {
  extern __shared__ uint32_t smask[];
  rsbm::load_masks(masks, 8 * out_rows * in_rows, smask);
  __syncthreads();

  const long long word0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kWords;
  if (word0 * 4 >= n) return;  // n % 16 == 0: a live thread has all 16 bytes

  uint32_t x[KMAX][kWords];
  rsbm::load_rows<KMAX>(in, n, word0, in_rows, x);
  for (int i = 0; i < out_rows; ++i) {
    uint32_t o[kWords];
    rsbm::mix_row<KMAX>(smask, out_rows, in_rows, i, x, o);
    reinterpret_cast<uint4*>(out + i * n)[word0 / kWords] =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

// masks: (8*out_rows, in_rows) uint8; in: (in_rows, n) uint8;
// out: (out_rows, n) uint8.  Returns a cudaError_t value (0 = launched).
extern "C" int rs_bitmatrix(const void* masks, int out_rows, int in_rows,
                            const void* in, void* out, long long n,
                            int device, void* stream) {
  if (out_rows < 1 || out_rows > 32 || in_rows < 1 || in_rows > 32 ||
      n <= 0 || n % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
  const size_t smem = sizeof(uint32_t) * 8 * out_rows * in_rows;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const uint8_t*>(masks);
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(out);
  if (in_rows <= 16) {
    rs_bitmatrix_kernel<16><<<blocks, kThreads, smem, st>>>(
        m, out_rows, in_rows, src, dst, n);
  } else {
    rs_bitmatrix_kernel<32><<<blocks, kThreads, smem, st>>>(
        m, out_rows, in_rows, src, dst, n);
  }
  return static_cast<int>(cudaGetLastError());
}
