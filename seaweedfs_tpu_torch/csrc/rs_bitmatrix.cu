// K1: GF(2^8) matrix mix of byte shards as a GF(2) bit-matrix product.
//
// Replaces the Pallas TPU kernel seaweedfs_tpu/ops/coder_pallas.py
// apply_bitmatrix_pallas (_rs_kernel), which unpacks bytes to bit
// planes and runs an (8r x 8k) @ (8k x BN) matmul on the MXU.  Here the
// bit-matrix is packed into one 8-bit mask per (output bit row, input
// row) and every output bit is an AND/parity over packed bytes (see
// rs_bitmatrix.cuh): no unpacked planes, no matmul unit.
//
// What bounds it on an H100.  The call reads k*n bytes and writes r*n:
// at RS(10,4) and n = 4 MiB that is 58.7 MB, 0.0175 ms at 3.35 TB/s.  The
// work is integer instructions: per byte column (four columns per 32-bit
// operation) 8r*k/4 AND-XORs plus the parity extraction.  The first
// version spent about 150-160 integer operations and 20 shared-memory
// loads per column (each mask a per-lane LDS from a runtime address, the
// rows behind a runtime guard, 8 separate byte-parity folds of 9
// operations) at 110 registers, 2 blocks per SM; at about 16.7 T int32
// operations/s (132 SMs x 64 lanes x ~1.98 GHz) it was issue-bound at
// 0.081 ms, not memory-bound.
//
// This design:
// - the shapes the main path launches have their own instantiations
//   (rs_fixed<4, 10> for encode, rebuild and verify; rs_fixed<1, 10> for
//   the one missing shard of a degraded-read interval).  Their loops
//   unroll fully over exactly 10 input rows, one 32-bit word of each at a
//   time (10 inputs live: 16-byte loads of 4 words held 40 and spilled at
//   the 80-register cap of 3 blocks per SM), and the mask words arrive by
//   value as a __grid_constant__ parameter: each AND-XOR is one LOP3 with
//   a launch-uniform operand, 8*4*10/4 = 80 per column at 10 -> 4, no LDS;
// - the parity extraction is a SWAR butterfly whose first level is folded
//   into the mask words (rs_bitmatrix.cuh): a nibble swap of each input
//   word (3 operations, shared by the 4 output rows) and 15 operations per
//   output word, 22.5 per column at 10 -> 4 where 8 separate folds cost
//   72 per word, 72 per column;
// - what bounds it now is the integer ALU pipe (64 lanes per clock per
//   SM, 16.7 T operations/s): the SASS of rs_fixed<4, 10> has 1504 LOP3,
//   89 SHF and 31 IADD3 per thread of 16 columns, about 101 ALU
//   operations per column, 0.025 ms at 4 MiB if that pipe never idled
//   (0.036 ms measured on an H100).  Variants with fewer instructions but
//   more ALU ones ran slower (PERF.md);
// - __launch_bounds__(256, 3) for the fixed shapes: 3 blocks (24 warps)
//   per SM; ptxas reports 79 registers for rs_fixed<4, 10> and 47 for
//   rs_fixed<1, 10>, no spills (100 and 166 for the generic ones).
// Every other shape (<= 32 rows in and out) runs rs_generic<16> or
// rs_generic<32>: masks replicated into shared memory from a device copy,
// rows behind a runtime guard, the same merged parity.  ops/coder_cuda.py
// picks the instantiation (K1_VARIANTS) and passes its index.
//
// Tensor cores were weighed and not taken: an int8 mma needs each bit
// spread into its own byte (about 60-70 ALU operations per column, as
// many as the MMA saves), and no mask can be skipped (the RS(10,4) parity
// masks and seeded decode sets have 0 zero masks of 320, 46-50 % of the
// bits set).
//
// Volume axis: a call mixes V independent volumes that share one matrix
// (the batched encode and rebuild steps of parallel/sharded_codec.py).
// Volume v reads in + v*in_rows*n and writes out + v*out_rows*n; the grid
// is (blocks, V), so a volume is one blockIdx.y offset and the masks stay
// launch-uniform.  A single-volume call is V = 1.
//
// Rows contiguous and 16-byte aligned, n a multiple of 16.  Launches on
// the caller's stream, does not synchronise, allocates nothing.

#include <cstring>

#include "rs_bitmatrix.cuh"

namespace {

using rsbm::kThreads;
using rsbm::kTile;
using rsbm::kWords;

// Word v of this thread is word (blockIdx.x * kWords + v) * kThreads +
// threadIdx.x of every row: each load and store of a warp covers 128
// contiguous bytes, and one word of every row at a time keeps 10 inputs
// live.  The straight-line body lets the loads of one word overlap the
// arithmetic of the one before; wrapped in a loop (a grid-stride one, or
// groups per block) ptxas kept the mask words live across iterations and
// spilled.
template <int OUT, int IN>
__global__ void __launch_bounds__(kThreads, 3)
    rs_fixed(const __grid_constant__ rsbm::MaskWords<OUT, IN> m,
             const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
             long long n) {
  const long long nw = n / 4;
  in += static_cast<long long>(blockIdx.y) * (IN * nw);
  out += static_cast<long long>(blockIdx.y) * (OUT * nw);
#pragma unroll
  for (int v = 0; v < kWords; ++v) {
    const long long w =
        (static_cast<long long>(blockIdx.x) * kWords + v) * kThreads +
        threadIdx.x;
    if (w >= nw) return;
    uint32_t z[IN];
#pragma unroll
    for (int j = 0; j < IN; ++j) z[j] = in[j * nw + w];
    uint32_t o[OUT];
    rsbm::mix_fixed_word<OUT, IN>(m, z, o);
#pragma unroll
    for (int i = 0; i < OUT; ++i) out[i * nw + w] = o[i];
  }
}

template <int KMAX, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
    rs_generic(const uint8_t* __restrict__ masks, int out_rows, int in_rows,
               const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
               long long n) {
  extern __shared__ uint32_t smask[];
  rsbm::load_masks(masks, out_rows, in_rows, smask);
  __syncthreads();
  in += static_cast<long long>(blockIdx.y) * in_rows * n;
  out += static_cast<long long>(blockIdx.y) * out_rows * n;

  const long long word0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kWords;
  if (word0 * 4 >= n) return;

  uint32_t x[KMAX][kWords];
  rsbm::load_rows<KMAX>(in, n, word0, in_rows, x);
  for (int i = 0; i < out_rows; ++i) {
    uint32_t o[kWords];
    rsbm::mix_shared<KMAX>(smask, out_rows, in_rows, i, x, o);
    reinterpret_cast<uint4*>(out + i * n)[word0 / kWords] =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <int OUT, int IN>
cudaError_t launch_fixed(const void* host_words, const uint8_t* in,
                         uint8_t* out, long long n, dim3 blocks,
                         cudaStream_t st) {
  rsbm::MaskWords<OUT, IN> m;
  std::memcpy(m.w, host_words, sizeof(m.w));
  rs_fixed<OUT, IN><<<blocks, kThreads, 0, st>>>(
      m, reinterpret_cast<const uint32_t*>(in), reinterpret_cast<uint32_t*>(out),
      n);
  return cudaGetLastError();
}

}  // namespace

// variant: index into ops/coder_cuda.py K1_VARIANTS —
//   0: 10 -> 4 fixed, 1: 10 -> 1 fixed (host_words: the 8*out*in mask
//   words, read here on the host and passed by value),
//   2: generic, in_rows <= 16, 3: generic, in_rows <= 32 (dev_masks: the
//   (8*out_rows, in_rows) uint8 masks on the device).
// in: (volumes, in_rows, n) uint8; out: (volumes, out_rows, n) uint8.
// Returns a cudaError_t value (0 = launched).
extern "C" int rs_bitmatrix(int variant, const void* host_words,
                            const void* dev_masks, int out_rows, int in_rows,
                            const void* in, void* out, long long n,
                            int volumes, int device, void* stream) {
  if (out_rows < 1 || out_rows > 32 || in_rows < 1 || in_rows > 32 ||
      n <= 0 || n % 16 != 0 || volumes < 1 || volumes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks(static_cast<unsigned>((n + kTile - 1) / kTile),
                    static_cast<unsigned>(volumes));
  auto st = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(out);
  const auto* m = static_cast<const uint8_t*>(dev_masks);
  const size_t smem = sizeof(uint32_t) * 8 * out_rows * in_rows;
  switch (variant) {
    case 0:
      if (in_rows != 10 || out_rows != 4 || host_words == nullptr) break;
      return static_cast<int>(
          launch_fixed<4, 10>(host_words, src, dst, n, blocks, st));
    case 1:
      if (in_rows != 10 || out_rows != 1 || host_words == nullptr) break;
      return static_cast<int>(
          launch_fixed<1, 10>(host_words, src, dst, n, blocks, st));
    case 2:
      if (in_rows > 16 || m == nullptr) break;
      rs_generic<16, 2><<<blocks, kThreads, smem, st>>>(m, out_rows, in_rows,
                                                        src, dst, n);
      return static_cast<int>(cudaGetLastError());
    case 3:
      if (m == nullptr) break;
      rs_generic<32, 1><<<blocks, kThreads, smem, st>>>(m, out_rows, in_rows,
                                                        src, dst, n);
      return static_cast<int>(cudaGetLastError());
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
