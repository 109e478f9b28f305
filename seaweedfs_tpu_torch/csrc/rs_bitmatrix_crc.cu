// K2: K1's parity plus one position-shifted CRC32-C partial per
// 4096-byte tile of every data and parity row (the `.ecc` sidecar).
//
// Replaces the Pallas TPU kernel seaweedfs_tpu/ops/coder_pallas.py
// apply_bitmatrix_crc_pallas (_rs_crc_kernel).  The CRC algebra is
// ops/crc_fold.py's: for one row of one tile,
//   u_s  = XOR over columns c with bit s of byte c set of W0[c]   (s < 8)
//   v    = XOR_s A_s(u_s)             (plane fold, 32x32 GF(2) mat-vecs)
//   part = P_j(v),  j = tile mod tpb  (position inside the 1 MiB block)
// with every 32-bit vector packed into one word and every 32x32 matrix
// given by its 32 packed columns, so a mat-vec is 32 masked XORs.
//
// One block owns one 4096-column tile, 256 threads of 16 columns each.
// Parity is computed as in K1, stored once and folded into its CRC from
// registers: it is never read back from device memory.  Per-thread
// plane sums are XOR-reduced across the block with warp shuffles and
// then shared memory; the folds run per row once per block.  Blocks run
// in any order and share nothing: the tile index comes from blockIdx.
//
// Bound on an H100: reads k*n, writes r*n plus 4 bytes per row per tile;
// (8r*8k + (k+r)*8*32) bit-ops per byte column.  Device memory bounds
// the work (bytes / 3.35 TB/s); this first version spends about
// 16*8*3 integer operations per row per thread on the W0 contraction,
// so it runs several times above that bound.
//
// in_rows <= 16, out_rows <= 16, n a multiple of 4096, the input starting
// on an `.ecc` block boundary.  Launches on the caller's stream, does
// not synchronise, allocates nothing.

#include "rs_bitmatrix.cuh"

namespace {

using rsbm::kThreads;
using rsbm::kTile;
using rsbm::kWords;

constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4 * kWords;  // byte columns per thread

// Per-thread plane sums of one row over this thread's kCols columns,
// XOR-reduced over the warp; lane 0 leaves the 8 words at dst.
__device__ __forceinline__ void row_crc(const uint32_t (&xw)[kWords],
                                        const uint32_t (&w)[kCols],
                                        uint32_t* dst, int lane) {
  uint32_t u[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < kCols; ++b) {
    const uint32_t byte = xw[b / 4] >> (8 * (b % 4));
#pragma unroll
    for (int s = 0; s < 8; ++s) u[s] ^= w[b] & (0u - ((byte >> s) & 1u));
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      u[s] ^= __shfl_xor_sync(0xffffffffu, u[s], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < 8; ++s) dst[s] = u[s];
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
    rs_bitmatrix_crc_kernel(const uint8_t* __restrict__ masks, int out_rows,
                            int in_rows, const uint8_t* __restrict__ in,
                            uint8_t* __restrict__ out, long long n,
                            const uint32_t* __restrict__ w0,
                            const uint32_t* __restrict__ plane_cols,
                            const uint32_t* __restrict__ pos_cols, int tpb,
                            uint32_t* __restrict__ partials) {
  extern __shared__ uint32_t smem[];
  const int nmask = 8 * out_rows * in_rows;
  uint32_t* smask = smem;              // nmask replicated masks
  uint32_t* splane = smask + nmask;    // 8 x 32 packed plane-fold columns
  uint32_t* red = splane + 8 * 32;     // rows x kWarps x 8 warp sums
  rsbm::load_masks(masks, nmask, smask);
  for (int q = threadIdx.x; q < 8 * 32; q += kThreads) splane[q] = plane_cols[q];
  __syncthreads();

  const long long tile = blockIdx.x;
  const long long ntiles = gridDim.x;
  const long long word0 = tile * (kTile / 4) + threadIdx.x * kWords;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  uint32_t w[kCols];  // W0 words of this thread's columns
#pragma unroll
  for (int v = 0; v < kWords; ++v) {
    const uint4 q = reinterpret_cast<const uint4*>(w0)[threadIdx.x * kWords + v];
    w[4 * v] = q.x;
    w[4 * v + 1] = q.y;
    w[4 * v + 2] = q.z;
    w[4 * v + 3] = q.w;
  }

  uint32_t x[KMAX][kWords];
  rsbm::load_rows<KMAX>(in, n, word0, in_rows, x);
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < in_rows) row_crc(x[j], w, red + (j * kWarps + warp) * 8, lane);
  }
  for (int i = 0; i < out_rows; ++i) {
    uint32_t o[kWords];
    rsbm::mix_row<KMAX>(smask, out_rows, in_rows, i, x, o);
    reinterpret_cast<uint4*>(out + i * n)[word0 / kWords] =
        make_uint4(o[0], o[1], o[2], o[3]);
    row_crc(o, w, red + ((in_rows + i) * kWarps + warp) * 8, lane);
  }
  __syncthreads();

  const uint32_t* pos = pos_cols + (tile % tpb) * 32;
  for (int r = threadIdx.x; r < in_rows + out_rows; r += kThreads) {
    uint32_t v = 0u;
    for (int s = 0; s < 8; ++s) {
      uint32_t u = 0u;
      for (int wp = 0; wp < kWarps; ++wp) u ^= red[(r * kWarps + wp) * 8 + s];
      const uint32_t* a = splane + s * 32;
      for (int o = 0; o < 32; ++o) v ^= a[o] & (0u - ((u >> o) & 1u));
    }
    uint32_t sh = 0u;
    for (int b = 0; b < 32; ++b) sh ^= pos[b] & (0u - ((v >> b) & 1u));
    partials[r * ntiles + tile] = sh;
  }
}

}  // namespace

// masks: (8*out_rows, in_rows) uint8; in: (in_rows, n) uint8;
// out: (out_rows, n) uint8; w0: (4096,) packed words; plane_cols: (8*32,);
// pos_cols: (tpb*32,); partials: (in_rows+out_rows, n/4096) 32-bit words.
// Returns a cudaError_t value (0 = launched).
extern "C" int rs_bitmatrix_crc(const void* masks, int out_rows, int in_rows,
                                const void* in, void* out, long long n,
                                const void* w0, const void* plane_cols,
                                const void* pos_cols, int tpb, void* partials,
                                int device, void* stream) {
  if (out_rows < 1 || out_rows > 16 || in_rows < 1 || in_rows > 16 ||
      n <= 0 || n % kTile != 0 || tpb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(n / kTile);
  const int rows = in_rows + out_rows;
  const size_t smem =
      sizeof(uint32_t) * (8 * out_rows * in_rows + 8 * 32 + rows * kWarps * 8);
  rs_bitmatrix_crc_kernel<16><<<blocks, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), out_rows, in_rows,
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n,
      static_cast<const uint32_t*>(w0), static_cast<const uint32_t*>(plane_cols),
      static_cast<const uint32_t*>(pos_cols), tpb,
      static_cast<uint32_t*>(partials));
  return static_cast<int>(cudaGetLastError());
}
