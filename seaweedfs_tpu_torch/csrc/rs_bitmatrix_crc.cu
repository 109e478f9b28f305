// K2: K1's parity plus one position-shifted CRC32-C partial per
// 4096-byte tile of every data and parity row (the `.ecc` sidecar).
//
// Replaces the Pallas TPU kernel seaweedfs_tpu/ops/coder_pallas.py
// apply_bitmatrix_crc_pallas (_rs_crc_kernel).  The partial of one row of
// tile t is ops/crc_fold.py's
//   part = P_(t mod tpb)( step(0, tile bytes) ),
// step(x, m) the CRC32-C register advanced over m without the pre/post
// inversions, P_j the shift to the tile's place in its 1 MiB block.  The
// TPU computes step(0, .) as one big GF(2) contraction (bit planes x W0).
//
// What bounds it on an H100.  Bytes: reads k*n, writes r*n plus 4 bytes
// per row per tile, 0.0175 ms at (10, 4 MiB).  The first version ran the
// W0 contraction bit by bit (16 columns x 8 planes x 3 operations per row
// per thread plus 8 x 5 shuffles: about 450 integer operations and 35
// shuffles per byte column over 14 rows, three quarters of its
// instructions), had 14 threads of a block fold the plane sums while the
// rest waited, and held 144 registers (1 block, 8 warps per SM): 0.290 ms,
// issue-bound like K1.
//
// This design:
// - parity: K1's core (rs_bitmatrix.cuh): the 10 -> 4 shape specialised
//   with its mask words as a __grid_constant__ parameter, the merged
//   parity extraction; about 115 operations per column;
// - CRC: step(0, .) is the table-driven CRC32-C, whose reflected byte
//   table is E(b) of that algebra.  The tile's 14 rows are staged in
//   shared memory (each row as 16 runs of 256 bytes, padded to 272 so a
//   quarter-warp's 16-byte accesses fall in distinct banks); half-warp h
//   takes a row, lane q its run q, as 4 interleaved chains of 64 bytes
//   (ILP for the load-use latency of the table).  One step per byte:
//   c = T[c & 0xff] ^ (c >> 8), about 4 ALU operations and one LDS; the
//   table is copied once per lane (copy l at word 32*b + l, 32 KB) so the
//   random byte indices never conflict.  About 4.25 x 14 = 60 operations
//   and 14 LDS per column, against about 450 before;
// - the runs are joined by linearity, step(0, AB) = Z^|B|(step(0, A)) ^
//   step(0, B), Z^m = advance over m zero bytes as 4 byte-sliced 256-entry
//   tables per length (crc_fold.shift_table): the 4 chains by Horner with
//   Z^64, the 16 runs of a row by a 4-level shuffle butterfly with Z^256,
//   Z^512, Z^1024, Z^2048; then P_(t mod tpb), spread over the 16 lanes
//   (2 columns each) and XOR-reduced.  No thread does a long serial tail;
// - persistent blocks (one grid of at most blocks-per-SM x SMs walks the
//   tiles) fill the lane-replicated byte table once; 93.7 KB of shared
//   memory at 14 rows, __launch_bounds__(256, 2): 2 blocks, 16 warps per
//   SM; ptxas reports 125 registers, no spills (104 for the generic one,
//   1 block per SM for its 180 KB).  At 14 rows warp 7 has no row (224 of
//   256 lanes in the CRC phase);
// - measured on an H100: 0.059 ms at (10, 4 MiB), against about 167 ALU
//   operations per column (0.042 ms at perfect issue).  Half the byte
//   bound (0.035 ms) is out of reach while the parity half alone takes
//   K1's 0.036 ms.
// An int8 tensor-core contraction with W0 (4096 x 32) as B was weighed:
// about 30 G MMA operations per call, 0.015 ms at the dense int8 peak, but
// 128 KiB of shared memory for B; it is the lever to try if the table
// design turns out limited by the shared-memory pipe.
//
// Partials equal crc_fold.tile_partials_np word for word (one per 4096
// bytes per row, data rows first), so crc_fold.FusedCrcAccumulator folds
// them unchanged.
//
// Volume axis: a call may carry V volumes that share one matrix (the
// batched steps of parallel/sharded_codec.py).  The persistent blocks walk
// (volume, tile) pairs g in [0, V * ntiles): v = g / ntiles, tile = g %
// ntiles.  Volume v reads in + v*in_rows*n, writes out + v*out_rows*n and
// partials + v*(in_rows+out_rows)*ntiles, and the position matrix is the
// one of the tile within its volume (tile % tpb): each volume's rows start
// on an `.ecc` block boundary of their own.  The 10 -> 4 shape has a
// single-volume instantiation beside the batched one (kVolumes false: v
// is 0, no division), so the main path's one-volume launches keep the
// registers they had: the per-volume pointers and the 64-bit division
// cost the batched instantiation a few registers and a little spill at
// the 128-register cap of 2 blocks per SM.
//
// in_rows, out_rows <= 16, n a multiple of 4096, each volume's input
// starting on an `.ecc` block boundary.  Launches on the caller's stream,
// does not synchronise, allocates nothing.

#include <algorithm>
#include <cstring>
#include <map>
#include <mutex>
#include <utility>

#include "rs_bitmatrix.cuh"

namespace {

using rsbm::kThreads;
using rsbm::kTile;
using rsbm::kWords;

static_assert(kThreads == 256, "one byte-table entry per thread");

constexpr int kRuns = 16;                    // runs per row of a tile
constexpr int kRunBytes = kTile / kRuns;     // 256
constexpr int kRunStride = kRunBytes + 16;   // padded staging stride
constexpr int kChains = 4;                   // chains per run
constexpr int kChainBytes = kRunBytes / kChains;  // 64
constexpr int kTableBytes = 256 * 32 * 4;    // byte table, one copy per lane
constexpr int kMaxRows = 32;
// shift_tables: level 0 is Z^kChainBytes, level 1 + k is Z^(kRunBytes << k).
constexpr int kShiftWords = 4 * 256;

size_t smem_bytes(int rows) {
  return kTableBytes + static_cast<size_t>(rows) * kRuns * kRunStride;
}

// Entry e of the byte table into all 32 lane copies; a quarter-warp's
// 16-byte stores are rotated by lane into distinct banks.
__device__ __forceinline__ void fill_table(const uint32_t* __restrict__ bt,
                                           uint32_t* tbl) {
  const uint32_t v = bt[threadIdx.x];
  const uint4 q = make_uint4(v, v, v, v);
  uint4* row = reinterpret_cast<uint4*>(tbl + threadIdx.x * 32);
#pragma unroll
  for (int c = 0; c < 8; ++c) row[(c + threadIdx.x) % 8] = q;
}

// Z^m(v) from its byte-sliced table.
__device__ __forceinline__ uint32_t zshift(const uint32_t* __restrict__ z,
                                           uint32_t v) {
  return __ldg(z + (v & 0xffu)) ^ __ldg(z + 256 + ((v >> 8) & 0xffu)) ^
         __ldg(z + 512 + ((v >> 16) & 0xffu)) ^ __ldg(z + 768 + (v >> 24));
}

// step(0, run) of one 256-byte run in shared memory; tl = tbl + lane.
__device__ __forceinline__ uint32_t run_crc(const uint8_t* run,
                                            const uint32_t* tl,
                                            const uint32_t* __restrict__ z64) {
  uint32_t c[kChains];
#pragma unroll
  for (int h = 0; h < kChains; ++h) c[h] = 0u;
#pragma unroll
  for (int k = 0; k < kChainBytes / 16; ++k) {
    uint4 w[kChains];
#pragma unroll
    for (int h = 0; h < kChains; ++h) {
      w[h] = *reinterpret_cast<const uint4*>(run + h * kChainBytes + k * 16);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int h = 0; h < kChains; ++h) {
        c[h] ^= e == 0 ? w[h].x : e == 1 ? w[h].y : e == 2 ? w[h].z : w[h].w;
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
#pragma unroll
        for (int h = 0; h < kChains; ++h) {
          c[h] = tl[(c[h] & 0xffu) * 32] ^ (c[h] >> 8);
        }
      }
    }
  }
  uint32_t v = c[0];
#pragma unroll
  for (int h = 1; h < kChains; ++h) v = zshift(z64, v) ^ c[h];
  return v;
}

// The partial of every staged row of this tile.  Each half-warp takes a
// row, its 16 lanes the row's 16 runs.  The two halves of a warp always
// run the loop together, so the shuffles name the whole warp; a half
// without a row of its own (odd row counts) reads the last row again and
// stores nothing.
__device__ __forceinline__ void crc_rows(const uint8_t* stage, int rows,
                                         const uint32_t* tbl,
                                         const uint32_t* __restrict__ shifts,
                                         const uint32_t* __restrict__ pos,
                                         long long tile, long long ntiles,
                                         uint32_t* __restrict__ partials) {
  const int lane = threadIdx.x & 31;
  const int q = lane & 15;
  for (int r0 = (threadIdx.x / 32) * 2; r0 < rows; r0 += kThreads / 16) {
    const int r = r0 + lane / 16;
    const int rr = r < rows ? r : rows - 1;
    uint32_t v = run_crc(stage + (rr * kRuns + q) * kRunStride, tbl + lane,
                         shifts);
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // join pairs of runs of 256 << k bytes
      const uint32_t z = zshift(shifts + (1 + k) * kShiftWords, v);
      v = ((q >> k) & 1) ? v : z;
      v ^= __shfl_xor_sync(0xffffffffu, v, 1 << k);
    }
    uint32_t p = (((v >> (2 * q)) & 1u) ? __ldg(pos + 2 * q) : 0u) ^
                 (((v >> (2 * q + 1)) & 1u) ? __ldg(pos + 2 * q + 1) : 0u);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      p ^= __shfl_xor_sync(0xffffffffu, p, off);
    }
    if (q == 0 && r < rows) partials[r * ntiles + tile] = p;
  }
}

// This thread's 16 bytes of row r into the staging runs.
__device__ __forceinline__ void stage_row(uint8_t* stage, int r,
                                          const uint32_t (&w)[kWords]) {
  const int t = threadIdx.x;
  *reinterpret_cast<uint4*>(stage + (r * kRuns + t / 16) * kRunStride +
                            (t % 16) * 16) = make_uint4(w[0], w[1], w[2], w[3]);
}

struct CrcArgs {
  const uint8_t* in;
  uint8_t* out;
  long long n;
  int volumes;
  const uint32_t* byte_table;
  const uint32_t* shifts;
  const uint32_t* pos_cols;
  int tpb;
  uint32_t* partials;
};

// The (volume, tile) pair g of a launch: the tile's index within its
// volume, and the volume's input, output and partials.  Without kVolumes
// the launch has one volume and g is the tile.
struct VolumeTile {
  long long tile;
  const uint8_t* in;
  uint8_t* out;
  uint32_t* partials;
};

template <bool kVolumes>
__device__ __forceinline__ VolumeTile volume_tile(const CrcArgs& a,
                                                  long long g,
                                                  long long ntiles,
                                                  int in_rows, int out_rows) {
  const long long v = kVolumes ? g / ntiles : 0;
  return VolumeTile{g - v * ntiles, a.in + v * in_rows * a.n,
                    a.out + v * out_rows * a.n,
                    a.partials + v * (in_rows + out_rows) * ntiles};
}

template <int OUT, int IN, bool kVolumes>
__global__ void __launch_bounds__(kThreads, 2)
    rs_crc_fixed(const __grid_constant__ rsbm::MaskWords<OUT, IN> m,
                 const __grid_constant__ CrcArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* tbl = reinterpret_cast<uint32_t*>(smem);
  uint8_t* stage = smem + kTableBytes;
  fill_table(a.byte_table, tbl);
  const long long ntiles = a.n / kTile;
  const long long total = kVolumes ? ntiles * a.volumes : ntiles;
  for (long long g = blockIdx.x; g < total; g += gridDim.x) {
    const VolumeTile vt = volume_tile<kVolumes>(a, g, ntiles, IN, OUT);
    const long long word0 = vt.tile * (kTile / 4) + threadIdx.x * kWords;
    uint32_t x[IN][kWords];
    rsbm::load_rows<IN>(vt.in, a.n, word0, IN, x);
#pragma unroll
    for (int j = 0; j < IN; ++j) stage_row(stage, j, x[j]);
    uint8_t* out = vt.out;
    rsbm::mix_fixed<OUT, IN>(
        m, x, [=](int i, const uint32_t (&o)[kWords]) {
          reinterpret_cast<uint4*>(out + i * a.n)[word0 / kWords] =
              make_uint4(o[0], o[1], o[2], o[3]);
          stage_row(stage, IN + i, o);
        });
    __syncthreads();
    crc_rows(stage, IN + OUT, tbl, a.shifts,
             a.pos_cols + (vt.tile % a.tpb) * 32, vt.tile, ntiles,
             vt.partials);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    rs_crc_generic(const uint8_t* __restrict__ masks, int out_rows,
                   int in_rows, const __grid_constant__ CrcArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* tbl = reinterpret_cast<uint32_t*>(smem);
  uint32_t* smask = tbl + kTableBytes / 4;
  uint8_t* stage =
      reinterpret_cast<uint8_t*>(smask + 8 * 16 * 16);  // room for 16 x 16
  fill_table(a.byte_table, tbl);
  rsbm::load_masks(masks, out_rows, in_rows, smask);
  const long long ntiles = a.n / kTile;
  const long long total = ntiles * a.volumes;
  for (long long g = blockIdx.x; g < total; g += gridDim.x) {
    const VolumeTile vt = volume_tile<true>(a, g, ntiles, in_rows, out_rows);
    const long long word0 = vt.tile * (kTile / 4) + threadIdx.x * kWords;
    __syncthreads();  // masks loaded; the previous tile's CRC phase done
    uint32_t x[16][kWords];
    rsbm::load_rows<16>(vt.in, a.n, word0, in_rows, x);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < in_rows) stage_row(stage, j, x[j]);
    }
    for (int i = 0; i < out_rows; ++i) {
      uint32_t o[kWords];
      rsbm::mix_shared<16>(smask, out_rows, in_rows, i, x, o);
      reinterpret_cast<uint4*>(vt.out + i * a.n)[word0 / kWords] =
          make_uint4(o[0], o[1], o[2], o[3]);
      stage_row(stage, in_rows + i, o);
    }
    __syncthreads();
    crc_rows(stage, in_rows + out_rows, tbl, a.shifts,
             a.pos_cols + (vt.tile % a.tpb) * 32, vt.tile, ntiles,
             vt.partials);
  }
}

// Blocks of a persistent grid for `kernel`: as many as fit on the card
// at once (blocks per SM x SMs), at most `needed`.  Sets the kernel's
// dynamic shared-memory limit first (over 48 KB it must be asked for).
// The per-device answer is worked out once per kernel and kept.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, int device,
                            long long needed, unsigned* blocks) {
  static std::mutex lock;
  static std::map<std::pair<const void*, int>, long long> cache;
  const auto key =
      std::make_pair(reinterpret_cast<const void*>(kernel), device);
  long long fit = 0;
  {
    std::lock_guard<std::mutex> guard(lock);
    auto hit = cache.find(key);
    if (hit != cache.end()) fit = hit->second;
  }
  if (fit == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int sms = 0;
    int per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    fit = static_cast<long long>(sms) * per_sm;
    std::lock_guard<std::mutex> guard(lock);
    cache[key] = fit;
  }
  *blocks = static_cast<unsigned>(std::min(needed, fit));
  return cudaSuccess;
}

template <int OUT, int IN, bool kVolumes>
cudaError_t launch_crc_fixed(const void* host_words, const CrcArgs& a,
                             int device, long long needed, cudaStream_t st) {
  const size_t smem = smem_bytes(IN + OUT);
  unsigned blocks = 0;
  cudaError_t err = resident_blocks(rs_crc_fixed<OUT, IN, kVolumes>, smem,
                                    device, needed, &blocks);
  if (err != cudaSuccess) return err;
  rsbm::MaskWords<OUT, IN> m;
  std::memcpy(m.w, host_words, sizeof(m.w));
  rs_crc_fixed<OUT, IN, kVolumes><<<blocks, kThreads, smem, st>>>(m, a);
  return cudaGetLastError();
}

}  // namespace

// variant: index into ops/coder_cuda.py K2_VARIANTS — 0: 10 -> 4 fixed
// (host_words: the 8*4*10 mask words, read here on the host and passed by
// value), 1: generic, in_rows and out_rows <= 16 (dev_masks: the
// (8*out_rows, in_rows) uint8 masks on the device).
// in: (volumes, in_rows, n) uint8; out: (volumes, out_rows, n) uint8;
// byte_table: (256,) words; shift_tables: (5, 4, 256) words (Z^64, Z^256,
// Z^512, Z^1024, Z^2048); pos_cols: (tpb*32,) words; partials: (volumes,
// in_rows+out_rows, n/4096) words.  Returns a cudaError_t value (0 =
// launched).
extern "C" int rs_bitmatrix_crc(int variant, const void* host_words,
                                const void* dev_masks, int out_rows,
                                int in_rows, const void* in, void* out,
                                long long n, int volumes,
                                const void* byte_table,
                                const void* shift_tables,
                                const void* pos_cols, int tpb, void* partials,
                                int device, void* stream) {
  if (out_rows < 1 || out_rows > 16 || in_rows < 1 || in_rows > 16 ||
      n <= 0 || n % kTile != 0 || tpb < 1 || volumes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long needed = n / kTile * volumes;
  auto st = static_cast<cudaStream_t>(stream);
  const CrcArgs a{static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
                  n, volumes, static_cast<const uint32_t*>(byte_table),
                  static_cast<const uint32_t*>(shift_tables),
                  static_cast<const uint32_t*>(pos_cols), tpb,
                  static_cast<uint32_t*>(partials)};
  if (variant == 0 && in_rows == 10 && out_rows == 4 && host_words != nullptr) {
    return static_cast<int>(
        volumes == 1
            ? launch_crc_fixed<4, 10, false>(host_words, a, device, needed, st)
            : launch_crc_fixed<4, 10, true>(host_words, a, device, needed,
                                            st));
  }
  unsigned blocks = 0;
  if (variant == 1 && dev_masks != nullptr) {
    const size_t smem = smem_bytes(kMaxRows) + sizeof(uint32_t) * 8 * 16 * 16;
    err = resident_blocks(rs_crc_generic, smem, device, needed, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    rs_crc_generic<<<blocks, kThreads, smem, st>>>(
        static_cast<const uint8_t*>(dev_masks), out_rows, in_rows, a);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
