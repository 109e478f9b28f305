// Shared device code of the GF(2) bit-matrix kernels
// (rs_bitmatrix.cu, rs_bitmatrix_crc.cu).
//
// Data layout.  A call mixes `in_rows` byte rows of length n (row-major,
// row stride n) into `out_rows` byte rows.  The GF(2^8) matrix arrives
// lowered to GF(2) and packed on the host (ops/coder_cuda.py
// pack_bitmatrix): masks[q * in_rows + j] is an 8-bit mask for output
// bit row q = s_out * out_rows + i (plane-major, bit s_out of output row
// i) and input row j, whose bit s_in is set when input bit s_in of row j
// feeds that output bit.  So
//
//   bit s_out of out[i][c] = XOR_j parity(masks[q][j] & in[j][c]).
//
// Each thread owns kWords consecutive 32-bit words (16 byte columns) of
// every row and works on four bytes per 32-bit operation: the mask byte
// is replicated into all four byte lanes, AND-XOR accumulates across
// the input rows, and one shift-XOR fold leaves each byte's parity in
// its bit 0.  Sums are taken mod 2 exactly, so there is no accumulator
// type to choose.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace rsbm {

constexpr int kThreads = 256;                 // threads per block
constexpr int kWords = 4;                     // 32-bit words per thread
constexpr int kTile = kThreads * kWords * 4;  // 4096 byte columns per block

// Bit 0 of each byte of the result is the parity of that byte of y.
__device__ __forceinline__ uint32_t byte_parity(uint32_t y) {
  y ^= y >> 4;
  y ^= y >> 2;
  y ^= y >> 1;
  return y & 0x01010101u;
}

// Masks into shared memory, each byte replicated into four byte lanes.
__device__ __forceinline__ void load_masks(const uint8_t* __restrict__ masks,
                                           int count, uint32_t* smask) {
  for (int q = threadIdx.x; q < count; q += blockDim.x) {
    smask[q] = static_cast<uint32_t>(masks[q]) * 0x01010101u;
  }
}

// This thread's kWords words of every input row (one 16-byte load each;
// neighbouring threads read neighbouring 16 bytes).
template <int KMAX>
__device__ __forceinline__ void load_rows(const uint8_t* __restrict__ in,
                                          long long n, long long word0,
                                          int in_rows,
                                          uint32_t (&x)[KMAX][kWords]) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (j < in_rows) {
      v = reinterpret_cast<const uint4*>(in + j * n)[word0 / kWords];
    }
    x[j][0] = v.x;
    x[j][1] = v.y;
    x[j][2] = v.z;
    x[j][3] = v.w;
  }
}

// Output byte row i for this thread's kWords words.
template <int KMAX>
__device__ __forceinline__ void mix_row(const uint32_t* smask, int out_rows,
                                        int in_rows, int i,
                                        const uint32_t (&x)[KMAX][kWords],
                                        uint32_t (&o)[kWords]) {
#pragma unroll
  for (int v = 0; v < kWords; ++v) o[v] = 0u;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const uint32_t* m = smask + (s * out_rows + i) * in_rows;
    uint32_t t[kWords] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < in_rows) {
        const uint32_t mj = m[j];
#pragma unroll
        for (int v = 0; v < kWords; ++v) t[v] ^= x[j][v] & mj;
      }
    }
#pragma unroll
    for (int v = 0; v < kWords; ++v) o[v] |= byte_parity(t[v]) << s;
  }
}

}  // namespace rsbm
