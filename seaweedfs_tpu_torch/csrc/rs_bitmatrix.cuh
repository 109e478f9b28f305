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
// Each thread owns kWords 32-bit words (16 byte columns) of every row and
// works on four bytes per 32-bit operation.  Output byte i of a column
// needs, for each output bit s, the parity of the bytes t[s] = XOR_j
// in[j] & masks[s*out_rows + i][j]; a SWAR butterfly folds the 8 planes
// t[s] into one word (by 4, by 2, by 1, putting two planes into one word
// at each level).  The first level is folded into the masks: with
// M = 0x0F0F0F0F, z the input word and y = its nibbles swapped within
// each byte,
//
//   c[s] = select(M, t[s] ^ (t[s] >> 4), t[s+4] ^ (t[s+4] << 4))
//        = XOR_j (z_j & A1[s][j]) ^ (y_j & A2[s][j]),        s < 4,
//
// A1 = byte (m[s] & 0x0F) | (m[s+4] & 0xF0), A2 = byte (m[s] >> 4) |
// (m[s+4] << 4), each replicated into four byte lanes ("mask words",
// ops/coder_cuda.py mask_words).  So an output word costs 8 AND-XORs per
// input row as before, the swap 3 operations per input word shared by
// all output rows, and merge_pairs 15 operations (levels 2 and 1) where
// 8 separate byte-parity folds cost 72.  Sums are taken mod 2 exactly,
// so there is no accumulator type to choose.
//
// Mask word layout, for (out_rows r, in_rows k): word (s*r + i)*k + j is
// A1[s] of output row i and input row j for s < 4, A2[s - 4] for s >= 4.
// Two ways in:
// - MaskWords<OUT, IN>, the words of one fixed shape passed by value as a
//   __grid_constant__ kernel parameter (1280 bytes at 10 -> 4).  The
//   loops unroll fully and every word is a launch-uniform operand of its
//   LOP3: no per-lane load in the inner loop.
// - load_masks, for the generic instantiations: raw mask bytes from device
//   memory, turned into the same words in shared memory once per block.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace rsbm {

constexpr int kThreads = 256;                 // threads per block
constexpr int kWords = 4;                     // 32-bit words per thread
constexpr int kTile = kThreads * kWords * 4;  // 4096 byte columns per block

template <int OUT, int IN>
struct MaskWords {
  uint32_t w[8 * OUT * IN];  // the mask words, layout as above
};

__device__ __forceinline__ uint32_t select_bits(uint32_t m, uint32_t a,
                                                uint32_t b) {
  return (a & m) | (b & ~m);
}

// The two nibbles of every byte swapped.
__device__ __forceinline__ uint32_t nibble_swap(uint32_t x) {
  return select_bits(0x0F0F0F0Fu, x >> 4, x << 4);
}

// Levels 2 and 1 of the butterfly: c[s] holds planes s (low nibbles) and
// s + 4 (high nibbles), each folded to 4 bits whose parity is the plane's.
// Bit 4h + 2g + f of a byte of the result is the parity of plane
// 4h + 2g + f: the output word as it stands.
__device__ __forceinline__ uint32_t merge_pairs(const uint32_t (&c)[4]) {
  uint32_t d[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    d[s] = select_bits(0x33333333u, c[s] ^ (c[s] >> 2),
                       c[s + 2] ^ (c[s + 2] << 2));
  }
  return select_bits(0x55555555u, d[0] ^ (d[0] >> 1), d[1] ^ (d[1] << 1));
}

// Mask words into shared memory from the raw (8*out_rows, in_rows) mask
// bytes.
__device__ __forceinline__ void load_masks(const uint8_t* __restrict__ masks,
                                           int out_rows, int in_rows,
                                           uint32_t* smask) {
  const int half = 4 * out_rows * in_rows;  // words of the s < 4 half
  for (int q = threadIdx.x; q < 2 * half; q += blockDim.x) {
    const int p = q % half;                  // (s*out_rows + i)*in_rows + j
    const uint32_t lo = masks[p];            // m[s]
    const uint32_t hi = masks[p + half];     // m[s + 4]
    const uint32_t byte = q < half ? (lo & 0x0Fu) | (hi & 0xF0u)
                                   : (lo >> 4) | ((hi << 4) & 0xF0u);
    smask[q] = byte * 0x01010101u;
  }
}

// This thread's kWords words of every input row (one 16-byte load each;
// neighbouring threads read neighbouring 16 bytes).  With in_rows == KMAX
// known at compile time the guard folds away.
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

// c[s] for s < 4 from the words z[j] and swapped words y[j] of the input
// rows; a(s) points at the mask words of plane s of the output row.
template <int KMAX, class Masks>
__device__ __forceinline__ uint32_t mix_word(int in_rows, Masks a,
                                             const uint32_t (&z)[KMAX],
                                             const uint32_t (&y)[KMAX]) {
  uint32_t c[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t* a1 = a(s);
    const uint32_t* a2 = a(s + 4);
    uint32_t acc = 0u;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < in_rows) acc ^= (z[j] & a1[j]) ^ (y[j] & a2[j]);
    }
    c[s] = acc;
  }
  return merge_pairs(c);
}

// One word of every output row of a fixed shape from the same word z[j]
// of every input row.  Every index is a compile-time constant, so each
// mask word is a launch-uniform operand read from the parameter bank.
template <int OUT, int IN, int I = 0>
__device__ __forceinline__ void mix_fixed_rows(const MaskWords<OUT, IN>& m,
                                               const uint32_t (&z)[IN],
                                               const uint32_t (&y)[IN],
                                               uint32_t (&o)[OUT]) {
  if constexpr (I < OUT) {
    o[I] = mix_word<IN>(
        IN, [&](int s) { return m.w + (s * OUT + I) * IN; }, z, y);
    mix_fixed_rows<OUT, IN, I + 1>(m, z, y, o);
  }
}

template <int OUT, int IN>
__device__ __forceinline__ void mix_fixed_word(const MaskWords<OUT, IN>& m,
                                               const uint32_t (&z)[IN],
                                               uint32_t (&o)[OUT]) {
  uint32_t y[IN];
#pragma unroll
  for (int j = 0; j < IN; ++j) y[j] = nibble_swap(z[j]);
  mix_fixed_rows<OUT, IN>(m, z, y, o);
}

// All OUT output rows of a fixed shape for this thread's kWords words x;
// store(i, o) takes each row.
template <int OUT, int IN, class Store>
__device__ __forceinline__ void mix_fixed(const MaskWords<OUT, IN>& m,
                                          const uint32_t (&x)[IN][kWords],
                                          Store store) {
  uint32_t o[OUT][kWords];
#pragma unroll
  for (int v = 0; v < kWords; ++v) {
    uint32_t z[IN];
    uint32_t ov[OUT];
#pragma unroll
    for (int j = 0; j < IN; ++j) z[j] = x[j][v];
    mix_fixed_word<OUT, IN>(m, z, ov);
#pragma unroll
    for (int i = 0; i < OUT; ++i) o[i][v] = ov[i];
  }
#pragma unroll
  for (int i = 0; i < OUT; ++i) store(i, o[i]);
}

// Output row i of a runtime shape (mask words in shared memory).
template <int KMAX>
__device__ __forceinline__ void mix_shared(const uint32_t* smask,
                                           int out_rows, int in_rows, int i,
                                           const uint32_t (&x)[KMAX][kWords],
                                           uint32_t (&o)[kWords]) {
#pragma unroll
  for (int v = 0; v < kWords; ++v) {
    uint32_t z[KMAX];
    uint32_t y[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      z[j] = x[j][v];
      y[j] = nibble_swap(z[j]);
    }
    o[v] = mix_word<KMAX>(
        in_rows,
        [&](int s) { return smask + (s * out_rows + i) * in_rows; }, z, y);
  }
}

// Records the caller's CUDA event `ev` (a cudaEvent_t, or null for none)
// on `st`.  The launchers record a timing pair right around the kernel
// launch, so that the pair brackets the kernel and not the host's path
// to the launch (the roofline plane's KernelTimer reads it).
inline cudaError_t record_event(void* ev, cudaStream_t st) {
  return ev == nullptr ? cudaSuccess
                       : cudaEventRecord(static_cast<cudaEvent_t>(ev), st);
}

}  // namespace rsbm
