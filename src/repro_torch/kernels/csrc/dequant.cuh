// Shared dequantization for the port's quantized-weight kernels.
//
// Port of src/repro/kernels/quant_matmul.py:dequant_tile, which the JAX
// package shares between quant_matmul and the fused LoRA kernels; here
// quant_matmul.cu and lora_matmul.cu include this header so the three
// kernels decode the identical QTensor layout:
//   q      (G, rows, N)  int8 codes (rows = block), or packed 4-bit
//                        bytes (rows = block / 2): byte row j holds rows
//                        2j (hi nibble) and 2j + 1 (lo nibble)
//   scales (G, 1, N)     fp32, one per (block along K, column)
// A weight is code * scale in fp32, the product the plain version
// (core/quant.dequantize) computes, so kernel and plain version see the
// same weights bit for bit. The NF4 codebook is copied into shared
// memory by every block that needs it: lanes index it divergently, and
// constant memory serialises divergent indices (measured 5x slower on
// the serve path).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace dq {

enum { FMT_INT8 = 0, FMT_INT4 = 1, FMT_NF4 = 2 };

// NF4 codebook (QLoRA, Dettmers et al. 2023), as core/quant.NF4_CODE
__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f,
    -0.39491748809814453f, -0.28444138169288635f, -0.18477343022823334f,
    -0.09105003625154495f, 0.0f, 0.07958029955625534f,
    0.16093020141124725f, 0.24611230194568634f, 0.33791524171829224f,
    0.44070982933044434f, 0.5626170039176941f, 0.7229568362236023f, 1.0f};

// Copy the codebook into a block's shared ``code[16]``; the caller
// synchronises before the first read.
__device__ __forceinline__ void load_codebook(float* code) {
  for (int i = threadIdx.x; i < 16; i += blockDim.x) code[i] = kNF4[i];
}

// The value of one 4-bit code (before its scale).
template <int FMT>
__device__ __forceinline__ float decode4(int nib, const float* code) {
  return FMT == FMT_NF4 ? code[nib] : (float)(nib - 8);
}

// Dequantized W[k][n] of one (G, rows, N) payload.
template <int FMT>
__device__ __forceinline__ float weight_at(const uint8_t* q, const float* s,
                                           int k, int n, int N, int block,
                                           int rows, const float* code) {
  const int g = k / block, r = k - g * block;
  const float sc = s[(size_t)g * N + n];
  if (FMT == FMT_INT8)
    return (float)(int8_t)q[((size_t)g * rows + r) * N + n] * sc;
  const uint8_t p = q[((size_t)g * rows + (r >> 1)) * N + n];
  return decode4<FMT>((r & 1) ? (p & 0xF) : (p >> 4), code) * sc;
}

// Both rows k (even) and k + 1 of a packed 4-bit payload from one byte;
// a block is even, so the two rows share group and scale.
template <int FMT>
__device__ __forceinline__ void weight_pair_at(const uint8_t* q,
                                               const float* s, int k, int n,
                                               int N, int block, int rows,
                                               const float* code, float* w0,
                                               float* w1) {
  const int g = k / block, r = k - g * block;
  const float sc = s[(size_t)g * N + n];
  const uint8_t p = q[((size_t)g * rows + (r >> 1)) * N + n];
  *w0 = decode4<FMT>(p >> 4, code) * sc;
  *w1 = decode4<FMT>(p & 0xF, code) * sc;
}

// The float of an unsigned byte u held in byte c (0-3, little-endian) of
// a word: u becomes the low mantissa byte of 2^23 (one byte permute),
// and the caller subtracts 2^23 plus its bias, exactly, in place of an
// integer-to-float conversion, which issues at a quarter of the FMA rate.
__device__ __forceinline__ float biased_byte(uint32_t word, int c) {
  return __int_as_float(__byte_perm(word, 0x4B000000u, 0x7540 | c));
}

// The int8 code in byte c of a 32-bit payload word, as a float: one
// column of a code row loaded 4 columns a word (exact: the byte biased
// by 128, then 2^23 + 128 taken off).
__device__ __forceinline__ float code8(uint32_t word, int c) {
  return biased_byte(word ^ 0x80808080u, c) - 8388736.0f;
}

// The weights of rows 2j (hi nibble) and 2j + 1 (lo nibble) in byte c of
// a packed 4-bit payload word, at one scale (both rows share the block):
// int4 codes as biased bytes (2^23 + 8 taken off), NF4 codes through
// the codebook in shared memory.
template <int FMT>
__device__ __forceinline__ void pair4(uint32_t word, int c, float sc,
                                      const float* code, float* whi,
                                      float* wlo) {
  const uint32_t hi = (word >> 4) & 0x0F0F0F0Fu, lo = word & 0x0F0F0F0Fu;
  if (FMT == FMT_NF4) {
    *whi = code[(hi >> (8 * c)) & 0xF] * sc;
    *wlo = code[(lo >> (8 * c)) & 0xF] * sc;
  } else {
    *whi = (biased_byte(hi, c) - 8388616.0f) * sc;
    *wlo = (biased_byte(lo, c) - 8388616.0f) * sc;
  }
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

}  // namespace dq
