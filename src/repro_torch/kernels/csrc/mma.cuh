// Tensor-core and async-copy building blocks shared by the port's bf16
// kernels (flash_attention.cu, lora_matmul.cu) and the fp32 attention's
// 3xTF32 route, as inline PTX so no kernel pulls in CUTLASS's headers
// (they cost minutes of nvcc per file).
//
//   mma_bf16      mma.sync.m16n8k16, bf16 operands, fp32 accumulators
//   mma_tf32      mma.sync.m16n8k8, TF32 operands, fp32 accumulators
//   split_tf32    x ~ hi + lo, both TF32 (the 3xTF32 split)
//   ldsm_x4[_t]   ldmatrix.x4 (.trans): four 8x8 b16 tiles from shared
//                 memory into one warp's fragments
//   cp_async16/4  cp.async of 16 / 4 bytes, zero-filled when !pred
//
// Fragment layouts (PTX ISA, "mma.m16n8k16"), g = lane / 4, c = lane % 4:
//   A (16 x 16, row-major)  a0: (g, 2c..2c+1)   a1: (g+8, 2c..)
//                           a2: (g, 2c+8..)     a3: (g+8, 2c+8..)
//   B (16 x 8, "col")       b0: (k 2c..2c+1, n g)  b1: (k 2c+8.., n g)
//   C (16 x 8, fp32)        c0,c1: (g, 2c..2c+1)   c2,c3: (g+8, 2c..)
// Each register packs two bf16, the lower column (or k) in the low half.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a @ b for one m16n8k16 tile
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 tiles; lane l gives the address of row l % 8 of tile l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// An A fragment of rows r0..r0+15, columns c0..c0+15 of a row-major
// bf16 tile with row stride ld (elements); also the B fragments of two
// n8 blocks when the tile is stored [n][k] (k contiguous): then r[0],
// r[1] are b0, b1 of rows r0..r0+7 and r[2], r[3] of rows r0+8..r0+15.
__device__ __forceinline__ void frag_a(uint32_t (&r)[4],
                                       const __nv_bfloat16* t, int ld,
                                       int r0, int c0, int lane) {
  ldsm_x4(r, t + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 +
                 (lane >> 4) * 8);
}
__device__ __forceinline__ void frag_b_nk(uint32_t (&r)[4],
                                          const __nv_bfloat16* t, int ld,
                                          int n0, int k0, int lane) {
  ldsm_x4(r, t + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}
// The B fragments of two n8 blocks (n0.., n0+8..) at k0..k0+15 of a tile
// stored [k][n] (n contiguous): r[0], r[1] for n0, r[2], r[3] for n0+8.
__device__ __forceinline__ void frag_b_kn(uint32_t (&r)[4],
                                          const __nv_bfloat16* t, int ld,
                                          int k0, int n0, int lane) {
  ldsm_x4_t(r, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                   (lane >> 4) * 8);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) ~ hi + lo with hi = bf16(a, b) and lo = bf16 of the remainder:
// two bf16 passes on the tensor cores carry about 16 significant bits of
// an fp32 operand where one pass carries 8.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// d += a @ b for one m16n8k8 tile, TF32 operands (fp32 bit patterns whose
// low 13 bits are zero), fp32 accumulators. Fragment layouts (PTX ISA,
// "mma.m16n8k8", .tf32), g = lane / 4, c = lane % 4:
//   A (16 x 8)  a0: (g, c)  a1: (g+8, c)  a2: (g, c+4)  a3: (g+8, c+4)
//   B (8 x 8)   b0: (k c, n g)  b1: (k c+4, n g)
//   C (16 x 8)  as for m16n8k16
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x ~ hi + lo with hi = tf32_rna(x) and lo = tf32_rna(x - hi) (x - hi is
// exact in fp32): the 3xTF32 split, about 22 significant bits of x where
// one TF32 operand carries 11. cvt.rna rounds to nearest, ties away from
// zero.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// cp.async with zero fill: when !pred no byte is read (src must still be
// a valid address) and the destination is zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tc
