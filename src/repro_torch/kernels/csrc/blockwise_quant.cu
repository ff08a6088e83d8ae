// Blockwise absmax quantization (int8 / packed int4) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/blockwise_quant.py:blockwise_quant (Pallas
// TPU kernel, body _kernel).
//
// Bound on the H100: memory. It reads the fp32 input once and writes one
// byte (int8) or half a byte (int4) per element plus one fp32 scale per
// (block x column); a handful of operations per element. At the store's
// (768, 768), block 64, that is 3 MB, about 0.9 us at 3.35 TB/s.
//
// Design: a CTA owns one (block x 4 ct) tile: quant group blockIdx.x,
// columns [4 ct blockIdx.y, 4 ct (blockIdx.y + 1)). Thread (rt, ctid)
// owns 4 adjacent columns and holds its rows of the tile in registers
// from the absmax through to the codes, so every input element is read
// from device memory once: at int8 rows rt, rt + RT, ... (up to PER8),
// at int4 the row pairs (2j, 2j + 1) for j = rt, rt + RT, ... (up to
// PER4), so that one thread packs both nibbles of a byte. Loads are 16
// bytes along N (4 columns), the column absmax is reduced across the
// row threads through a small shared array (a warp-shuffle step before
// it measured slower on the H100 at the store's shape), and 4 codes
// leave as one 32-bit word. A ragged N (N % 4 != 0, or an unaligned
// input) takes element loads and byte stores. The launcher picks the
// tile shape (ct, rt) from the block (bq_tile): at block 64, 8 x 16
// threads over a 64 x 32 tile, 288 CTAs at (768, 768), the fastest of
// the CTA shapes tried on the H100 at the store's shape (PERF.md).
//
// Numerics equal the plain version bit for bit: absmax floored at 1e-12,
// scale = absmax / 127 (or / 7) by IEEE division (__fdiv_rn) and a code
// rintf(x / scale) by IEEE division too (a reciprocal multiply misses by
// one ulp), which rounds half to even as jnp.round and torch.round do,
// clamped to [-127, 127] or [-8, 7]. Built without --use_fast_math.
// int4 packs rows (2j, 2j+1) as (u[2j] << 4) | u[2j+1], u = q + 8. The
// input is finite; NaN handling is not part of the contract.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COL_THREADS = 8;    // column threads (4 columns each), most
constexpr int ROW_THREADS = 16;   // row threads, for a block of up to 128
constexpr int PER8 = 8;           // int8 rows a thread holds, at most
constexpr int PER4 = 4;           // int4 row pairs a thread holds, at most
constexpr int MAX_THREADS = 1024;

// 4 columns of one row from column n on (left columns remain)
__device__ __forceinline__ float4 load4(const float* p, int left, int vec) {
  if (vec && left >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (left > 0) v.x = __ldg(p);
  if (left > 1) v.y = __ldg(p + 1);
  if (left > 2) v.z = __ldg(p + 2);
  if (left > 3) v.w = __ldg(p + 3);
  return v;
}

// 4 code bytes, byte e for column n + e: one word, or the bytes in range
__device__ __forceinline__ void store4(uint8_t* p, uint32_t word, int left,
                                       int vec) {
  if (vec && left >= 4) {
    *reinterpret_cast<uint32_t*>(p) = word;
    return;
  }
  for (int e = 0; e < 4 && e < left; ++e) p[e] = (uint8_t)(word >> (8 * e));
}

__device__ __forceinline__ uint32_t code8(float x, float scale) {
  const float v = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)(int)v;
}

__device__ __forceinline__ uint32_t code4(float x, float scale) {
  const float v = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -8.f), 7.f);
  return (uint32_t)((int)v + 8);
}

// x (G * block, N) fp32 -> q (G, block | block/2, N), s (G, 1, N)
template <int BITS>
__global__ void __launch_bounds__(MAX_THREADS)
bq_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
          float* __restrict__ s, int N, int block, int ct, int rt, int vec,
          int vec_st) {
  constexpr int HOLD = BITS == 8 ? PER8 : PER4;    // rows or row pairs
  __shared__ float red[MAX_THREADS * 4];           // [rt][ct][4]
  __shared__ float scale_sh[COL_THREADS * 4];
  const int g = blockIdx.x;
  const int ctid = threadIdx.x % ct, rtid = threadIdx.x / ct;
  const int n = (blockIdx.y * ct + ctid) * 4;
  const int left = N - n;
  const int units = BITS == 8 ? block : block / 2;
  const float* xg = x + (size_t)g * block * N + n;

  float4 v[BITS == 8 ? PER8 : 2 * PER4];
  float am[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int p = 0; p < HOLD; ++p) {
    const int j = rtid + p * rt;
    if (j < units && left > 0) {
      if (BITS == 8) {
        v[p] = load4(xg + (size_t)j * N, left, vec);
      } else {
        v[2 * p] = load4(xg + (size_t)(2 * j) * N, left, vec);
        v[2 * p + 1] = load4(xg + (size_t)(2 * j + 1) * N, left, vec);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < HOLD; ++p) {
    if (rtid + p * rt < units && left > 0) {
#pragma unroll
      for (int h = 0; h < (BITS == 8 ? 1 : 2); ++h) {
        const float4 w = v[BITS == 8 ? p : 2 * p + h];
        am[0] = fmaxf(am[0], fabsf(w.x));
        am[1] = fmaxf(am[1], fabsf(w.y));
        am[2] = fmaxf(am[2], fabsf(w.z));
        am[3] = fmaxf(am[3], fabsf(w.w));
      }
    }
  }
  *reinterpret_cast<float4*>(red + threadIdx.x * 4) =
      make_float4(am[0], am[1], am[2], am[3]);
  __syncthreads();
  for (int c = threadIdx.x; c < ct * 4; c += ct * rt) {   // a column each
    float a = 0.f;
#pragma unroll 8
    for (int r = 0; r < rt; ++r) a = fmaxf(a, red[r * ct * 4 + c]);
    const float sc = __fdiv_rn(fmaxf(a, 1e-12f), BITS == 8 ? 127.0f : 7.0f);
    scale_sh[c] = sc;
    const int col = blockIdx.y * ct * 4 + c;
    if (col < N) s[(size_t)g * N + col] = sc;
  }
  __syncthreads();
  if (left <= 0) return;
  const float4 sc = *reinterpret_cast<const float4*>(scale_sh + ctid * 4);
  const int rows = BITS == 8 ? block : block / 2;
  uint8_t* qg = q + (size_t)g * rows * N + n;
#pragma unroll
  for (int p = 0; p < HOLD; ++p) {
    const int j = rtid + p * rt;
    if (j >= units) break;
    uint32_t word;
    if (BITS == 8) {
      const float4 w = v[p];
      word = code8(w.x, sc.x) | code8(w.y, sc.y) << 8 |
             code8(w.z, sc.z) << 16 | code8(w.w, sc.w) << 24;
    } else {
      const float4 hi = v[2 * p], lo = v[2 * p + 1];
      word = (code4(hi.x, sc.x) << 4 | code4(lo.x, sc.x)) |
             (code4(hi.y, sc.y) << 4 | code4(lo.y, sc.y)) << 8 |
             (code4(hi.z, sc.z) << 4 | code4(lo.z, sc.z)) << 16 |
             (code4(hi.w, sc.w) << 4 | code4(lo.w, sc.w)) << 24;
    }
    store4(qg + (size_t)j * N, word, left, vec_st);
  }
}

// The CTA's threads for one quant group of `block` rows: row thread r
// holds the rows (int8) or row pairs (int4) r, r + rt, ... of the block,
// at most PER8 / PER4; blocks past ROW_THREADS x that add row threads
// and, past MAX_THREADS threads, take fewer columns. False if even one
// column thread cannot hold the block.
bool bq_tile(int bits, int block, int* ct, int* rt) {
  const int units = bits == 8 ? block : block / 2;
  const int hold = bits == 8 ? PER8 : PER4;
  *rt = units <= ROW_THREADS          ? units
        : units <= ROW_THREADS * hold ? ROW_THREADS
                                      : (units + hold - 1) / hold;
  *ct = COL_THREADS;
  while (*ct * *rt > MAX_THREADS && *ct > 1) *ct /= 2;
  return *ct * *rt <= MAX_THREADS;
}

}  // namespace

// x (G * block, N) fp32 -> q, s; refuses a block no tile can hold
// (one past 8192 rows).
extern "C" int blockwise_quant_launch(const void* x, void* q, void* s, int G,
                                      int N, int block, int bits,
                                      void* stream) {
  int ct, rt;
  if (G < 1 || N < 1 || block < 1 || (bits != 8 && bits != 4) ||
      (bits == 4 && block % 2) || !bq_tile(bits, block, &ct, &rt))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(G, (N + 4 * ct - 1) / (4 * ct));
  const int vec = N % 4 == 0 && (uintptr_t)x % 16 == 0;
  const int vec_st = N % 4 == 0 && (uintptr_t)q % 4 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bits == 8)
    bq_kernel<8><<<grid, ct * rt, 0, st>>>((const float*)x, (uint8_t*)q,
                                           (float*)s, N, block, ct, rt, vec,
                                           vec_st);
  else
    bq_kernel<4><<<grid, ct * rt, 0, st>>>((const float*)x, (uint8_t*)q,
                                           (float*)s, N, block, ct, rt, vec,
                                           vec_st);
  return (int)cudaGetLastError();
}
