// Blockwise absmax quantization (int8 / packed int4) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/blockwise_quant.py:blockwise_quant (Pallas
// TPU kernel, body _kernel).
//
// Bound on the H100: memory. It reads the fp32 input once and writes one
// byte (int8) or half a byte (int4) per element plus one fp32 scale per
// (block x column); a handful of operations per element.
//
// Design: grid (G, ceil(N / 128)); one thread per column of a
// (block x 128) tile, so every row read and every payload write is
// coalesced along N. A thread makes two passes down its column: the
// absmax (floored at 1e-12), then the codes. The scale is
// absmax / 127 (or / 7) by IEEE division (__fdiv_rn) and a code is
// rintf(x / scale), which rounds half to even as jnp.round and
// torch.round do, clamped to [-127, 127] or [-8, 7]. Built without
// --use_fast_math, the payload and the scales equal the plain version
// bit for bit. int4 packs rows (2j, 2j+1) as (u[2j] << 4) | u[2j+1],
// u = q + 8. The input is finite; NaN handling is not part of the
// contract.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;

__device__ __forceinline__ int code4(float x, float scale) {
  const float v = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -8.f), 7.f);
  return (int)v + 8;
}

// x (G * block, N) fp32 -> q (G, block | block/2, N), s (G, 1, N)
template <int BITS>
__global__ void __launch_bounds__(BN)
bq_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
          float* __restrict__ s, int N, int block) {
  const int g = blockIdx.x;
  const int n = blockIdx.y * BN + threadIdx.x;
  if (n >= N) return;
  const float* xg = x + (size_t)g * block * N + n;
  float amax = 0.f;
  for (int r = 0; r < block; ++r) amax = fmaxf(amax, fabsf(xg[(size_t)r * N]));
  amax = fmaxf(amax, 1e-12f);
  const float scale = __fdiv_rn(amax, BITS == 8 ? 127.0f : 7.0f);
  s[(size_t)g * N + n] = scale;
  if (BITS == 8) {
    int8_t* qg = reinterpret_cast<int8_t*>(q) + (size_t)g * block * N + n;
    for (int r = 0; r < block; ++r) {
      const float v = rintf(__fdiv_rn(xg[(size_t)r * N], scale));
      qg[(size_t)r * N] = (int8_t)(int)fminf(fmaxf(v, -127.f), 127.f);
    }
  } else {
    uint8_t* qg = q + (size_t)g * (block / 2) * N + n;
    for (int j = 0; j < block / 2; ++j) {
      const int hi = code4(xg[(size_t)(2 * j) * N], scale);
      const int lo = code4(xg[(size_t)(2 * j + 1) * N], scale);
      qg[(size_t)j * N] = (uint8_t)((hi << 4) | lo);
    }
  }
}

}  // namespace

extern "C" int blockwise_quant_launch(const void* x, void* q, void* s, int G,
                                      int N, int block, int bits,
                                      void* stream) {
  if (G < 1 || N < 1 || block < 1 || (bits != 8 && bits != 4) ||
      (bits == 4 && block % 2))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(G, (N + BN - 1) / BN);
  const cudaStream_t st = (cudaStream_t)stream;
  if (bits == 8)
    bq_kernel<8><<<grid, BN, 0, st>>>((const float*)x, (uint8_t*)q,
                                      (float*)s, N, block);
  else
    bq_kernel<4><<<grid, BN, 0, st>>>((const float*)x, (uint8_t*)q,
                                      (float*)s, N, block);
  return (int)cudaGetLastError();
}
