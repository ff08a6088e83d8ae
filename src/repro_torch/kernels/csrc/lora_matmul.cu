// Fused LoRA linear and its dx gemm for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/lora_matmul.py:lora_matmul (Pallas TPU
// kernel, body _lora_kernel) and :quant_matmul_t (body _t_kernel).
//
//   lora_matmul     y (M, N)  = x @ dequant(W_q) + scale * (x @ A) @ B
//   quant_matmul_t  dx (M, Kq) = g @ dequant(W_q)^T
//
// Bound on the H100: at the federated QLoRA trainer's shapes (M = 256
// tokens, K, N in {4096, 512, 11008}, NF4 block 64) each call is about
// 2*M flops per weight against half a byte per weight, so the work is
// operations-bound on the bf16 tensor-core rate and far above it on the
// fp32 CUDA cores this first design uses.
//
// Design (simple and correct first; no tensor cores, no async copies):
// each block owns a (64 x 128) output tile, 256 threads as 16 x 16, each
// thread a 4 x 8 register micro-tile at stride 16 (conflict-free shared
// reads). The block walks the reduction axis in 32-deep tiles: the
// activation tile is staged transposed, the weight tile is dequantized
// into shared memory straight from the quantized payload (dequant.cuh,
// the decode quant_matmul.cu uses), so W is never written dense. A loop
// inside the block takes the place of the TPU's sequential quant-group
// grid axis.
//  - lora_matmul also stages the matching rows of A and accumulates
//    h = x @ A (64 x r, fp32 registers) in the same loop, as the Pallas
//    kernel's (bm, r) scratch does; after the loop h and the (r x 128)
//    tile of B meet in shared memory and y = acc + scale * h @ B is
//    written in x's dtype. r is padded to 16 or 32 with zero columns.
//  - quant_matmul_t reduces over N and writes columns of Kq: its weight
//    tile is W^T, read along N (coalesced) and stored transposed in
//    shared memory with a padded stride. Columns past N (ragged N)
//    load as zeros, as the Pallas kernel's zero scales make them.
// Odd K: x and A are masked past the true K and W's pad rows are zero,
// which contracts as the zero-padding of lora_matmul.py:75-84 does.
// All accumulation is fp32.
#include "dequant.cuh"

namespace {

using dq::FMT_INT4;
using dq::FMT_INT8;
using dq::FMT_NF4;
using dq::load_f;
using dq::store_f;

constexpr int BM = 64;             // output rows per block
constexpr int BN = 128;            // output columns per block
constexpr int BK = 32;             // reduction depth per tile
constexpr int NT = 256;            // threads: 16 x 16
constexpr int TM = BM / 16;        // rows per thread
constexpr int TN = BN / 16;        // columns per thread
constexpr int LDA = BM + 1;        // transposed activation tile stride
constexpr int LDT = BN + 1;        // transposed weight tile stride

// rows m0.. of a row-major (M, ld) matrix, columns c0..c0+BK (masked to
// c < ncols) into dst[kk][mm] (stride LDA, conflict-free writes)
template <typename T>
__device__ __forceinline__ void load_rows_t(float* dst, const T* src, int M,
                                            int ncols, int ld, int m0,
                                            int c0) {
  for (int i = threadIdx.x; i < BM * BK; i += NT) {
    const int mm = i / BK, kk = i % BK;
    const int m = m0 + mm, c = c0 + kk;
    dst[kk * LDA + mm] =
        (m < M && c < ncols) ? load_f(src + (size_t)m * ld + c) : 0.f;
  }
}

// acc[i][j] += sum_kk as[kk][ty + 16 i] * bs[kk][tx + 16 j]
__device__ __forceinline__ void mma_tile(float (&acc)[TM][TN],
                                         const float* as, const float* bs,
                                         int ldb, int tx, int ty) {
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = as[kk * LDA + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = bs[kk * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// x (M, K), q (G, rows, N), s (G, 1, N), a (K, r), b (r, N) -> y (M, N);
// RP is r padded to 16 or 32.
template <typename T, int FMT, int RP>
__global__ void __launch_bounds__(NT)
lora_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
            const float* __restrict__ s, const float* __restrict__ a,
            const float* __restrict__ b, T* __restrict__ y, int M, int K,
            int Kq, int N, int r, int block, int rows, float scale) {
  constexpr int HT = BM * RP / NT;          // h entries per thread
  constexpr int BUF1 = BK * LDA > BM * (RP + 1) ? BK * LDA : BM * (RP + 1);
  __shared__ float buf1[BUF1];              // x tile, then h
  __shared__ float buf2[BK * BN];           // W tile, then the B tile
  __shared__ float as_[BK * RP];            // A tile
  __shared__ float code[16];
  dq::load_codebook(code);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float hacc[HT];
#pragma unroll
  for (int t = 0; t < HT; ++t) hacc[t] = 0.f;
  __syncthreads();                          // the codebook is in

  for (int k0 = 0; k0 < Kq; k0 += BK) {
    load_rows_t(buf1, x, M, K, K, m0, k0);
    for (int i = threadIdx.x; i < BK * RP; i += NT) {
      const int kk = i / RP, c = i % RP, k = k0 + kk;
      as_[i] = (k < K && c < r) ? a[(size_t)k * r + c] : 0.f;
    }
    if (FMT == FMT_INT8) {
      for (int i = threadIdx.x; i < BK * BN; i += NT) {
        const int kk = i / BN, nn = i % BN, k = k0 + kk, n = n0 + nn;
        buf2[i] = (k < Kq && n < N)
                      ? dq::weight_at<FMT>(q, s, k, n, N, block, rows, code)
                      : 0.f;
      }
    } else {                                // one packed byte, two rows
      for (int i = threadIdx.x; i < (BK / 2) * BN; i += NT) {
        const int pr = i / BN, nn = i % BN, k = k0 + 2 * pr, n = n0 + nn;
        float w0 = 0.f, w1 = 0.f;
        if (k < Kq && n < N)
          dq::weight_pair_at<FMT>(q, s, k, n, N, block, rows, code, &w0, &w1);
        buf2[(2 * pr) * BN + nn] = w0;
        buf2[(2 * pr + 1) * BN + nn] = w1;
      }
    }
    __syncthreads();
    mma_tile(acc, buf1, buf2, BN, tx, ty);
#pragma unroll
    for (int t = 0; t < HT; ++t) {          // h += x_tile @ A_tile
      const int idx = threadIdx.x + NT * t, mm = idx / RP, c = idx % RP;
      float hv = hacc[t];
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk)
        hv = fmaf(buf1[kk * LDA + mm], as_[kk * RP + c], hv);
      hacc[t] = hv;
    }
    __syncthreads();
  }

  // y = acc + scale * h @ B over the block's tile
  float* hs = buf1;                         // [BM][RP + 1]
  float* bs = buf2;                         // [RP][BN]
#pragma unroll
  for (int t = 0; t < HT; ++t) {
    const int idx = threadIdx.x + NT * t, mm = idx / RP, c = idx % RP;
    hs[mm * (RP + 1) + c] = hacc[t];
  }
  for (int i = threadIdx.x; i < RP * BN; i += NT) {
    const int c = i / BN, nn = i % BN, n = n0 + nn;
    bs[i] = (c < r && n < N) ? b[(size_t)c * N + n] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int mm = ty + 16 * i, m = m0 + mm;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int nn = tx + 16 * j, n = n0 + nn;
      if (n >= N) continue;
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < RP; ++c) d = fmaf(hs[mm * (RP + 1) + c], bs[c * BN + nn], d);
      store_f(y + (size_t)m * N + n, acc[i][j] + scale * d);
    }
  }
}

// g (M, N), q (G, rows, N), s (G, 1, N) -> o (M, Kq) = g @ dequant(W)^T
template <typename T, int FMT>
__global__ void __launch_bounds__(NT)
qmt_kernel(const T* __restrict__ g, const uint8_t* __restrict__ q,
           const float* __restrict__ s, T* __restrict__ o, int M, int Kq,
           int N, int block, int rows) {
  __shared__ float gs[BK * LDA];            // g tile, transposed
  __shared__ float wt[BK * LDT];            // W^T tile: [n][k]
  __shared__ float code[16];
  dq::load_codebook(code);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int kb0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int n0 = 0; n0 < N; n0 += BK) {
    load_rows_t(gs, g, M, N, N, m0, n0);
    if (FMT == FMT_INT8) {
      for (int i = threadIdx.x; i < BK * BN; i += NT) {
        const int kk = i % BK, kc = i / BK, n = n0 + kk, k = kb0 + kc;
        wt[kk * LDT + kc] =
            (k < Kq && n < N)
                ? dq::weight_at<FMT>(q, s, k, n, N, block, rows, code)
                : 0.f;
      }
    } else {
      for (int i = threadIdx.x; i < BK * (BN / 2); i += NT) {
        const int kk = i % BK, pr = i / BK, n = n0 + kk, k = kb0 + 2 * pr;
        float w0 = 0.f, w1 = 0.f;
        if (k < Kq && n < N)
          dq::weight_pair_at<FMT>(q, s, k, n, N, block, rows, code, &w0, &w1);
        wt[kk * LDT + 2 * pr] = w0;
        wt[kk * LDT + 2 * pr + 1] = w1;
      }
    }
    __syncthreads();
    mma_tile(acc, gs, wt, LDT, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int k = kb0 + tx + 16 * j;
      if (k < Kq) store_f(o + (size_t)m * Kq + k, acc[i][j]);
    }
  }
}

template <typename T, int FMT>
cudaError_t lora_fmt(const void* x, const void* q, const void* s,
                     const void* a, const void* b, void* y, int M, int K,
                     int Kq, int N, int r, int block, int rows, float scale,
                     cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (r <= 16)
    lora_kernel<T, FMT, 16><<<grid, NT, 0, st>>>(
        (const T*)x, (const uint8_t*)q, (const float*)s, (const float*)a,
        (const float*)b, (T*)y, M, K, Kq, N, r, block, rows, scale);
  else
    lora_kernel<T, FMT, 32><<<grid, NT, 0, st>>>(
        (const T*)x, (const uint8_t*)q, (const float*)s, (const float*)a,
        (const float*)b, (T*)y, M, K, Kq, N, r, block, rows, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t lora_typed(int fmt, const void* x, const void* q, const void* s,
                       const void* a, const void* b, void* y, int M, int K,
                       int Kq, int N, int r, int block, int rows, float scale,
                       cudaStream_t st) {
  switch (fmt) {
    case FMT_INT8:
      return lora_fmt<T, FMT_INT8>(x, q, s, a, b, y, M, K, Kq, N, r, block, rows, scale, st);
    case FMT_INT4:
      return lora_fmt<T, FMT_INT4>(x, q, s, a, b, y, M, K, Kq, N, r, block, rows, scale, st);
    case FMT_NF4:
      return lora_fmt<T, FMT_NF4>(x, q, s, a, b, y, M, K, Kq, N, r, block, rows, scale, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t qmt_typed(int fmt, const void* g, const void* q, const void* s,
                      void* o, int M, int Kq, int N, int block, int rows,
                      cudaStream_t st) {
  const dim3 grid((Kq + BN - 1) / BN, (M + BM - 1) / BM);
  switch (fmt) {
    case FMT_INT8:
      qmt_kernel<T, FMT_INT8><<<grid, NT, 0, st>>>(
          (const T*)g, (const uint8_t*)q, (const float*)s, (T*)o, M, Kq, N, block, rows);
      break;
    case FMT_INT4:
      qmt_kernel<T, FMT_INT4><<<grid, NT, 0, st>>>(
          (const T*)g, (const uint8_t*)q, (const float*)s, (T*)o, M, Kq, N, block, rows);
      break;
    case FMT_NF4:
      qmt_kernel<T, FMT_NF4><<<grid, NT, 0, st>>>(
          (const T*)g, (const uint8_t*)q, (const float*)s, (T*)o, M, Kq, N, block, rows);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool bad_layout(int fmt, int Kq, int block, int rows) {
  if (block < 1 || Kq % block) return true;
  if (fmt == FMT_INT8) return rows != block;
  return block % 2 || rows * 2 != block;
}

}  // namespace

// fmt: 0 int8, 1 int4 (packed), 2 NF4 (packed); is_bf16: x and y dtype
// (a and b are fp32). K is x's true width, Kq = G * block >= K.
extern "C" int lora_matmul_launch(const void* x, const void* q, const void* s,
                                  const void* a, const void* b, void* y,
                                  int M, int K, int Kq, int N, int r,
                                  int block, int rows, int fmt, float scale,
                                  int is_bf16, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K > Kq || r < 1 || r > 32 ||
      (M + BM - 1) / BM > 65535 || bad_layout(fmt, Kq, block, rows))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      is_bf16 ? lora_typed<__nv_bfloat16>(fmt, x, q, s, a, b, y, M, K, Kq, N,
                                          r, block, rows, scale, st)
              : lora_typed<float>(fmt, x, q, s, a, b, y, M, K, Kq, N, r,
                                  block, rows, scale, st);
  return (int)err;
}

// g (M, N) -> o (M, Kq); is_bf16: g and o dtype.
extern "C" int quant_matmul_t_launch(const void* g, const void* q,
                                     const void* s, void* o, int M, int Kq,
                                     int N, int block, int rows, int fmt,
                                     int is_bf16, void* stream) {
  if (M < 1 || N < 1 || Kq < 1 || (M + BM - 1) / BM > 65535 ||
      bad_layout(fmt, Kq, block, rows))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      is_bf16 ? qmt_typed<__nv_bfloat16>(fmt, g, q, s, o, M, Kq, N, block,
                                         rows, st)
              : qmt_typed<float>(fmt, g, q, s, o, M, Kq, N, block, rows, st);
  return (int)err;
}
