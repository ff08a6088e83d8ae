// Fused dequant-matmul  y = x @ dequant(W_q)  for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quant_matmul.py:quant_matmul (Pallas TPU
// kernel, body _kernel and dequant_tile).
//
// Bound on the H100: at the serve plane's shapes (one row per user,
// K = N = 768, eight users per launch) this is a GEMV over the quantized
// bytes, so it is memory-bound: 1 byte per weight at int8 and 0.5 at
// int4/NF4 against 2 flops per weight. At M = 800 it leans towards the
// fp32 CUDA-core rate.
//
// Design: W is never written dense, and the stacked user axis is a grid
// axis, so a whole serve group is one launch. Two paths:
//  - GEMV (M <= 4 rows per user, N % 4 == 0): each lane streams 4
//    adjacent columns with one 32-bit load per code row and 16 warps
//    split K with no barrier in the loop; see qmv_kernel.
//  - tiled (any other shape): each block owns a (BM x 64) output tile and
//    walks K in 32-row tiles, dequantizing the (32 x 64) weight tile into
//    shared memory (loads coalesced along N), fp32 accumulation.
// Either way the loop over quant groups inside the block takes the place
// of the TPU's sequential grid axis. Packed 4-bit row j holds rows 2j
// (hi nibble) and 2j+1 (lo nibble); the decode is dequant.cuh's, shared
// with lora_matmul.cu, and NF4 codes map through the 16-entry codebook in
// shared memory. No tensor cores and no async copies yet.
#include "dequant.cuh"

namespace {

using dq::FMT_INT4;
using dq::FMT_INT8;
using dq::FMT_NF4;
using dq::load_f;
using dq::store_f;

constexpr int BN = 64;              // output columns per block
constexpr int TY = 4;               // row groups per block
constexpr int NTHREADS = BN * TY;   // 256
constexpr int KT = 32;              // K rows per tile

// x (T, M, Kq), q (T, G, rows, N), s (T, G, 1, N) -> y (T, M, N).
// RM output rows per thread, so a block covers BM = TY * RM rows.
template <typename T, int RM, int FMT>
__global__ void __launch_bounds__(NTHREADS)
qmm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
           const float* __restrict__ s, T* __restrict__ y, int M, int Kq,
           int N, int block, int rows) {
  constexpr int BM = TY * RM;
  __shared__ float xs[BM][KT + 1];
  __shared__ float ws[KT][BN];
  __shared__ float code[16];
  dq::load_codebook(code);
  __syncthreads();
  const int G = Kq / block;
  const int t = blockIdx.z;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tx = threadIdx.x % BN;
  const int ty = threadIdx.x / BN;
  const T* xt = x + (size_t)t * M * Kq;
  const uint8_t* qt = q + (size_t)t * G * rows * N;
  const float* st = s + (size_t)t * G * N;

  float acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < Kq; k0 += KT) {
    for (int i = threadIdx.x; i < BM * KT; i += NTHREADS) {
      const int mm = i / KT, kk = i % KT;
      const int m = m0 + mm, k = k0 + kk;
      xs[mm][kk] = (m < M && k < Kq) ? load_f(xt + (size_t)m * Kq + k) : 0.f;
    }
    for (int i = threadIdx.x; i < KT * BN; i += NTHREADS) {
      const int kk = i / BN, nn = i % BN;
      const int k = k0 + kk, n = n0 + nn;
      float w = 0.f;
      if (k < Kq && n < N)
        w = dq::weight_at<FMT>(qt, st, k, n, N, block, rows, code);
      ws[kk][nn] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KT; ++kk) {
      const float wv = ws[kk][tx];
#pragma unroll
      for (int r = 0; r < RM; ++r) acc[r] = fmaf(xs[ty * RM + r][kk], wv, acc[r]);
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n < N) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int m = m0 + ty * RM + r;
      if (m < M) store_f(y + ((size_t)t * M + m) * N + n, acc[r]);
    }
  }
}

// ---- GEMV path: MR <= 4 rows per user (the serve head's shape) --------
//
// Each lane owns 4 adjacent columns, so one 32-bit load brings 4 int8
// codes, or 4 packed bytes = 2 rows x 4 columns at 4 bits, and the
// scales come as one float4. The 16 warps of a block split the code rows
// (the K axis) and run without a barrier; one shared-memory reduction
// per block sums their partials. Needs N % 4 == 0 and 4-byte aligned
// codes, 16-byte aligned scales (checked by the launcher).
constexpr int GV_WARPS = 16;
constexpr int GV_COLS = 128;        // 32 lanes x 4 columns

template <typename T, int FMT, int MR>
__global__ void __launch_bounds__(GV_WARPS * 32)
qmv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
           const float* __restrict__ s, T* __restrict__ y, int Kq, int N,
           int block, int rows) {
  __shared__ float part[GV_WARPS][MR][GV_COLS];
  // lanes index the codebook divergently: constant memory would
  // serialise that, shared memory serves 16 distinct words at once
  __shared__ float code[16];
  dq::load_codebook(code);
  __syncthreads();
  const int t = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * GV_COLS + lane * 4;
  const int G = Kq / block;
  const int R = G * rows;                      // code rows
  const int per = (R + GV_WARPS - 1) / GV_WARPS;
  const int c0 = warp * per, c1 = min(R, c0 + per);
  const T* xt = x + (size_t)t * MR * Kq;
  const uint8_t* qt = q + (size_t)t * R * N;
  const float* st = s + (size_t)t * G * N;

  float acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  if (n < N) {
#pragma unroll 8
    for (int cr = c0; cr < c1; ++cr) {
      const uint32_t word =
          *reinterpret_cast<const uint32_t*>(qt + (size_t)cr * N + n);
      const int k = FMT == FMT_INT8 ? cr : 2 * cr;   // first K row
      const float4 sc4 =
          *reinterpret_cast<const float4*>(st + (size_t)(k / block) * N + n);
      const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int b = (word >> (8 * c)) & 0xFF;
        if (FMT == FMT_INT8) {
          const float w = (float)(int8_t)b * sc[c];
#pragma unroll
          for (int m = 0; m < MR; ++m)
            acc[m][c] = fmaf(load_f(xt + (size_t)m * Kq + k), w, acc[m][c]);
        } else {
          const int hi = b >> 4, lo = b & 0xF;
          const float whi = dq::decode4<FMT>(hi, code) * sc[c];
          const float wlo = dq::decode4<FMT>(lo, code) * sc[c];
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            acc[m][c] = fmaf(load_f(xt + (size_t)m * Kq + k), whi, acc[m][c]);
            acc[m][c] = fmaf(load_f(xt + (size_t)m * Kq + k + 1), wlo, acc[m][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[warp][m][lane * 4 + c] = acc[m][c];
  __syncthreads();
  for (int i = threadIdx.x; i < MR * GV_COLS; i += GV_WARPS * 32) {
    const int m = i / GV_COLS, col = i % GV_COLS, nn = blockIdx.x * GV_COLS + col;
    if (nn >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < GV_WARPS; ++w) v += part[w][m][col];
    store_f(y + ((size_t)t * MR + m) * N + nn, v);
  }
}

template <typename T, int FMT, int MR>
void launch_gemv(const void* x, const void* q, const void* s, void* y, int T_,
                 int Kq, int N, int block, int rows, cudaStream_t stream) {
  const dim3 grid((N + GV_COLS - 1) / GV_COLS, T_);
  qmv_kernel<T, FMT, MR><<<grid, GV_WARPS * 32, 0, stream>>>(
      (const T*)x, (const uint8_t*)q, (const float*)s, (T*)y, Kq, N, block,
      rows);
}

template <typename T, int FMT>
cudaError_t launch_typed(const void* x, const void* q, const void* s, void* y,
                         int T_, int M, int Kq, int N, int block, int rows,
                         cudaStream_t stream) {
  const bool aligned = N % 4 == 0 && (uintptr_t)q % 4 == 0 &&
                       (uintptr_t)s % 16 == 0;
  if (M <= 4 && aligned && T_ <= 65535) {
    switch (M) {
      case 1: launch_gemv<T, FMT, 1>(x, q, s, y, T_, Kq, N, block, rows, stream); break;
      case 2: launch_gemv<T, FMT, 2>(x, q, s, y, T_, Kq, N, block, rows, stream); break;
      case 3: launch_gemv<T, FMT, 3>(x, q, s, y, T_, Kq, N, block, rows, stream); break;
      default: launch_gemv<T, FMT, 4>(x, q, s, y, T_, Kq, N, block, rows, stream); break;
    }
    return cudaGetLastError();
  }
  const dim3 threads(NTHREADS);
  const int gn = (N + BN - 1) / BN;
  if (M <= TY) {  // small M with a ragged or unaligned N
    const dim3 grid(gn, (M + TY - 1) / TY, T_);
    qmm_kernel<T, 1, FMT><<<grid, threads, 0, stream>>>(
        (const T*)x, (const uint8_t*)q, (const float*)s, (T*)y, M, Kq, N,
        block, rows);
  } else {
    constexpr int BM = TY * 8;
    const dim3 grid(gn, (M + BM - 1) / BM, T_);
    qmm_kernel<T, 8, FMT><<<grid, threads, 0, stream>>>(
        (const T*)x, (const uint8_t*)q, (const float*)s, (T*)y, M, Kq, N,
        block, rows);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fmt(int fmt, const void* x, const void* q, const void* s,
                       void* y, int T_, int M, int Kq, int N, int block,
                       int rows, cudaStream_t stream) {
  switch (fmt) {
    case FMT_INT8:
      return launch_typed<T, FMT_INT8>(x, q, s, y, T_, M, Kq, N, block, rows, stream);
    case FMT_INT4:
      return launch_typed<T, FMT_INT4>(x, q, s, y, T_, M, Kq, N, block, rows, stream);
    case FMT_NF4:
      return launch_typed<T, FMT_NF4>(x, q, s, y, T_, M, Kq, N, block, rows, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// fmt: 0 int8, 1 int4 (packed), 2 NF4 (packed); is_bf16: x and y dtype.
extern "C" int quant_matmul_launch(const void* x, const void* q,
                                   const void* s, void* y, int T, int M,
                                   int Kq, int N, int block, int rows,
                                   int fmt, int is_bf16, void* stream) {
  if (T < 1 || M < 1 || N < 1 || block < 1 || Kq % block || T > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      is_bf16 ? launch_fmt<__nv_bfloat16>(fmt, x, q, s, y, T, M, Kq, N, block, rows, st)
              : launch_fmt<float>(fmt, x, q, s, y, T, M, Kq, N, block, rows, st);
  return (int)err;
}
