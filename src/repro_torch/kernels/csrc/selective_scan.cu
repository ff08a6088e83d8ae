// Selective scan (the Mamba-1 recurrence) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/selective_scan.py:selective_scan (Pallas TPU
// kernel, body _kernel).
//
// Computes, from h = 0, for every batch row b and channel d:
//   h_t = exp(dt_t * A[d, :]) * h_{t-1} + (dt_t * x_t) * B_t
//   y_t = <h_t, C_t>
// in fp32: dt, x, y (B, S, di); Bm, Cm (B, S, N); A (di, N);
// h_last (B, di, N). Any S and di; N <= 16.
//
// Bound on the H100: memory. The kernel reads dt and x and writes y once
// (4 bytes each per (b, t, d)); B, C, A and h_last are small beside them.
// At the trainer's (4, 64, 8192, N = 16) that is 27.8 MB, 8.3 us at
// 3.35 TB/s. The work per (b, t, d, n) is one exp and three FMA-sized
// operations (3 us at the fp32 rate), but each expf issues one MUFU.EX2,
// and 33.6 M of them at 16 per clock per SM take about as long as the
// bytes. The recurrence is serial in t, so the parallelism is B * di *
// (lanes per channel).
//
// Design: the Pallas kernel carries the (bd, N) state in VMEM scratch
// across sequential grid steps over time chunks; Hopper blocks run in no
// order, so here the time loop runs inside the block and the state never
// leaves registers. One block of 128 threads covers CB channels of one
// batch row; each channel has NP / 4 lanes holding 4 states each (NP = N
// padded to 4, 8 or 16; padded states have A = B = C = 0, so they stay 0
// and add nothing), and y sums over a channel's lanes with shuffles. The
// block stages TC time steps at a time in shared memory: dt and x with
// loads coalesced along di, B and C once per block for all its channels;
// y goes out through shared memory, coalesced too. Ragged di and S edges
// are masked. expf, not __expf: the build has no --use_fast_math.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int PER = 4;  // states per lane

template <int NP>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
            const float* __restrict__ Bm, const float* __restrict__ Cm,
            const float* __restrict__ A, float* __restrict__ y,
            float* __restrict__ h_last, int S, int di, int N) {
  constexpr int G = NP / PER;        // lanes per channel
  constexpr int CB = THREADS / G;    // channels per block
  constexpr int TC = 2048 / CB;      // time steps staged at a time
  __shared__ float s_dt[TC][CB];
  __shared__ float s_x[TC][CB];
  __shared__ float s_y[TC][CB];
  __shared__ float s_b[TC][NP];
  __shared__ float s_c[TC][NP];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CB;
  const int c = threadIdx.x / G;     // channel within the block
  const int sub = threadIdx.x % G;   // which 4 states of it
  const int d = d0 + c;
  const bool live = d < di;

  float a[PER], h[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int n = sub * PER + j;
    a[j] = (live && n < N) ? A[(size_t)d * N + n] : 0.f;
    h[j] = 0.f;
  }
  const size_t row = (size_t)b * S;  // flat index of (b, t = 0)
  for (int t0 = 0; t0 < S; t0 += TC) {
    const int steps = min(TC, S - t0);
    for (int i = threadIdx.x; i < TC * CB; i += THREADS) {
      const int tt = i / CB, cc = i % CB;
      const bool ok = tt < steps && d0 + cc < di;
      const size_t off = (row + t0 + tt) * di + d0 + cc;
      s_dt[tt][cc] = ok ? dt[off] : 0.f;
      s_x[tt][cc] = ok ? x[off] : 0.f;
    }
    for (int i = threadIdx.x; i < TC * NP; i += THREADS) {
      const int tt = i / NP, n = i % NP;
      const bool ok = tt < steps && n < N;
      const size_t off = (row + t0 + tt) * N + n;
      s_b[tt][n] = ok ? Bm[off] : 0.f;
      s_c[tt][n] = ok ? Cm[off] : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < steps; ++tt) {
      const float dtv = s_dt[tt][c];
      const float dx = dtv * s_x[tt][c];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int n = sub * PER + j;
        h[j] = expf(dtv * a[j]) * h[j] + dx * s_b[tt][n];
        acc += h[j] * s_c[tt][n];
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (sub == 0) s_y[tt][c] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TC * CB; i += THREADS) {
      const int tt = i / CB, cc = i % CB;
      if (tt < steps && d0 + cc < di)
        y[(row + t0 + tt) * di + d0 + cc] = s_y[tt][cc];
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int n = sub * PER + j;
      if (n < N) h_last[((size_t)b * di + d) * N + n] = h[j];
    }
  }
}

template <int NP>
void launch(const float* dt, const float* x, const float* Bm,
            const float* Cm, const float* A, float* y, float* h_last,
            int B, int S, int di, int N, cudaStream_t st) {
  constexpr int CB = THREADS / (NP / PER);
  const dim3 grid((di + CB - 1) / CB, B);
  scan_kernel<NP><<<grid, THREADS, 0, st>>>(dt, x, Bm, Cm, A, y, h_last, S,
                                            di, N);
}

}  // namespace

extern "C" int selective_scan_launch(const void* dt, const void* x,
                                     const void* Bm, const void* Cm,
                                     const void* A, void* y, void* h_last,
                                     int B, int S, int di, int N,
                                     void* stream) {
  if (B < 1 || B > 65535 || S < 1 || di < 1 || N < 1 || N > 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *fdt = (const float*)dt, *fx = (const float*)x,
              *fb = (const float*)Bm, *fc = (const float*)Cm,
              *fa = (const float*)A;
  if (N <= 4)
    launch<4>(fdt, fx, fb, fc, fa, (float*)y, (float*)h_last, B, S, di, N, st);
  else if (N <= 8)
    launch<8>(fdt, fx, fb, fc, fa, (float*)y, (float*)h_last, B, S, di, N, st);
  else
    launch<16>(fdt, fx, fb, fc, fa, (float*)y, (float*)h_last, B, S, di, N,
               st);
  return (int)cudaGetLastError();
}
