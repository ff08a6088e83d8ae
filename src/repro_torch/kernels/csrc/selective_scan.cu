// Selective scan (the Mamba-1 recurrence) for Hopper (sm_90a): the
// forward and its gradient.
//
// Replaces: src/repro/kernels/selective_scan.py:selective_scan (Pallas TPU
// kernel, body _kernel), and the gradient of its plain version
// (jax.vjp of repro.kernels.ref.selective_scan): the JAX package has no
// Pallas backward.
//
// Forward, from h = 0, for every batch row b and channel d:
//   h_t = exp(dt_t * A[d, :]) * h_{t-1} + (dt_t * x_t) * B_t
//   y_t = <h_t, C_t>
// Gradient, for cotangents gy (B, S, di) and gh_last (B, di, N):
//   g_t = gy_t * C_t + a_{t+1} * g_{t+1}   (+ gh_last at t = S - 1)
//   q_t = g_t * a_t * h_{t-1}
//   ddt = sum_n q A + x sum_n g B,   dx = dt sum_n g B,
//   dB = sum_d g dt x,   dC = sum_d gy h,   dA = sum_{b,t} q dt.
// All fp32: dt, x, y, gy (B, S, di); Bm, Cm (B, S, N); A (di, N);
// h_last (B, di, N). Any S and di; N <= 16.
//
// Bound on the H100. Forward: memory, 27.8 MB at the trainer's
// (4, 64, 8192, 16), 8.3 us at 3.35 TB/s. Backward: memory, 42 MB (dt, x,
// gy read, ddt, dx written), 12.7 us. The pipes come close behind: each
// exponential is one MUFU.EX2 at 16 lanes a clock per SM (33.6 M of them,
// 8.5 us at 1.98 GHz; the backward evaluates each three times), B and C
// reach every channel's registers through shared memory (LDS.128 at half
// an instruction a clock per SM), and the backward's sums over channels
// take a shuffle per 16 values.
//
// Design, shared by both kernels. The Pallas kernel carries the (bd, N)
// state in VMEM scratch across sequential grid steps over time chunks;
// Hopper blocks run in no order, so the time loop runs inside the block.
//  - Lane layout: NP = N padded to 4, 8 or 16 states a channel (padded
//    states have A = B = C = 0 and stay 0). A block is 128 threads of one
//    batch row. The forward gives a channel FWD_LANES = 2 adjacent lanes,
//    each P = NP / 2 of its states in registers, so a block holds 64
//    channels (15.5 warps a SM at the trainer's shape); the backward
//    gives a channel one thread with all NP states, 128 channels a block,
//    so its sums over n stay in registers. Of the lane counts timed on
//    the H100 (1, 2, 4 forward; 1, 2 backward) these were the fastest.
//  - Staging: time chunks of dt, x (and gy) as [T][channels] tiles and B,
//    C as [T][NP] go to shared memory by cp.async (16 bytes a thread
//    where di % 4 == 0 and the pointers are aligned), in a ring of NSF /
//    NSB stages, so the next chunk's loads overlap this chunk's
//    recurrence. Steps past S stage as zeros: dt = 0 makes a = 1 and
//    dt x B = 0, so h passes through them unchanged and g carries gh_last
//    back through them to S - 1; their outputs are not written. Channels
//    past di stage zeros and A = 0 and are not written.
//  - exp(dt A) = ex2((dt log2 e) A): one MUFU.EX2 (ex2.approx.ftz) after
//    one multiply of dt per step. The recurrence over a staged chunk
//    (run_chunk) forms step t + 1's exponentials and dt x B terms before
//    step t's FMAs: a warp runs its instructions in order and would
//    otherwise wait on their loads and MUFU results each step. The
//    forward's per-lane partials of y go to shared memory and are added
//    over a channel's lanes once per chunk, then stored coalesced along
//    di; the backward's sum_n q A and sum_n g B pass through shared
//    memory the same way.
//  - Backward, h_{t-1} in reverse order: recomputed, never inverted
//    (a may be tiny). A first pass runs the forward and writes h at the
//    end of every 8-step chunk to a scratch (B, K-1, N, di) array; then,
//    chunk by chunk from the end, the block recomputes the chunk's
//    states from its checkpoint (read a chunk ahead) into shared memory
//    (each thread its own [8][NP] column) and runs the reverse recurrence
//    over them, g and the a*g carry in registers. Nothing is saved
//    between forward and backward beyond the inputs.
//  - Backward, the sums over d (dB, dC) cross threads: each step a warp
//    reduce-scatters its threads' 2NP values (g dt x and gy h) with
//    log2(2NP) halving shuffle levels, so every lane ends with one
//    (which, n) sum over the warp's channels; per chunk the block adds
//    its 4 warps in order and writes a (channel block, b, t, 2NP)
//    partial. dA sums over t in registers and writes a (b, N, di)
//    partial. A second kernel (scan_bwd_sum) adds the partials in a
//    fixed order: no float atomics, two calls give the same bits. dA is
//    skipped (template NEED_A = false) when A needs no gradient, as in
//    the trainer.
// Shared memory at N = 16: forward 29 KB a block (two 10.5 KB stages,
// the y partials 8 KB); backward 103 KB (two 13.3 KB stages, the chunk's
// states 64 KB, ddt/dx partials 8 KB, warp sums 4 KB), two blocks a SM,
// so the trainer's 256-block backward grid is one wave.
#include "mma.cuh"

namespace {

constexpr int CB = 128;        // threads per block
constexpr int NWARP = CB / 32;
constexpr int FWD_LANES = 2;   // forward: lanes per channel
constexpr int TF = 16;         // forward: time steps per staged chunk
constexpr int NSF = 2;         // forward: chunks in flight (ring stages)
constexpr int L = 8;           // backward: time steps per chunk
constexpr int NSB = 2;         // backward: chunks in flight
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// One staged time chunk: dt, x (and gy) for the block's CH channels, B
// and C.
template <int NP, int T, bool GY, int CH>
struct alignas(16) Tile {
  float dt[T][CH];
  float x[T][CH];
  float gy[GY ? T : 1][CH];
  float b[T][NP];
  float c[T][NP];
};

// Start the cp.async copies of chunk [t0, t0 + T) into s (zeros past S,
// past di and past N): dt, x and B, and with ``full`` also C and (in a
// tile that has it) gy. Every thread of the block takes part.
template <int NP, int T, bool GY, int CH>
__device__ __forceinline__ void stage(Tile<NP, T, GY, CH>& s,
                                      const float* __restrict__ dt,
                                      const float* __restrict__ x,
                                      const float* __restrict__ gy,
                                      const float* __restrict__ Bm,
                                      const float* __restrict__ Cm,
                                      size_t row, int t0, int S, int d0,
                                      int di, int N, bool vec, bool full) {
  const int tid = threadIdx.x;
  if (vec) {   // 16-byte chunks of 4 channels
    for (int i = tid; i < T * (CH / 4); i += CB) {
      const int tt = i / (CH / 4), cc = (i % (CH / 4)) * 4;
      const bool ok = t0 + tt < S && d0 + cc < di;
      const size_t off = ok ? (row + t0 + tt) * di + d0 + cc : 0;
      tc::cp_async16(&s.dt[tt][cc], dt + off, ok);
      tc::cp_async16(&s.x[tt][cc], x + off, ok);
      if constexpr (GY) {
        if (full) tc::cp_async16(&s.gy[tt][cc], gy + off, ok);
      }
    }
  } else {
    for (int i = tid; i < T * CH; i += CB) {
      const int tt = i / CH, cc = i % CH;
      const bool ok = t0 + tt < S && d0 + cc < di;
      const size_t off = ok ? (row + t0 + tt) * di + d0 + cc : 0;
      tc::cp_async4(&s.dt[tt][cc], dt + off, ok);
      tc::cp_async4(&s.x[tt][cc], x + off, ok);
      if constexpr (GY) {
        if (full) tc::cp_async4(&s.gy[tt][cc], gy + off, ok);
      }
    }
  }
  for (int i = tid; i < T * NP; i += CB) {
    const int tt = i / NP, n = i % NP;
    const bool ok = t0 + tt < S && n < N;
    const size_t off = ok ? (row + t0 + tt) * N + n : 0;
    tc::cp_async4(&s.b[tt][n], Bm + off, ok);
    if (full) tc::cp_async4(&s.c[tt][n], Cm + off, ok);
  }
}

// P consecutive floats of shared memory into registers
template <int P>
__device__ __forceinline__ void load_row(float (&v)[P], const float* p) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int j = 0; j < P; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + j);
      v[j] = f.x; v[j + 1] = f.y; v[j + 2] = f.z; v[j + 3] = f.w;
    }
  } else if constexpr (P == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = p[j];
  }
}

// The recurrence over T staged steps from the state h, step tt + 1's
// exponentials and input terms formed before step tt's FMAs (a warp
// runs its instructions in order and would otherwise wait on their loads
// and MUFU results each step);
// each step's states go to out(tt, h).
template <int T, int P, class Tl, class Out>
__device__ __forceinline__ void run_chunk(const Tl& s, int c, int n0,
                                          const float (&a)[P], float (&h)[P],
                                          Out out) {
  float e[P], ub[P];
  auto prep = [&](int tt, float (&e_)[P], float (&ub_)[P]) {
    const float dtv = s.dt[tt][c];
    const float dl = dtv * LOG2E, u = dtv * s.x[tt][c];
    float bb[P];
    load_row<P>(bb, &s.b[tt][n0]);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      e_[j] = ex2(dl * a[j]);
      ub_[j] = u * bb[j];
    }
  };
  prep(0, e, ub);
#pragma unroll
  for (int tt = 0; tt < T; ++tt) {
    float en[P], ubn[P];
    if (tt + 1 < T) prep(tt + 1, en, ubn);
#pragma unroll
    for (int j = 0; j < P; ++j) h[j] = fmaf(e[j], h[j], ub[j]);
    out(tt, h);
    if (tt + 1 < T) {
#pragma unroll
      for (int j = 0; j < P; ++j) { e[j] = en[j]; ub[j] = ubn[j]; }
    }
  }
}

// ---------------------------------------------------------------- forward

template <int NP>
struct FwdSmem {
  Tile<NP, TF, false, CB / FWD_LANES> st[NSF];  // a ring of staged chunks
  float yp[TF][CB];                             // each lane's partial of y
};

template <int NP>
__global__ void __launch_bounds__(CB)
scan_fwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, float* __restrict__ y,
                float* __restrict__ h_last, int S, int di, int N, int vec) {
  constexpr int G = FWD_LANES, P = NP / G, CH = CB / G;
  using Tl = Tile<NP, TF, false, CH>;
  extern __shared__ float4 smem_f4[];
  FwdSmem<NP>& sm = *reinterpret_cast<FwdSmem<NP>*>(smem_f4);
  Tl* st = sm.st;

  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int c = threadIdx.x / G, sub = threadIdx.x % G, n0 = sub * P;
  const int d = d0 + c;
  const bool live = d < di;
  const size_t row = (size_t)b * S;
  float a[P], h[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    a[j] = (live && n0 + j < N) ? A[(size_t)d * N + n0 + j] : 0.f;
    h[j] = 0.f;
  }
  const int nk = (S + TF - 1) / TF;
  // chunk k goes to st[k % NSF] in commit group k (empty past nk), so
  // waiting for all but NSF - 1 groups waits for chunk k alone
  auto fetch = [&](int k) {
    if (k < nk)
      stage(st[k % NSF], dt, x, nullptr, Bm, Cm, row, k * TF, S, d0, di, N,
            vec, true);
    tc::cp_commit();
  };
  for (int k = 0; k < NSF - 1; ++k) fetch(k);
  for (int k = 0; k < nk; ++k) {
    fetch(k + NSF - 1);
    tc::cp_wait<NSF - 1>();
    __syncthreads();
    const Tl& s = st[k % NSF];
    // each lane's partial of y_t over its states to shared memory
    run_chunk<TF>(s, c, n0, a, h, [&](int tt, const float (&hh)[P]) {
      float cc[P];
      load_row<P>(cc, &s.c[tt][n0]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < P; ++j) acc[j & 3] = fmaf(hh[j], cc[j], acc[j & 3]);
      sm.yp[tt][threadIdx.x] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    });
    __syncthreads();
    // the chunk's y: each channel's lane partials in lane order, stored
    // coalesced along di
    for (int i = threadIdx.x; i < TF * CH; i += CB) {
      const int tt = i / CH, cc = i % CH, t = k * TF + tt;
      if (t < S && d0 + cc < di) {
        float yv = sm.yp[tt][cc * G];
#pragma unroll
        for (int g = 1; g < G; ++g) yv += sm.yp[tt][cc * G + g];
        y[(row + t) * di + d0 + cc] = yv;
      }
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (n0 + j < N) h_last[((size_t)b * di + d) * N + n0 + j] = h[j];
  }
}

// --------------------------------------------------------------- backward

// The sum over a warp's 32 channels of each lane's V values. Halving
// levels at lane masks 16, 8, ..., 32 / V leave lane l holding the sum
// of value l / (32 / V) over the lanes that differ from it in those
// bits; the plain levels below, down to mask 1, complete it over the
// warp. A fixed tree: the same bits every call.
template <int CNT, int M, int V>
__device__ __forceinline__ void halve(float (&v)[V], int lane) {
  if constexpr (CNT > 1) {
    const bool up = lane & M;
#pragma unroll
    for (int k = 0; k < CNT / 2; ++k) {
      const float send = up ? v[k] : v[k + CNT / 2];
      const float keep = up ? v[k + CNT / 2] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    halve<CNT / 2, M / 2>(v, lane);
  }
}

template <int V>
__device__ __forceinline__ float warp_channel_sum(float (&v)[V], int lane) {
  static_assert(V <= 32, "one value per lane after the halving");
  halve<V, 16>(v, lane);
#pragma unroll
  for (int m = 16 / V; m >= 1; m >>= 1)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
  return v[0];
}

template <int NP>
struct BwdSmem {
  Tile<NP, L, true, CB> st[NSB];  // a ring of staged chunks
  float h[L][NP][CB];           // the chunk's states, a column a thread
  float red[NWARP][L][2 * NP];  // per-warp sums of g dt x and gy h
  float qa[L][CB];              // each channel's sum_n q A
  float gb[L][CB];              // each channel's sum_n g B
};

template <int NP, bool NEED_A>
__global__ void __launch_bounds__(CB, 2)
scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, const float* __restrict__ gy,
                const float* __restrict__ gh_last, float* __restrict__ ck,
                float* __restrict__ part_bc, float* __restrict__ part_a,
                float* __restrict__ ddt, float* __restrict__ dx, int S,
                int di, int N, int vec) {
  constexpr int V = 2 * NP;
  using Tl = Tile<NP, L, true, CB>;
  extern __shared__ float4 smem_f4[];
  BwdSmem<NP>& sm = *reinterpret_cast<BwdSmem<NP>*>(smem_f4);

  const int b = blockIdx.y, nb = gridDim.y, d0 = blockIdx.x * CB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = d0 + tid;
  const bool live = d < di;
  const size_t row = (size_t)b * S;
  const int K = (S + L - 1) / L;
  float a[NP], h[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    a[j] = (live && j < N) ? A[(size_t)d * N + j] : 0.f;
    h[j] = 0.f;
  }
  // checkpoint k (the state after chunk k) of this thread's state n
  auto ck_at = [&](int k, int n) {
    return ck + (((size_t)b * (K - 1) + k) * N + n) * di + d;
  };

  // pass 1: the forward over chunks 0 .. K-2, keeping their end states;
  // chunk k in ring slot k % NSB, commit group k (as in the forward)
  if (K > 1) {
    auto fetch = [&](int k) {
      if (k < K - 1)
        stage(sm.st[k % NSB], dt, x, gy, Bm, Cm, row, k * L, S, d0, di, N,
              vec, false);
      tc::cp_commit();
    };
    for (int k = 0; k < NSB - 1; ++k) fetch(k);
    for (int k = 0; k < K - 1; ++k) {
      fetch(k + NSB - 1);
      tc::cp_wait<NSB - 1>();
      __syncthreads();
      run_chunk<L>(sm.st[k % NSB], tid, 0, a, h,
                   [](int, const float (&)[NP]) {});
      if (live) {
#pragma unroll
        for (int j = 0; j < NP; ++j)
          if (j < N) *ck_at(k, j) = h[j];
      }
      __syncthreads();
    }
    tc::cp_wait<0>();
    __syncthreads();         // the ring is free for the reverse
  }

  // the reverse, chunk by chunk from the end: the i-th chunk visited,
  // k = K-1-i, in ring slot i % NSB and commit group i
  float carry[NP], dA[NP], hs[NP], hn[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    carry[j] = (gh_last && live && j < N)
                   ? gh_last[((size_t)b * di + d) * N + j] : 0.f;
    dA[j] = 0.f;
  }
  auto fetch = [&](int i) {
    if (i < K)
      stage(sm.st[i % NSB], dt, x, gy, Bm, Cm, row, (K - 1 - i) * L, S, d0,
            di, N, vec, true);
    tc::cp_commit();
  };
  // the state before chunk k (its checkpoint; zeros before chunk 0), read
  // from this thread's own pass-1 stores one chunk ahead of its use
  auto load_h0 = [&](int k) {
#pragma unroll
    for (int j = 0; j < NP; ++j)
      hn[j] = (k > 0 && live && j < N) ? *ck_at(k - 1, j) : 0.f;
  };
  for (int i = 0; i < NSB - 1; ++i) fetch(i);
  load_h0(K - 1);
  for (int i = 0; i < K; ++i) {
    const int k = K - 1 - i;
    fetch(i + NSB - 1);
#pragma unroll
    for (int j = 0; j < NP; ++j) hs[j] = hn[j];
    load_h0(k - 1);
    tc::cp_wait<NSB - 1>();
    __syncthreads();
    const Tl& s = sm.st[i % NSB];

    // recompute the chunk's states into this thread's column of sm.h
#pragma unroll
    for (int j = 0; j < NP; ++j) h[j] = hs[j];
    run_chunk<L>(s, tid, 0, a, h, [&](int tt, const float (&hh)[NP]) {
#pragma unroll
      for (int j = 0; j < NP; ++j) sm.h[tt][j][tid] = hh[j];
    });

    // the reverse recurrence: step tt - 1's exponentials are formed ahead
    // of step tt's use; the sums over n and over d go to shared memory.
    // h holds h_t.
    float e[NP];
    auto prep = [&](int tt, float (&e_)[NP]) {
      const float dl = s.dt[tt][tid] * LOG2E;
#pragma unroll
      for (int j = 0; j < NP; ++j) e_[j] = ex2(dl * a[j]);
    };
    prep(L - 1, e);
#pragma unroll 2
    for (int tt = L - 1; tt >= 0; --tt) {
      float en[NP];
      if (tt > 0) prep(tt - 1, en);
      const float dtv = s.dt[tt][tid], gyv = s.gy[tt][tid];
      const float u = dtv * s.x[tt][tid];
      float bb[NP], cc[NP];
      load_row<NP>(bb, &s.b[tt][0]);
      load_row<NP>(cc, &s.c[tt][0]);
      float v[V];
      float sqa[2] = {0.f, 0.f}, sgb[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const float hp = tt > 0 ? sm.h[tt - 1][j][tid] : hs[j];
        const float g = fmaf(gyv, cc[j], carry[j]);
        const float ag = e[j] * g;
        const float q = ag * hp;
        sqa[j & 1] = fmaf(q, a[j], sqa[j & 1]);
        sgb[j & 1] = fmaf(g, bb[j], sgb[j & 1]);
        if (NEED_A) dA[j] = fmaf(q, dtv, dA[j]);
        v[j] = g * u;
        v[NP + j] = gyv * h[j];
        carry[j] = ag;
        h[j] = hp;
      }
      sm.qa[tt][tid] = sqa[0] + sqa[1];
      sm.gb[tt][tid] = sgb[0] + sgb[1];
      const float r = warp_channel_sum<V>(v, lane);
      if (lane % (32 / V) == 0) sm.red[warp][tt][lane / (32 / V)] = r;
      if (tt > 0) {
#pragma unroll
        for (int j = 0; j < NP; ++j) e[j] = en[j];
      }
    }
    __syncthreads();
    // the chunk's ddt and dx (stored coalesced) and its block partial of
    // dB and dC (the warps in order)
    for (int i = tid; i < L * CB; i += CB) {
      const int tt = i / CB, cc = i % CB, t = k * L + tt;
      if (t < S && d0 + cc < di) {
        const float qa = sm.qa[tt][cc], gb = sm.gb[tt][cc];
        const size_t off = (row + t) * di + d0 + cc;
        ddt[off] = fmaf(s.x[tt][cc], gb, qa);
        dx[off] = s.dt[tt][cc] * gb;
      }
    }
    for (int i = tid; i < L * 2 * NP; i += CB) {
      const int tt = i / (2 * NP), jj = i % (2 * NP), t = k * L + tt;
      if (t < S) {
        float r = sm.red[0][tt][jj];
#pragma unroll
        for (int w = 1; w < NWARP; ++w) r += sm.red[w][tt][jj];
        part_bc[(((size_t)blockIdx.x * nb + b) * S + t) * (2 * NP) + jj] = r;
      }
    }
    __syncthreads();
  }
  if (NEED_A && live) {
#pragma unroll
    for (int j = 0; j < NP; ++j)
      if (j < N) part_a[((size_t)b * N + j) * di + d] = dA[j];
  }
}

// dB, dC: the channel blocks' partials in block order; dA: the batch
// rows' partials in row order.
__global__ void scan_bwd_sum(const float* __restrict__ part_bc,
                             const float* __restrict__ part_a,
                             float* __restrict__ dB, float* __restrict__ dC,
                             float* __restrict__ dA, int GX, int B, int S,
                             int di, int N, int NP) {
  const size_t nbc = (size_t)B * S * N;
  const size_t total = 2 * nbc + (dA ? (size_t)di * N : 0);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i < 2 * nbc) {
      const int which = i >= nbc;
      const size_t r = i - which * nbc, bt = r / N;
      const int n = (int)(r % N);
      const float* p = part_bc + bt * (2 * NP) + which * NP + n;
      float s = 0.f;
      for (int gx = 0; gx < GX; ++gx) s += p[(size_t)gx * B * S * (2 * NP)];
      (which ? dC : dB)[r] = s;
    } else {
      const size_t r = i - 2 * nbc;   // (d, n)
      const size_t dd = r / N;
      const int n = (int)(r % N);
      float s = 0.f;
      for (int b = 0; b < B; ++b) s += part_a[((size_t)b * N + n) * di + dd];
      dA[r] = s;
    }
  }
}

int padded(int N) { return N <= 4 ? 4 : N <= 8 ? 8 : 16; }

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int NP>
size_t fwd_smem() { return sizeof(FwdSmem<NP>); }

template <int NP>
cudaError_t set_fwd_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      scan_fwd_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)fwd_smem<NP>());
  done = e == cudaSuccess;
  return e;
}

template <int NP, bool NEED_A>
cudaError_t set_bwd_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      scan_bwd_kernel<NP, NEED_A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(BwdSmem<NP>));
  done = e == cudaSuccess;
  return e;
}

template <int NP>
cudaError_t launch_fwd(const float* dt, const float* x, const float* Bm,
                       const float* Cm, const float* A, float* y,
                       float* h_last, int B, int S, int di, int N, int vec,
                       cudaStream_t st) {
  const cudaError_t e = set_fwd_smem<NP>();
  if (e != cudaSuccess) return e;
  constexpr int CH = CB / FWD_LANES;
  const dim3 grid((di + CH - 1) / CH, B);
  scan_fwd_kernel<NP><<<grid, CB, fwd_smem<NP>(), st>>>(
      dt, x, Bm, Cm, A, y, h_last, S, di, N, vec);
  return cudaGetLastError();
}

template <int NP, bool NEED_A>
cudaError_t launch_bwd(const float* dt, const float* x, const float* Bm,
                       const float* Cm, const float* A, const float* gy,
                       const float* gh, float* ck, float* part_bc,
                       float* part_a, float* ddt, float* dx, int B, int S,
                       int di, int N, int vec, cudaStream_t st) {
  const cudaError_t e = set_bwd_smem<NP, NEED_A>();
  if (e != cudaSuccess) return e;
  const dim3 grid((di + CB - 1) / CB, B);
  scan_bwd_kernel<NP, NEED_A><<<grid, CB, sizeof(BwdSmem<NP>), st>>>(
      dt, x, Bm, Cm, A, gy, gh, ck, part_bc, part_a, ddt, dx, S, di, N, vec);
  return cudaGetLastError();
}

// the kernel instance for (NP, NEED_A) at run time
cudaError_t fwd_at(int NP, const float* dt, const float* x, const float* Bm,
                   const float* Cm, const float* A, float* y, float* h, int B,
                   int S, int di, int N, int vec, cudaStream_t st) {
  if (NP == 4)
    return launch_fwd<4>(dt, x, Bm, Cm, A, y, h, B, S, di, N, vec, st);
  if (NP == 8)
    return launch_fwd<8>(dt, x, Bm, Cm, A, y, h, B, S, di, N, vec, st);
  return launch_fwd<16>(dt, x, Bm, Cm, A, y, h, B, S, di, N, vec, st);
}

template <bool NA>
cudaError_t bwd_at(int NP, const float* dt, const float* x, const float* Bm,
                   const float* Cm, const float* A, const float* gy,
                   const float* gh, float* ck, float* pbc, float* pa,
                   float* ddt, float* dx, int B, int S, int di, int N,
                   int vec, cudaStream_t st) {
  if (NP == 4)
    return launch_bwd<4, NA>(dt, x, Bm, Cm, A, gy, gh, ck, pbc, pa, ddt, dx,
                             B, S, di, N, vec, st);
  if (NP == 8)
    return launch_bwd<8, NA>(dt, x, Bm, Cm, A, gy, gh, ck, pbc, pa, ddt, dx,
                             B, S, di, N, vec, st);
  return launch_bwd<16, NA>(dt, x, Bm, Cm, A, gy, gh, ck, pbc, pa, ddt, dx,
                            B, S, di, N, vec, st);
}

template <int NP>
cudaError_t fwd_occupancy(int* blocks) {
  const cudaError_t e = set_fwd_smem<NP>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, scan_fwd_kernel<NP>, CB, fwd_smem<NP>());
}

template <int NP, bool NA>
cudaError_t bwd_occupancy(int* blocks) {
  const cudaError_t e = set_bwd_smem<NP, NA>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, scan_bwd_kernel<NP, NA>, CB, sizeof(BwdSmem<NP>));
}

}  // namespace

extern "C" int selective_scan_launch(const void* dt, const void* x,
                                     const void* Bm, const void* Cm,
                                     const void* A, void* y, void* h_last,
                                     int B, int S, int di, int N,
                                     void* stream) {
  if (B < 1 || B > 65535 || S < 1 || di < 1 || N < 1 || N > 16)
    return (int)cudaErrorInvalidValue;
  const int vec = di % 4 == 0 && aligned16(dt) && aligned16(x);
  return (int)fwd_at(padded(N), (const float*)dt, (const float*)x,
                     (const float*)Bm, (const float*)Cm, (const float*)A,
                     (float*)y, (float*)h_last, B, S, di, N, vec,
                     (cudaStream_t)stream);
}

// gh_last may be null (a zero cotangent); ck holds B * (K-1) * N * di
// floats (K = ceil(S / 8)), part_bc ceil(di / 128) * B * S * 2 NP,
// part_a B * N * di; part_a and dA are null when need_a is 0.
extern "C" int selective_scan_bwd_launch(
    const void* dt, const void* x, const void* Bm, const void* Cm,
    const void* A, const void* gy, const void* gh_last, void* ck,
    void* part_bc, void* part_a, void* ddt, void* dx, void* dB, void* dC,
    void* dA, int B, int S, int di, int N, int need_a, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || di < 1 || N < 1 || N > 16 ||
      (need_a && (!part_a || !dA)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *fdt = (const float*)dt, *fx = (const float*)x,
              *fb = (const float*)Bm, *fc = (const float*)Cm,
              *fa = (const float*)A, *fgy = (const float*)gy,
              *fgh = (const float*)gh_last;
  float *fck = (float*)ck, *pbc = (float*)part_bc, *pa = (float*)part_a;
  const int vec = di % 4 == 0 && aligned16(dt) && aligned16(x) &&
                  aligned16(gy);
  const int NP = padded(N);
  const cudaError_t e =
      need_a ? bwd_at<true>(NP, fdt, fx, fb, fc, fa, fgy, fgh, fck, pbc, pa,
                            (float*)ddt, (float*)dx, B, S, di, N, vec, st)
             : bwd_at<false>(NP, fdt, fx, fb, fc, fa, fgy, fgh, fck, pbc, pa,
                             (float*)ddt, (float*)dx, B, S, di, N, vec, st);
  if (e != cudaSuccess) return (int)e;
  const int GX = (di + CB - 1) / CB;
  const size_t total = 2 * (size_t)B * S * N + (need_a ? (size_t)di * N : 0);
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256
                                                       : 1024);
  scan_bwd_sum<<<blocks, 256, 0, st>>>(pbc, need_a ? pa : nullptr,
                                       (float*)dB, (float*)dC,
                                       need_a ? (float*)dA : nullptr, GX, B,
                                       S, di, N, NP);
  return (int)cudaGetLastError();
}

// The resident blocks per SM each kernel achieves at its shared memory
// and registers (cudaOccupancyMaxActiveBlocksPerMultiprocessor):
// which = 0 the forward, 1 the backward (need_a selects its instance).
extern "C" int selective_scan_occupancy(int which, int N, int need_a,
                                        int* blocks) {
  const int NP = padded(N);
  cudaError_t e;
  if (which == 0)
    e = NP == 4 ? fwd_occupancy<4>(blocks)
        : NP == 8 ? fwd_occupancy<8>(blocks) : fwd_occupancy<16>(blocks);
  else if (need_a)
    e = NP == 4 ? bwd_occupancy<4, true>(blocks)
        : NP == 8 ? bwd_occupancy<8, true>(blocks)
                  : bwd_occupancy<16, true>(blocks);
  else
    e = NP == 4 ? bwd_occupancy<4, false>(blocks)
        : NP == 8 ? bwd_occupancy<8, false>(blocks)
                  : bwd_occupancy<16, false>(blocks);
  return (int)e;
}
