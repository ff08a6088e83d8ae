// Fused dequant-matmul  y = x @ dequant(W_q)  for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quant_matmul.py:quant_matmul (Pallas TPU
// kernel, body _kernel and dequant_tile).
//
// Bound on the H100: at the serve plane's shapes (one row per user,
// K = N = 768, four users per launch in the replay) this is a GEMV over
// the quantized bytes, so it is memory-bound: 1 byte per weight at int8
// and 0.5 at int4/NF4 against 2 flops per weight. 2.4 MB at four users
// is about 0.75 us at 3.35 TB/s, so the card has to have nearly the
// whole payload in flight at once. At M = 800 it leans towards the fp32
// CUDA-core rate.
//
// Design: W is never written dense, and the stacked user axis is a grid
// axis, so a whole serve group is one launch. Two paths:
//  - GEMV (M <= 4 rows per user, N % 4 == 0, 4-byte aligned payload);
//    see qmv_kernel. K is split across the CTAs of a thread-block
//    cluster: each CTA takes whole quant groups [g0, g1) of one column
//    tile of one user, so a launch of a few users still spreads over
//    the SMs (the plan, chosen in kernels/quant_matmul.py:plan, comes in
//    as launch arguments; 288 CTAs at the replay's four users). Each
//    thread streams 16 adjacent columns of its code rows with 16-byte
//    loads through the read-only path and issues up to GV_LMAX of them
//    before it decodes any, so a CTA keeps its whole slice (8 KB at the
//    replay's shape) in flight; plain loads were
//    chosen over TMA because a CTA's slice is a few strided rows, which
//    needs no ring and no producer warp at this size. x's K slice and
//    the slice's scales are staged in shared memory once per CTA (bf16 x
//    converted to fp32 once); a thread keeps its 16 scales in registers
//    while its rows stay in one group; int8 and int4 codes become floats
//    by a byte permute into 2^23 and one exact subtraction, not by an
//    integer-to-float conversion, which issues at a quarter of the FMA
//    rate. The row lanes' partials are summed in shared memory in lane
//    order; each CTA writes that partial into its slot of the leader
//    CTA's (rank 0) shared memory through distributed shared memory
//    (map_shared_rank), and after one cluster barrier the leader adds the
//    slots in rank order and writes y. No atomics and no second launch:
//    two calls are bitwise equal. The serve shape is a chain of
//    latencies (launch, loads, staging, barriers), each of about a
//    microsecond, so the design keeps that chain short: the first code
//    loads go out before the staging, the staging's loads all go out
//    before its stores, and the cluster meets at one barrier.
//  - tiled (any other shape): each block owns a (BM x 64) output tile and
//    walks K in 32-row tiles, dequantizing the (32 x 64) weight tile into
//    shared memory (loads coalesced along N), fp32 accumulation.
// Packed 4-bit row j holds rows 2j (hi nibble) and 2j+1 (lo nibble); the
// decode is dequant.cuh's, shared with lora_matmul.cu, and NF4 codes map
// through the 16-entry codebook in shared memory. A weight is code x
// scale in fp32, the product the plain version computes.
#include <cooperative_groups.h>

#include "dequant.cuh"

namespace cg = cooperative_groups;

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
// Launch: grid (tiles * csize, T), clusters of (csize, 1, 1), GV_THREADS
// threads; CTA rank r of a cluster owns groups [r G / csize, (r+1) G /
// csize) of column tile blockIdx.x / csize. Thread (rl, tc) owns columns
// [16 tc, 16 tc + 16) of the tile and the CTA's code rows rl, rl + lanes,
// rl + 2 lanes, ... (lanes = GV_THREADS / (cols / 16)).
constexpr int GV_THREADS = 128;     // 4 warps
constexpr int GV_CPT = 16;          // columns a thread: one 16-byte load
constexpr int GV_LMAX = 8;          // code rows a thread has in flight
constexpr int GV_CLUSTER_MAX = 12;  // the largest cluster run on the H100

constexpr int GV_STAGE = 4;         // staging loads a thread has in flight

// shared memory (floats) of one GEMV CTA: the ranks' partials (written
// into the leader's), the row lanes' partials, x's K slice, its scales
__host__ __device__ constexpr int gv_smem_floats(int MR, int cols, int csize,
                                                 int kxp, int gmax) {
  return csize * MR * cols + GV_THREADS * MR * GV_CPT + MR * kxp + gmax * cols;
}

// The cluster barrier in two halves (PTX barrier.cluster): arrive, then
// wait for every thread of every CTA of the cluster to have arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 code bytes of one row from column n on: one 16-byte load, or 4-byte
// loads where the row is not 16-byte aligned or ends within the chunk
// (left columns remain; N % 4 == 0, so a word is all in or all out).
__device__ __forceinline__ uint4 load_codes(const uint8_t* p, int left,
                                            int vec16) {
  if (vec16 && left >= GV_CPT) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned int* w = reinterpret_cast<const unsigned int*>(p);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (left > 0) v.x = __ldg(w);
  if (left > 4) v.y = __ldg(w + 1);
  if (left > 8) v.z = __ldg(w + 2);
  if (left > 12) v.w = __ldg(w + 3);
  return v;
}

template <typename T, int FMT, int MR>
__global__ void __launch_bounds__(GV_THREADS)
qmv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
           const float* __restrict__ s, T* __restrict__ y, int Kq, int N,
           int block, int rows, int cols, int csize, int vec16) {
  extern __shared__ float4 gv_dyn[];
  // lanes index the codebook divergently: constant memory would
  // serialise that, shared memory serves 16 distinct words at once
  __shared__ float code[16];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / csize;
  const int t = blockIdx.y;
  const int G = Kq / block;
  const int g0 = rank * G / csize;
  const int ng = (rank + 1) * G / csize - g0;
  const int gmax = (G + csize - 1) / csize;
  const int tpc = cols / GV_CPT;                 // threads across the tile
  const int lanes = GV_THREADS / tpc;            // row lanes
  const int tc = threadIdx.x % tpc, rl = threadIdx.x / tpc;
  const int n0 = tile * cols;
  const int kn = ng * block;                     // x's K slice
  const int kxp = (gmax * block + 3) & ~3;
  const int per = MR * cols;                     // outputs of the tile
  float* slots = reinterpret_cast<float*>(gv_dyn); // csize * per (leader)
  float* part = slots + csize * per;             // lanes * per
  float* xs = part + GV_THREADS * MR * GV_CPT;   // MR * kxp
  float* ss = xs + MR * kxp;                     // gmax * cols
  cluster_arrive_relaxed();          // this rank has started

  // the first LMAX code rows' loads go out before the staging below, so
  // their latency overlaps that of x and the scales
  const int R = ng * rows;                       // the CTA's code rows
  const int step = GV_LMAX * lanes;
  const int nt = n0 + tc * GV_CPT;
  const int left = N - nt;
  const uint8_t* qt = q + ((size_t)t * G + g0) * rows * N + nt;
  uint4 w[GV_LMAX];
#pragma unroll
  for (int u = 0; u < GV_LMAX; ++u) {
    const int i = rl + u * lanes;
    w[u] = i < R && left > 0 ? load_codes(qt + (size_t)i * N, left, vec16)
                             : make_uint4(0u, 0u, 0u, 0u);
  }

  // x's K slice and the slice's scales, the scales chunk-major within a
  // group, [c4][tc][4], so a thread's 16 scales are 4 float4s and a
  // quarter warp reads 128 contiguous bytes. Every load of a round goes
  // out before its stores: one latency a round, one round at the serve
  // shape.
  dq::load_codebook(code);
  const T* xt = x + (size_t)t * MR * Kq + (size_t)g0 * block;
  const float* st = s + ((size_t)t * G + g0) * N + n0;
  const int nx = MR * kn, nsc = ng * cols;
  for (int i0 = threadIdx.x; i0 < max(nx, nsc); i0 += GV_STAGE * GV_THREADS) {
    float xv[GV_STAGE], sv[GV_STAGE];
#pragma unroll
    for (int j = 0; j < GV_STAGE; ++j) {
      const int i = i0 + j * GV_THREADS;
      const int m = i / kn, gl = i / cols;
      xv[j] = i < nx ? load_f(xt + (size_t)m * Kq + (i - m * kn)) : 0.f;
      sv[j] = i < nsc && n0 + i - gl * cols < N
                  ? st[(size_t)gl * N + (i - gl * cols)] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < GV_STAGE; ++j) {
      const int i = i0 + j * GV_THREADS;
      const int m = i / kn, gl = i / cols, col = i - gl * cols;
      if (i < nx) xs[m * kxp + (i - m * kn)] = xv[j];
      if (i < nsc)
        ss[gl * cols + (((col % GV_CPT) >> 2) * tpc + col / GV_CPT) * 4 +
           (col & 3)] = sv[j];
    }
  }
  __syncthreads();

  float acc[MR][GV_CPT];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < GV_CPT; ++c) acc[m][c] = 0.f;

  if (left > 0) {
    int cur = -1;
    float sc[GV_CPT];
    for (int i0 = rl; i0 < R; i0 += step) {
      if (i0 != rl) {
#pragma unroll
        for (int u = 0; u < GV_LMAX; ++u) {
          const int i = i0 + u * lanes;
          w[u] = i < R ? load_codes(qt + (size_t)i * N, left, vec16)
                       : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < GV_LMAX; ++u) {
        const int i = i0 + u * lanes;
        if (i >= R) break;
        const int gl = i / rows;
        if (gl != cur) {
          cur = gl;
          const float4* sp = reinterpret_cast<const float4*>(ss + gl * cols) + tc;
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) {
            const float4 v = sp[c4 * tpc];
            sc[4 * c4] = v.x; sc[4 * c4 + 1] = v.y;
            sc[4 * c4 + 2] = v.z; sc[4 * c4 + 3] = v.w;
          }
        }
        const uint32_t word[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
        if (FMT == FMT_INT8) {                   // row i is K row i
          float xv[MR];
#pragma unroll
          for (int m = 0; m < MR; ++m) xv[m] = xs[m * kxp + i];
#pragma unroll
          for (int c = 0; c < GV_CPT; ++c) {
            const float wt = dq::code8(word[c >> 2], c & 3) * sc[c];
#pragma unroll
            for (int m = 0; m < MR; ++m) acc[m][c] = fmaf(xv[m], wt, acc[m][c]);
          }
        } else {                                 // rows 2i and 2i + 1
          float xh[MR], xl[MR];
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            const float2 v = *reinterpret_cast<const float2*>(xs + m * kxp + 2 * i);
            xh[m] = v.x;
            xl[m] = v.y;
          }
#pragma unroll
          for (int c = 0; c < GV_CPT; ++c) {
            float whi, wlo;
            dq::pair4<FMT>(word[c >> 2], c & 3, sc[c], code, &whi, &wlo);
#pragma unroll
            for (int m = 0; m < MR; ++m) {
              acc[m][c] = fmaf(xh[m], whi, acc[m][c]);
              acc[m][c] = fmaf(xl[m], wlo, acc[m][c]);
            }
          }
        }
      }
    }
  }

  // row lanes' partials, [lane][m][c4][tc][4]: the same order as red
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4)
      *reinterpret_cast<float4*>(part + rl * per + ((m * 4 + c4) * tpc + tc) * 4) =
          make_float4(acc[m][4 * c4], acc[m][4 * c4 + 1], acc[m][4 * c4 + 2],
                      acc[m][4 * c4 + 3]);
  __syncthreads();
  // the CTA's partial, its row lanes summed in order, goes straight into
  // slot `rank` of the leader's shared memory (once every rank has
  // started: the first cluster barrier phase, arrived at on entry)
  cluster_wait();
  float* dst = cluster.map_shared_rank(slots, 0) + rank * per;
  for (int o = threadIdx.x; o < per; o += GV_THREADS) {
    float v = 0.f;
#pragma unroll 8
    for (int r = 0; r < lanes; ++r) v += part[r * per + o];
    dst[o] = v;
  }
  cluster_arrive();                  // release: the slots are written
  cluster_wait();
  if (rank == 0) {                   // the leader adds the ranks in order
    for (int o = threadIdx.x; o < per; o += GV_THREADS) {
      float v = 0.f;
#pragma unroll 4
      for (int r = 0; r < csize; ++r) v += slots[r * per + o];
      const int m = o / cols, rem = o - m * cols;
      const int c4 = rem / (4 * tpc), tcc = (rem >> 2) % tpc;
      const int n = n0 + tcc * GV_CPT + c4 * 4 + (rem & 3);
      if (n < N) store_f(y + ((size_t)t * MR + m) * N + n, v);
    }
  }
}

template <typename T, int FMT, int MR>
cudaError_t launch_gemv(const void* x, const void* q, const void* s, void* y,
                        int T_, int Kq, int N, int block, int rows, int cols,
                        int csize, cudaStream_t stream) {
  const int G = Kq / block;
  const int gmax = (G + csize - 1) / csize;
  const int kxp = (gmax * block + 3) & ~3;
  const size_t smem = sizeof(float) * gv_smem_floats(MR, cols, csize, kxp, gmax);
  auto* kern = qmv_kernel<T, FMT, MR>;
  // attributes set once per instance: the cluster beyond 8 CTAs, and
  // dynamic shared memory beyond the default 48 KB
  static bool wide = false;
  static size_t smem_set = 48 * 1024;
  if (csize > 8 && !wide) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    wide = true;
  }
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const int vec16 = N % 16 == 0 && (uintptr_t)q % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + cols - 1) / cols) * csize, T_);
  cfg.blockDim = dim3(GV_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, (const T*)x, (const uint8_t*)q,
                            (const float*)s, (T*)y, Kq, N, block, rows, cols,
                            csize, vec16);
}

// cols > 0: the GEMV with the plan's column tile and cluster size; the
// launcher refuses a shape the GEMV does not take. cols == 0: tiled.
template <typename T, int FMT>
cudaError_t launch_typed(const void* x, const void* q, const void* s, void* y,
                         int T_, int M, int Kq, int N, int block, int rows,
                         int cols, int csize, cudaStream_t stream) {
  if (cols > 0) {
    const int G = Kq / block;
    if (M > 4 || N % 4 || (uintptr_t)q % 4 || cols < GV_CPT ||
        cols % GV_CPT || GV_THREADS % (cols / GV_CPT) || csize < 1 ||
        csize > GV_CLUSTER_MAX || csize > G)
      return cudaErrorInvalidValue;
    switch (M) {
      case 1: return launch_gemv<T, FMT, 1>(x, q, s, y, T_, Kq, N, block, rows, cols, csize, stream);
      case 2: return launch_gemv<T, FMT, 2>(x, q, s, y, T_, Kq, N, block, rows, cols, csize, stream);
      case 3: return launch_gemv<T, FMT, 3>(x, q, s, y, T_, Kq, N, block, rows, cols, csize, stream);
      default: return launch_gemv<T, FMT, 4>(x, q, s, y, T_, Kq, N, block, rows, cols, csize, stream);
    }
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
                       int rows, int cols, int csize, cudaStream_t stream) {
  switch (fmt) {
    case FMT_INT8:
      return launch_typed<T, FMT_INT8>(x, q, s, y, T_, M, Kq, N, block, rows, cols, csize, stream);
    case FMT_INT4:
      return launch_typed<T, FMT_INT4>(x, q, s, y, T_, M, Kq, N, block, rows, cols, csize, stream);
    case FMT_NF4:
      return launch_typed<T, FMT_NF4>(x, q, s, y, T_, M, Kq, N, block, rows, cols, csize, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// fmt: 0 int8, 1 int4 (packed), 2 NF4 (packed); is_bf16: x and y dtype;
// cols, csize: the GEMV's column tile and cluster size (cols 0: tiled).
extern "C" int quant_matmul_launch(const void* x, const void* q,
                                   const void* s, void* y, int T, int M,
                                   int Kq, int N, int block, int rows,
                                   int fmt, int is_bf16, int cols, int csize,
                                   void* stream) {
  if (T < 1 || M < 1 || N < 1 || block < 1 || Kq % block || T > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      is_bf16 ? launch_fmt<__nv_bfloat16>(fmt, x, q, s, y, T, M, Kq, N, block, rows, cols, csize, st)
              : launch_fmt<float>(fmt, x, q, s, y, T, M, Kq, N, block, rows, cols, csize, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory (bytes) of one GEMV CTA for M rows a user, Kq =
// G block, a column tile of cols and a cluster of csize.
extern "C" int quant_matmul_gemv_smem(int M, int Kq, int block, int cols,
                                      int csize) {
  const int G = Kq / block;
  const int gmax = (G + csize - 1) / csize;
  const int kxp = (gmax * block + 3) & ~3;
  return (int)sizeof(float) * gv_smem_floats(M, cols, csize, kxp, gmax);
}
