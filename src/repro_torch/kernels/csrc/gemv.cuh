// The thread-block-cluster GEMV over a quantized weight, gemv_kernel,
// shared by quant_matmul.cu's GEMV route (the serve head, the QmvOut
// epilogue) and lora_gemv.cu's decode route of the fused LoRA linear
// (the LoraGemvOut epilogue). One kernel template, its body in one
// __global__ function: the same body split into a device function
// called by two kernels compiled to fewer registers and ran the serve
// GEMV 1.5x slower at Kimi-K2's expert shapes on the H100
// (scripts/torch_serve_kernels_ab.py against the previous tree).
//
// Work of one launch: grid (tiles * csize, T), clusters of (csize, 1, 1),
// GV_THREADS threads. CTA rank r of a cluster owns quant groups
// [r G / csize, (r+1) G / csize) of column tile blockIdx.x / csize of
// user blockIdx.y, and computes the tile's partial y over its groups for
// MR rows (gemv_kernel):
//  - thread (rl, tc) owns columns [16 tc, 16 tc + 16) of the tile and
//    the CTA's code rows rl, rl + lanes, rl + 2 lanes, ... (lanes =
//    GV_THREADS / (cols / 16)); it streams them with 16-byte loads through
//    the read-only path and issues up to LMAX of them before it decodes
//    any, so a CTA keeps its whole slice in flight; the first LMAX go out
//    before x and the scales are staged, so their latencies overlap;
//  - x's K slice (bf16 converted to fp32 once) and
//    the slice's scales are staged in shared memory once per CTA, every
//    load of a round before its stores; a thread keeps its 16 scales in
//    registers while its rows stay in one group;
//  - codes become weights in registers: code * fp32 scale (int8 and int4
//    by a byte permute into 2^23 and one exact subtraction, NF4 through
//    the codebook in shared memory), the plain version's product, then
//    one fp32 FMA with fp32(x) per row;
//  - the row lanes' partials are summed in shared memory in lane order;
//    the CTA's partial goes into slot `rank` of the leader CTA's (rank 0)
//    shared memory through distributed shared memory (map_shared_rank),
//    and after one cluster barrier the leader holds every rank's slot.
// The leader's epilogue (the kernel's template argument) then adds the
// slots in rank order (leader_sum) and writes its tile: no atomics and no
// second pass, so two calls are bitwise equal.
#pragma once

#include <cooperative_groups.h>

#include "dequant.cuh"

namespace gv {

namespace cg = cooperative_groups;

constexpr int GV_THREADS = 128;     // 4 warps
constexpr int GV_CPT = 16;          // columns a thread: one 16-byte load
constexpr int GV_LMAX = 8;          // code rows a thread has in flight
constexpr int GV_CLUSTER_MAX = 12;  // the largest cluster run on the H100
constexpr int GV_STAGE = 4;         // staging loads a thread has in flight

// x's K slice of one CTA, in floats a row (padded to 4)
__host__ __device__ constexpr int gv_kxp(int gmax, int block) {
  return (gmax * block + 3) & ~3;
}
// shared memory (floats) of one GEMV CTA: the ranks' partials (written
// into the leader's), the row lanes' partials, x's K slice, its scales;
// with `reuse` the lanes' partials take x's and the scales' buffer
__host__ __device__ constexpr int gv_smem_floats(int MR, int cols, int csize,
                                                 int kxp, int gmax,
                                                 bool reuse) {
  return csize * MR * cols +
         (!reuse ? GV_THREADS * MR * GV_CPT + MR * kxp + gmax * cols
          : GV_THREADS * MR * GV_CPT > MR * kxp + gmax * cols
              ? GV_THREADS * MR * GV_CPT : MR * kxp + gmax * cols);
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

// The block's dynamic shared memory: the ranks' slots first.
extern __shared__ float4 gv_dyn[];

// One launch of the GEMV over MR rows a user: x (T, MR, Kq), q (T, G,
// rows, N), s (T, G, 1, N). CTA rank r computes its partial of its tile
// and pushes it into slot r of the leader's slots ([csize][MR * cols]
// floats at the start of the dynamic shared memory; then the row lanes'
// partials [lanes][MR * cols], x's K slice [MR][kxp] and the slice's
// scales [gmax][cols], gv_smem_floats in all, then whatever the epilogue
// keeps); after the last cluster barrier the leader calls
// ``ep(slots, tail, per, csize, cols, n0, t, N)``: slots holds every
// rank's partial of the tile, laid out [m][c4][tc][4] (column n0 + 16 tc
// + 4 c4 + e of row m at ((m * 4 + c4) * tpc + tc) * 4 + e: out_at), and
// tail is the epilogue's own shared memory.
template <typename T, int FMT, int MR, int LMAX, typename Epilogue>
__global__ void __launch_bounds__(GV_THREADS)
gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
            const float* __restrict__ s, const Epilogue ep, int Kq, int N,
            int block, int rows, int cols, int csize, int vec16) {
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
  // the lanes' partials reuse x's and the scales' buffer once the loop
  // is done where the epilogue asks (Epilogue::kReuse) or past 4 rows:
  // less shared memory leaves more of the SM's 256 KB to L1, which stages
  // the streamed code loads (the LoRA route ran slower at its decode
  // shapes without; the serve GEMV keeps the buffer it was tuned with)
  constexpr bool REUSE = MR > 4 || Epilogue::kReuse;
  float* slots = reinterpret_cast<float*>(gv_dyn); // csize * per (leader)
  float* part = slots + csize * per;             // lanes * per
  float* xs = REUSE ? part : part + GV_THREADS * MR * GV_CPT;  // MR * kxp
  float* ss = xs + MR * kxp;                     // gmax * cols
  cluster_arrive_relaxed();          // this rank has started

  // the first LMAX code rows' loads go out before the staging below, so
  // their latency overlaps that of x and the scales
  const int R = ng * rows;                       // the CTA's code rows
  const int step = LMAX * lanes;
  const int nt = n0 + tc * GV_CPT;
  const int left = N - nt;
  const uint8_t* qt = q + ((size_t)t * G + g0) * rows * N + nt;
  uint4 w[LMAX];
#pragma unroll
  for (int u = 0; u < LMAX; ++u) {
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
      xv[j] = i < nx ? dq::load_f(xt + (size_t)m * Kq + (i - m * kn)) : 0.f;
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
        for (int u = 0; u < LMAX; ++u) {
          const int i = i0 + u * lanes;
          w[u] = i < R ? load_codes(qt + (size_t)i * N, left, vec16)
                       : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < LMAX; ++u) {
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
        if (FMT == dq::FMT_INT8) {                   // row i is K row i
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

  if (REUSE) __syncthreads();        // x and the scales are consumed
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
  // the leader: its epilogue adds the ranks in order and writes the tile
  if (rank == 0)
    ep(slots, slots + gv_smem_floats(MR, cols, csize, kxp, gmax, REUSE),
       per, csize, cols, n0, t, N);
}

// Output o of the leader's tile: the ranks' slots added in rank order.
__device__ __forceinline__ float leader_sum(const float* slots, int per,
                                            int csize, int o) {
  float v = 0.f;
#pragma unroll 4
  for (int r = 0; r < csize; ++r) v += slots[r * per + o];
  return v;
}

// The row and column of output o of a tile at n0 in the slots' layout.
__device__ __forceinline__ void out_at(int o, int cols, int n0, int* m,
                                       int* n) {
  const int tpc = cols / GV_CPT;
  *m = o / cols;
  const int rem = o - *m * cols;
  const int c4 = rem / (4 * tpc), tcc = (rem >> 2) % tpc;
  *n = n0 + tcc * GV_CPT + c4 * 4 + (rem & 3);
}

}  // namespace gv
