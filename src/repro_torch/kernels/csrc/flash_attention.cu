// Blocked online-softmax attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (Pallas
// TPU kernel, body _kernel).
//
// Layout and masks of the Pallas kernel: q (B, S, H, D), k/v (B, Skv,
// Hkv, D), kv head h / (H / Hkv) (GQA); key kp is valid for query qp when
// kp < Skv, plus qp >= kp when causal, plus qp - kp < window; tiles wholly
// outside the causal/window band are skipped, which is exact since a
// masked key adds nothing. A row with no valid key gives 0, as the TPU
// kernel's max(l, 1e-30) does. Any D <= 1024. Four routes, chosen in the
// wrapper (kernels/flash_attention.py, route) by dtype, then by D for bf16
// and by S for fp32, never as a fallback of one another.
//
// bf16: flash_tc_kernel, tensor cores (flash_attention_tc_launch).
// Bound on the H100 at the trainer's shapes (S = 64): bytes (q, k, v, o
// read/written once: 4 MB at the adapter's (4, 64, 8, 512)); the work is
// small, so latency and the number of blocks in flight decide the time.
//  - mma.sync.m16n8k16 with ldmatrix (csrc/mma.cuh), bf16 operands and
//    fp32 accumulators, not wgmma: a warp owns 16 query rows, as in
//    FlashAttention-2, so the scores' C fragments become the bf16 A
//    fragments of P @ V in registers (the running max m, the sum l and O
//    stay fp32 in registers). wgmma's 64-row warpgroup tile would leave
//    most of a 64-query block idle under the causal mask and needs P
//    staged in shared memory.
//  - P enters P @ V as two bf16 parts, hi = bf16(p) and lo = bf16(p -
//    hi) (split_bf16, two mma passes; about 16 bits of p). With P
//    rounded once to bf16, as FlashAttention-2 does, the 2-layer Yi-9B
//    card-vs-CPU step check's worst held gradient (adapter wq) sat at
//    1.8% of its 2% bound; with the split, 1.6% (PERF.md, PR 14). The
//    second pass adds 32 mma to a D = 512 tile's 160.
//  - Grid (B * H * ceil(D / 128), ceil(S / 64)): 4 warps, 64 query rows
//    and one 128-wide slice of D per block. Each block computes the full
//    Q K^T over all of D (cheap) but P @ V only for its slice, so O takes
//    64 fp32 registers a lane at any D <= 512, and the adapter's 32
//    (b, h) pairs at D = 512 give 128 blocks, the backbone's (4, 64, 32,
//    128) 128 blocks.
//  - K and V tiles of 32 keys are staged by cp.async in two stages (Q
//    with the first), so the next tile's load overlaps this tile's math;
//    rows are padded by 16 bytes (conflict-free ldmatrix) and D up to a
//    multiple of 16 with zeros, which is exact. D % 8 != 0 takes plain
//    element loads into the same tiles. Shared memory is 147 KB at
//    D = 512 (cudaFuncSetAttribute once), 20 KB at D = 128.
//  - Above D = 512 (the adapter's 896 at LLaVA-NeXT-34B width):
//    flash_tc_cluster_kernel, below. The earlier route for that width,
//    flash_tc_kernel<1> (one K and one V stage, each tile loaded after
//    the last is consumed: 207 KB at D = 1024), stays for the card's A/B
//    only (route 1 of flash_attention_tc_launch); the wrapper never picks
//    it.
//
// bf16, D > 512: flash_tc_cluster_kernel, tensor cores over a cluster.
// Bound at the LLaVA adapter's (4, 640, 8, 896), causal: bytes (q, k, v
// and o once, 147 MB: 0.044 ms at 3.35 TB/s; the work, 4 B H D S (S + 1)
// / 2 = 23.5 GFLOP, is 0.024 ms at 989 TFLOP/s). The D <= 512
// design ran 7 blocks a (b, h, q-tile), one a 128-wide slice of the
// output, and each formed the whole Q K^T over all 896 dims for its
// slice's P V: every block read all of K, and 6 of every 7 score tiles
// repeated a sibling's (two thirds of the route's mma). Here:
//  - The ceil(Dp / 128) <= 8 slice blocks of one (b, h, q-tile) form a
//    thread-block cluster (clusters of nsl along the grid). Rank r
//    stages only its slice of Q (once), of each K tile and of each V
//    tile: Q, K and V are read once per q-tile.
//  - For each key tile a rank forms the partial scores Q_r K_r^T over
//    its 128 dims (mma.sync, fp32) and the cluster sums them in two
//    rounds through distributed shared memory (map_shared_rank), a
//    reduce-scatter then an all-gather: value f of every thread's
//    16-value fragment belongs to rank f % nsl, which adds the ranks'
//    partials of it in rank order; then every rank reads each value
//    from its owner. So every rank holds the same S, bit for bit, with
//    no atomics, and a rank reads 2 (nsl - 1) / nsl of a score tile
//    remotely where an all-gather of the partials reads nsl - 1 tiles
//    (a first version all-gathered: at nsl = 7 the exchange then moved
//    more bytes than K and V, and the route ran slower than the one it
//    replaces). The partials and sums sit at [value][thread], so a
//    warp's 32 reads of one value are 32 consecutive words (a
//    fragment-major layout costs 4-way bank conflicts on every remote
//    read). One buffer each is enough: a rank rewrites its partials
//    (its sums) only after every rank has passed the next cluster
//    barrier, i.e. finished reading them. The score block of a (q-tile,
//    key-tile) is formed once, in slices.
//  - The softmax (running max and sum in fp32, exp2 of the scaled
//    scores), the masks, and P V on the rank's slice with P as hi + lo
//    (two mma passes) are the D <= 512 kernel's.
//  - K and V tiles of the slice go through a 2-stage cp.async ring (the
//    load of tile t + 1 is issued before tile t's math): Q 17 KB, the
//    ring 35 KB, partials and sums 16 KB, 68 KB and 168 registers a
//    thread, three blocks an SM. Three and four stages (86 and 103 KB,
//    two blocks an SM) ran slower at the adapter's shape: the exchange's
//    latency wants blocks in flight more than a deeper ring.
//  - The grid walks (b, h) major and the q-tiles from the last, so the
//    clusters in flight share a few heads' K and V in L2 and the longest
//    causal rows start first.
//  - Every rank of a cluster has the same q-tile, hence the same key
//    tiles and the same warp-uniform skips, so the cluster barriers
//    match; a final barrier keeps each rank's sums alive until the
//    others have read them.

// fp32, short S (the FL round's and the serve oracle's S = 1):
// flash_rows_kernel, one warp a query row (flash_attention_f32_launch,
// route 0; the wrapper's "cuda_rows"). Bound at the cohort's (160, 1, 4,
// 192): bytes (q, k, v, o once, 1.97 MB: 0.59 us at 3.35 TB/s); the work
// is one key a row, so the launch and the latency of one dependent chain
// of loads decide the time. The first design's block of 16 query rows
// left 15 empty at S = 1 and staged a 16 x D Q tile and two 32-key K/V
// tiles through shared memory (61 KB at D = 192, scalar loops dividing by
// D, two barriers) to score one key. Here:
//  - a block packs 8 (b, s, h) rows, one a warp: (160, 1, 4, 192) is 80
//    blocks; no shared memory and no block barrier;
//  - a warp reads q's row and then its keys' K and V rows straight from
//    device memory, lane l holding dims 128 i + 4 l .. + 3 of chunk i
//    (float4 loads when D % 4 == 0 and the rows are 16-byte aligned,
//    element loads otherwise); query heads that share a KV head meet in L2;
//  - ROW_KEYS keys at a time: each lane's partial dot product (one fma
//    chain over its dims, chunk by chunk) is summed by a xor butterfly, so
//    every lane holds the same score; the running max m and sum l are
//    warp-uniform scalars (expf of the q-scaled scores, as the Pallas
//    kernel's exp), and the output stays in registers, 4 ceil(D / 128) a
//    lane.
//
// fp32, the rest, any D <= 1024: flash_tf32x3_kernel (route 1,
// "cuda_tf32x3"), the bf16 cluster kernel's structure on TF32 tensor cores
// in the 3xTF32 split. Bound at the LLaVA adapter's (4, 640, 8, 896),
// causal: operations (4 B H D S (S + 1) / 2 = 23.5 GFLOP; three TF32
// products each at 494.7 TFLOP/s: 0.14 ms, against 0.35 ms of fp32 at 67
// TFLOP/s and 0.088 ms of bytes). The first design scored one key a lane
// with a serial D-long dot product from shared memory (two loads an fma),
// left lanes 16-31 idle above D = 512 and took 172-192 KB of shared memory
// (one 4-warp block an SM), re-staging K and V with scalar loads for every
// 16-row q-block. Here:
//  - mma.sync.m16n8k8 with TF32 operands and fp32 accumulators (mma.cuh):
//    each fp32 operand x enters as hi = tf32_rna(x) and lo = tf32_rna(x -
//    hi), and each product as lo hi + hi lo + hi hi in that order, for
//    Q K^T and for P V, so fp32 callers keep 1e-5 (about 22 bits of each
//    operand where one TF32 pass keeps 11). The split is made as a
//    fragment is read, so shared memory holds fp32 once.
//  - A tensor-core accumulation chain is X_CHAIN k8 steps long (32 dims
//    of a score, one key tile of P V), started from zero; the chains are
//    added in fp32 on the CUDA cores (O as O corr + P V). Chained over a
//    whole slice and all of Skv, the tensor cores' own adds (which do not
//    round to nearest) left Whisper's cross-attention to 1500 keys 1.4e-5
//    of the largest magnitude off the plain version on the card.
//  - 64-row q-tiles, 4 warps x 16 rows; 32-key K/V tiles in a 2-stage
//    cp.async ring; the ceil(Dp / 128) D-slice blocks of a q-tile (Dp = D
//    rounded up to 8) form one cluster whose partial scores are summed in
//    rank order through distributed shared memory, a reduce-scatter then
//    an all-gather, as flash_tc_cluster_kernel does: every rank holds the
//    same scores, bit for bit, and two calls are bitwise equal. At D <=
//    128 the cluster is one block and nothing is exchanged.
//  - P's C fragment becomes the A fragment of P V in registers with the
//    keys of each k8 block taken in the order 0 2 4 6 1 3 5 7 (a lane holds
//    keys 2c and 2c + 1 of its rows, where m16n8k8's A wants k = c and c +
//    4); V's B fragment reads its rows in the same order, which leaves the
//    sum over keys unchanged.
//  - Tiles are fp32 [rows][128] without padding, each row's 16-byte chunk
//    j stored at chunk j ^ (row % 8): the Q and K fragments' 8 rows x 4
//    columns and V's permuted 8 x (2 x 4) reads fall in 32 distinct banks.
//    Q 32 KB, the ring 64 KB, partials and sums 16 KB: 112 KB, two blocks
//    an SM.
//
// fp32, the first design: flash_kernel (flash_attention_launch, the
// wrapper's force="cuda_v1"), kept only for the card's A/B against the two
// routes above; the wrapper never picks it. Grid (B*H, ceil(S/16)), 4
// warps of 4 query rows each, DPL = 8/16/32 output dims a lane; BK-key
// tiles of K and V staged in shared memory with K rows padded to D + 1,
// lane j scoring key j and p_j broadcast by shuffle into the P.V update;
// BK = 32 up to D = 512 (164 KB), above it 16 (192 KB at D = 1024).
//
// The gradient is not a kernel yet: the port's autograd.Function
// (kernels/ops.py) recomputes P in PyTorch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NWARP = 4;
constexpr int BQ = 16;                  // query rows per block
constexpr int RPW = BQ / NWARP;         // rows per warp
constexpr int BK = 32;                  // keys per tile (one per lane)
constexpr int MAXD = 1024;
constexpr int MAXD_FAST = 512;          // the largest D of the BK = 32 path
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// The cluster barrier in two halves (PTX barrier.cluster): arrive with
// release semantics, then wait with acquire semantics.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}


__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

size_t smem_bytes(int D, int bk) {
  return sizeof(float) * ((size_t)BQ * D + (size_t)bk * (D + 1) + (size_t)bk * D);
}

// q (B, S, H, D); k, v (B, Skv, Hkv, D) -> o (B, S, H, D)
// DPL: output dims per lane, so D <= 32 * DPL; BKT keys a tile (<= 32)
template <int DPL, int BKT>
__global__ void __launch_bounds__(NWARP * 32)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int S, int Skv,
             int H, int Hkv, int D, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* qs = smem;                      // BQ x D
  float* ks = qs + BQ * D;               // BKT x (D + 1)
  float* vs = ks + BKT * (D + 1);        // BKT x D
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, qp = q0 + r;
    qs[i] = qp < S ? q[(((size_t)b * S + qp) * H + h) * D + d] * scale
                   : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  // keys this block can see: causal stops at its last row, a window
  // starts window-1 before its first row
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BKT) * BKT : 0;

  for (int kt = k_begin; kt < k_end; kt += BKT) {
    __syncthreads();   // the previous tile is consumed
    for (int i = threadIdx.x; i < BKT * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D, kp = kt + j;
      const size_t off = (((size_t)b * Skv + kp) * Hkv + hk) * D + d;
      ks[j * (D + 1) + d] = kp < Skv ? k[off] : 0.f;
      vs[j * D + d] = kp < Skv ? v[off] : 0.f;
    }
    __syncthreads();
    const int kp = kt + lane;
    const bool scores = lane < BKT;      // lanes past the tile score none
    const int nk = min(BKT, Skv - kt);   // keys of this tile that exist
    const float* krow = ks + (scores ? lane : 0) * (D + 1);
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int qr = warp * RPW + rr, qp = q0 + qr;
      if (qp >= S) continue;             // warp-uniform: the whole row
      const float* qrow = qs + qr * D;
      // four partial sums break the FMA dependency chain over D
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      if (scores) {
        int d = 0;
        for (; d + 4 <= D; d += 4) {
          s0 = fmaf(qrow[d], krow[d], s0);
          s1 = fmaf(qrow[d + 1], krow[d + 1], s1);
          s2 = fmaf(qrow[d + 2], krow[d + 2], s2);
          s3 = fmaf(qrow[d + 3], krow[d + 3], s3);
        }
        for (; d < D; ++d) s0 = fmaf(qrow[d], krow[d], s0);
      }
      float sc = (s0 + s1) + (s2 + s3);
      bool valid = scores && kp < Skv;
      if (causal) valid = valid && qp >= kp;
      if (window > 0) valid = valid && (qp - kp) < window;
      sc = valid ? sc : NEG_INF;
      const float m_new = fmaxf(m[rr], warp_max(sc));
      const float p = valid ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[rr][i] *= corr;
      for (int j = 0; j < nk; ++j) {
        const float pj = __shfl_sync(FULL, p, j);
        const float* vrow = vs + j * D;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[rr][i] = fmaf(pj, vrow[d], acc[rr][i]);
        }
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int qp = q0 + warp * RPW + rr;
    if (qp >= S) continue;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
    float* orow = o + (((size_t)b * S + qp) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = acc[rr][i] * inv;
    }
  }
}

template <int DPL, int BKT>
cudaError_t launch_dpl(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int Skv, int H, int Hkv, int D,
                       float scale, int causal, int window,
                       cudaStream_t stream) {
  const size_t bytes = smem_bytes(D, BKT);
  static bool attr_set = false;   // the 32 * DPL bound: one setting is enough
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<DPL, BKT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(32 * DPL, BKT));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_kernel<DPL, BKT><<<grid, NWARP * 32, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, Skv,
      H, Hkv, D, scale, causal, window);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int Skv, int H, int Hkv, int D,
                       float scale, int causal, int window,
                       cudaStream_t stream) {
  if (D <= 256)
    return launch_dpl<8, BK>(q, k, v, o, B, S, Skv, H, Hkv, D, scale,
                             causal, window, stream);
  if (D <= MAXD_FAST)
    return launch_dpl<16, BK>(q, k, v, o, B, S, Skv, H, Hkv, D, scale,
                              causal, window, stream);
  return launch_dpl<32, 16>(q, k, v, o, B, S, Skv, H, Hkv, D, scale,
                            causal, window, stream);
}

// ---- bf16: tensor cores ------------------------------------------------
namespace ft {

constexpr int NWT = 4;                  // warps per block, 16 query rows each
constexpr int BQT = 16 * NWT;           // query rows per block
constexpr int BKV = 32;                 // keys per staged tile
constexpr int DV = 128;                 // output columns per block
constexpr int LDV = DV + 8;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int S, Skv, H, Hkv, D, Dp, nsl, causal, window;
  float scale_log2;                     // log2(e) / sqrt(D)
  bool vec;                             // 16-byte cp.async (D % 8 == 0)
};

size_t smem_bytes(int Dp, int kst) {    // Q, kst K and kst V tiles, bf16
  return 2 * ((size_t)(BQT + kst * BKV) * (Dp + 8) + kst * (size_t)BKV * LDV);
}

// Rows [0, rows) x columns [0, cols) of a tile whose row i starts at
// src + i * rstride; rows >= rvalid and columns >= cvalid are zero.
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int ld,
                                      const __nv_bfloat16* src,
                                      size_t rstride, int rows, int rvalid,
                                      int cols, int cvalid, bool vec) {
  if (vec) {                            // cvalid % 8 == 0
    const int cc = cols / 8;
    for (int i = threadIdx.x; i < rows * cc; i += NWT * 32) {
      const int r = i / cc, c = (i % cc) * 8;
      const bool ok = r < rvalid && c < cvalid;
      tc::cp_async16(dst + r * ld + c, ok ? src + r * rstride + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += NWT * 32) {
      const int r = i / cols, c = i % cols;
      dst[r * ld + c] = (r < rvalid && c < cvalid) ? src[r * rstride + c]
                                                   : __float2bfloat16(0.f);
    }
  }
}

// KST K/V stages: 2 (the next tile loads during this one's math) or 1
// (each tile loads after the last is consumed; for D > 512)
template <int KST>
__global__ void __launch_bounds__(NWT * 32) flash_tc_kernel(const Args p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int ld = p.Dp + 8;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BQT * ld;    // [KST][BKV][ld]
  __nv_bfloat16* vs = ks + KST * BKV * ld;  // [KST][BKV][LDV]
  const int sl = blockIdx.x % p.nsl, bh = blockIdx.x / p.nsl;
  const int b = bh / p.H, h = bh % p.H, hk = h / (p.H / p.Hkv);
  const int d0 = sl * DV, dvp = min(DV, p.Dp - d0);
  const int q0 = blockIdx.y * BQT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int wq0 = q0 + warp * 16;       // this warp's first query row

  // keys this block can see: causal stops at its last row, a window
  // starts window-1 before its first row
  const int q_last = min(q0 + BQT, p.S) - 1;
  const int k_end = p.causal ? min(p.Skv, q_last + 1) : p.Skv;
  const int k_begin =
      p.window > 0 ? (max(0, q0 - p.window + 1) / BKV) * BKV : 0;
  const int ntile = k_end > k_begin ? (k_end - k_begin + BKV - 1) / BKV : 0;

  const size_t qstride = (size_t)p.H * p.D, kstride = (size_t)p.Hkv * p.D;
  const __nv_bfloat16* kbase = p.k + ((size_t)b * p.Skv * p.Hkv + hk) * p.D;
  const __nv_bfloat16* vbase = p.v + ((size_t)b * p.Skv * p.Hkv + hk) * p.D;

  float o[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  if (ntile > 0) {
    stage(qs, ld, p.q + (((size_t)b * p.S + q0) * p.H + h) * p.D, qstride,
          BQT, p.S - q0, p.Dp, p.D, p.vec);
    stage(ks, ld, kbase + (size_t)k_begin * kstride, kstride, BKV,
          p.Skv - k_begin, p.Dp, p.D, p.vec);
    stage(vs, LDV, vbase + (size_t)k_begin * kstride + d0, kstride, BKV,
          p.Skv - k_begin, dvp, p.D - d0, p.vec);
    tc::cp_commit();
  }
  for (int t = 0; t < ntile; ++t) {
    const int kt = k_begin + t * BKV;
    if (KST == 1) {                     // tile t loads now (tile 0: above)
      if (t > 0) {
        stage(ks, ld, kbase + (size_t)kt * kstride, kstride, BKV,
              p.Skv - kt, p.Dp, p.D, p.vec);
        stage(vs, LDV, vbase + (size_t)kt * kstride + d0, kstride, BKV,
              p.Skv - kt, dvp, p.D - d0, p.vec);
        tc::cp_commit();
      }
      tc::cp_wait<0>();
    } else if (t + 1 < ntile) {         // the next tile loads meanwhile
      const int kn = kt + BKV, sn = (t + 1) & 1;
      stage(ks + sn * BKV * ld, ld, kbase + (size_t)kn * kstride, kstride,
            BKV, p.Skv - kn, p.Dp, p.D, p.vec);
      stage(vs + sn * BKV * LDV, LDV, vbase + (size_t)kn * kstride + d0,
            kstride, BKV, p.Skv - kn, dvp, p.D - d0, p.vec);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();                    // tile t is in
    const bool active =
        wq0 < p.S && !(p.causal && kt > min(wq0 + 15, p.S - 1)) &&
        !(p.window > 0 && kt + BKV - 1 < wq0 - p.window + 1);
    if (active) {                       // warp-uniform
      const int st = KST == 1 ? 0 : (t & 1);
      const __nv_bfloat16* kst = ks + st * BKV * ld;
      const __nv_bfloat16* vst = vs + st * BKV * LDV;
      float sc[BKV / 8][4];
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll 4
      for (int d = 0; d < p.Dp; d += 16) {   // S = Q K^T over all of D
        uint32_t qa[4];
        tc::frag_a(qa, qs, ld, warp * 16, d, lane);
#pragma unroll
        for (int jj = 0; jj < BKV / 16; ++jj) {
          uint32_t kb[4];
          tc::frag_b_nk(kb, kst, ld, jj * 16, d, lane);
          tc::mma_bf16(sc[2 * jj], qa, kb[0], kb[1]);
          tc::mma_bf16(sc[2 * jj + 1], qa, kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // rows g and g + 8 of the warp
        const int qp = wq0 + g + 8 * hh;
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = kt + n * 8 + c2 + e;
            bool valid = kp < p.Skv;
            if (p.causal) valid = valid && qp >= kp;
            if (p.window > 0) valid = valid && (qp - kp) < p.window;
            const float v = valid ? sc[n][2 * hh + e] * p.scale_log2 : NEG_INF;
            sc[n][2 * hh + e] = v;
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        const float corr = exp2f(m[hh] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = sc[n][2 * hh + e];
            const float pv = v > NEG_INF ? exp2f(v - m_new) : 0.f;
            sc[n][2 * hh + e] = pv;
            rs += pv;
          }
        l[hh] = l[hh] * corr + rs;      // this lane's share of the row
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          o[j][2 * hh] *= corr;
          o[j][2 * hh + 1] *= corr;
        }
        m[hh] = m_new;
      }
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {   // O += P V, P as hi + lo
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tc::split_bf16(sc[2 * kk + e / 2][2 * (e % 2)],
                         sc[2 * kk + e / 2][2 * (e % 2) + 1], ph[e], pl[e]);
#pragma unroll
        for (int dj = 0; dj < DV / 16; ++dj) {
          if (dj * 16 >= dvp) break;
          uint32_t vb[4];
          tc::frag_b_kn(vb, vst, LDV, kk * 16, dj * 16, lane);
          tc::mma_bf16(o[2 * dj], ph, vb[0], vb[1]);
          tc::mma_bf16(o[2 * dj], pl, vb[0], vb[1]);
          tc::mma_bf16(o[2 * dj + 1], ph, vb[2], vb[3]);
          tc::mma_bf16(o[2 * dj + 1], pl, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();                    // tile t consumed
  }

  const bool pairs = (p.D & 1) == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(FULL, lt, 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int qp = wq0 + g + 8 * hh;
    if (qp >= p.S) continue;
    __nv_bfloat16* orow = p.o + (((size_t)b * p.S + qp) * p.H + h) * p.D;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int d = d0 + j * 8 + c2;
      if (j * 8 >= dvp) break;
      const float v0 = o[j][2 * hh] * inv, v1 = o[j][2 * hh + 1] * inv;
      if (pairs && d + 1 < p.D) {
        *reinterpret_cast<uint32_t*>(orow + d) = tc::pack_bf16(v0, v1);
      } else {
        if (d < p.D) orow[d] = __float2bfloat16(v0);
        if (d + 1 < p.D) orow[d + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int KST>
cudaError_t launch_tc(const Args& p, int B, int S, cudaStream_t stream) {
  static bool attr_set = false;         // sized for the largest D once
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<KST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(KST == 2 ? MAXD_FAST : MAXD, KST));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(B * p.H * p.nsl, (S + BQT - 1) / BQT);
  flash_tc_kernel<KST><<<grid, NWT * 32, smem_bytes(p.Dp, KST), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace ft

// ---- bf16, D > 512: the slice blocks of a q-tile as a cluster -----------
namespace fc {

using ft::BKV;
using ft::BQT;
using ft::DV;
using ft::LDV;
using ft::NWT;
constexpr int NS = 2;                   // K/V ring stages
constexpr int NT = NWT * 32;            // threads a block
constexpr int MIN_BLOCKS = 3;           // blocks an SM (registers <= 170)
constexpr int PF = BKV / 8 * 4;         // score floats a lane: 16
constexpr int MAX_CLUSTER = 8;          // ceil(1024 / 128)

struct Layout {
  static constexpr int Q = 0;                           // bf16 [BQT][LDV]
  static constexpr int K = Q + BQT * LDV * 2;           // bf16 [NS][BKV][LDV]
  static constexpr int V = K + NS * BKV * LDV * 2;      // bf16 [NS][BKV][LDV]
  static constexpr int PART = V + NS * BKV * LDV * 2;   // f32 [PF][NT]
  static constexpr int RED = PART + PF * NT * 4;        // f32 [PF][NT]
  static constexpr int BYTES = RED + PF * NT * 4;
  static_assert(K % 16 == 0 && V % 16 == 0 && PART % 16 == 0, "align");
};

// grid (nsl * q-tiles * B * H), clusters of (nsl, 1, 1): cluster c is
// q-tile (q-tiles - 1 - c % q-tiles) of (b, h) = c / q-tiles, so the
// clusters in flight share a few (b, h)'s K and V in L2 and the longest
// causal rows start first.
__global__ void __launch_bounds__(NT, MIN_BLOCKS) flash_tc_cluster_kernel(
    const ft::Args p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw + Layout::Q);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw + Layout::K);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem_raw + Layout::V);
  float* part = reinterpret_cast<float*>(smem_raw + Layout::PART);
  float* red = reinterpret_cast<float*>(smem_raw + Layout::RED);
  cg::cluster_group cluster = cg::this_cluster();
  const int sl = (int)cluster.block_rank();  // = blockIdx.x % nsl
  const int nqt = (p.S + BQT - 1) / BQT;
  const int c = (int)(blockIdx.x / p.nsl);
  const int bh = c / nqt;
  const int b = bh / p.H, h = bh % p.H, hk = h / (p.H / p.Hkv);
  const int d0 = sl * DV, dvp = min(DV, p.Dp - d0);
  const int q0 = (nqt - 1 - c % nqt) * BQT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int wq0 = q0 + warp * 16;       // this warp's first query row

  const int q_last = min(q0 + BQT, p.S) - 1;
  const int k_end = p.causal ? min(p.Skv, q_last + 1) : p.Skv;
  const int k_begin =
      p.window > 0 ? (max(0, q0 - p.window + 1) / BKV) * BKV : 0;
  const int ntile = k_end > k_begin ? (k_end - k_begin + BKV - 1) / BKV : 0;

  const size_t qstride = (size_t)p.H * p.D, kstride = (size_t)p.Hkv * p.D;
  const __nv_bfloat16* kbase =
      p.k + ((size_t)b * p.Skv * p.Hkv + hk) * p.D + d0;
  const __nv_bfloat16* vbase =
      p.v + ((size_t)b * p.Skv * p.Hkv + hk) * p.D + d0;
  auto stage_kv = [&](int slot, int kt) {
    ft::stage(ks + slot * BKV * LDV, LDV, kbase + (size_t)kt * kstride,
              kstride, BKV, p.Skv - kt, dvp, p.D - d0, p.vec);
    ft::stage(vs + slot * BKV * LDV, LDV, vbase + (size_t)kt * kstride,
              kstride, BKV, p.Skv - kt, dvp, p.D - d0, p.vec);
  };

  float o[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  if (ntile > 0) {                      // Q's slice rides with tile 0
    ft::stage(qs, LDV, p.q + (((size_t)b * p.S + q0) * p.H + h) * p.D + d0,
              qstride, BQT, p.S - q0, dvp, p.D - d0, p.vec);
  }
#pragma unroll
  for (int u = 0; u < NS - 1; ++u) {
    if (u < ntile) stage_kv(u, k_begin + u * BKV);
    tc::cp_commit();                    // one group a tile, empty or not
  }
  for (int t = 0; t < ntile; ++t) {
    const int kt = k_begin + t * BKV;
    tc::cp_wait<NS - 2>();              // tile t (and Q) have landed
    __syncthreads();                    // tile t - 1 consumed by every warp
    if (t + NS - 1 < ntile) stage_kv((t + NS - 1) % NS, kt + (NS - 1) * BKV);
    tc::cp_commit();
    const bool active =
        wq0 < p.S && !(p.causal && kt > min(wq0 + 15, p.S - 1)) &&
        !(p.window > 0 && kt + BKV - 1 < wq0 - p.window + 1);
    const __nv_bfloat16* kst = ks + (t % NS) * BKV * LDV;
    const __nv_bfloat16* vst = vs + (t % NS) * BKV * LDV;
    float sc[BKV / 8][4];
    if (active) {                       // warp-uniform
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
      for (int d = 0; d < dvp; d += 16) {  // this slice's Q_r K_r^T
        uint32_t qa[4];
        tc::frag_a(qa, qs, LDV, warp * 16, d, lane);
#pragma unroll
        for (int jj = 0; jj < BKV / 16; ++jj) {
          uint32_t kb[4];
          tc::frag_b_nk(kb, kst, LDV, jj * 16, d, lane);
          tc::mma_bf16(sc[2 * jj], qa, kb[0], kb[1]);
          tc::mma_bf16(sc[2 * jj + 1], qa, kb[2], kb[3]);
        }
      }
      // value f of every thread's fragment at part[f][tid]: a warp's
      // accesses of one f are 32 consecutive words (no bank conflict)
#pragma unroll
      for (int f = 0; f < PF; ++f) part[f * NT + tid] = sc[f / 4][f % 4];
    }
    cluster_arrive();                   // every rank's partials are out
    cluster_wait();
    if (active) {
      // reduce: rank r owns values f = r, r + nsl, ...: the ranks'
      // partials of f added in rank order into red[f]
      for (int f = sl; f < PF; f += p.nsl) {
        float v[MAX_CLUSTER];
#pragma unroll
        for (int r = 0; r < MAX_CLUSTER; ++r)
          if (r < p.nsl) v[r] = *cluster.map_shared_rank(part + f * NT + tid, r);
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < MAX_CLUSTER; ++r)
          if (r < p.nsl) acc += v[r];
        red[f * NT + tid] = acc;
      }
    }
    cluster_arrive();                   // every sum is in its owner
    cluster_wait();
    if (active) {
      // gather: S, bit for bit the same in every rank
#pragma unroll
      for (int f = 0; f < PF; ++f)
        sc[f / 4][f % 4] = *cluster.map_shared_rank(red + f * NT + tid,
                                                    f % p.nsl);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // rows g and g + 8 of the warp
        const int qp = wq0 + g + 8 * hh;
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = kt + n * 8 + c2 + e;
            bool valid = kp < p.Skv;
            if (p.causal) valid = valid && qp >= kp;
            if (p.window > 0) valid = valid && (qp - kp) < p.window;
            const float v = valid ? sc[n][2 * hh + e] * p.scale_log2 : NEG_INF;
            sc[n][2 * hh + e] = v;
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        const float corr = exp2f(m[hh] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = sc[n][2 * hh + e];
            const float pv = v > NEG_INF ? exp2f(v - m_new) : 0.f;
            sc[n][2 * hh + e] = pv;
            rs += pv;
          }
        l[hh] = l[hh] * corr + rs;      // this lane's share of the row
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          o[j][2 * hh] *= corr;
          o[j][2 * hh + 1] *= corr;
        }
        m[hh] = m_new;
      }
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {   // O += P V, P as hi + lo
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tc::split_bf16(sc[2 * kk + e / 2][2 * (e % 2)],
                         sc[2 * kk + e / 2][2 * (e % 2) + 1], ph[e], pl[e]);
#pragma unroll
        for (int dj = 0; dj < DV / 16; ++dj) {
          if (dj * 16 >= dvp) break;
          uint32_t vb[4];
          tc::frag_b_kn(vb, vst, LDV, kk * 16, dj * 16, lane);
          tc::mma_bf16(o[2 * dj], ph, vb[0], vb[1]);
          tc::mma_bf16(o[2 * dj], pl, vb[0], vb[1]);
          tc::mma_bf16(o[2 * dj + 1], ph, vb[2], vb[3]);
          tc::mma_bf16(o[2 * dj + 1], pl, vb[2], vb[3]);
        }
      }
    }
  }
  tc::cp_wait<0>();                     // no copy outlives the block
  if (ntile > 0) {                      // the others have read our sums
    cluster_arrive();
    cluster_wait();
  }

  const bool pairs = (p.D & 1) == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(FULL, lt, 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int qp = wq0 + g + 8 * hh;
    if (qp >= p.S) continue;
    __nv_bfloat16* orow = p.o + (((size_t)b * p.S + qp) * p.H + h) * p.D;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int d = d0 + j * 8 + c2;
      if (j * 8 >= dvp) break;
      const float v0 = o[j][2 * hh] * inv, v1 = o[j][2 * hh + 1] * inv;
      if (pairs && d + 1 < p.D) {
        *reinterpret_cast<uint32_t*>(orow + d) = tc::pack_bf16(v0, v1);
      } else {
        if (d < p.D) orow[d] = __float2bfloat16(v0);
        if (d + 1 < p.D) orow[d + 1] = __float2bfloat16(v1);
      }
    }
  }
}

cudaError_t launch(const ft::Args& p, int B, int S, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tc_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout::BYTES);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nsl * ((S + BQT - 1) / BQT) * B * p.H);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = Layout::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nsl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_tc_cluster_kernel, p);
}

}  // namespace fc

// ---- fp32, short S: one warp a query row --------------------------------
namespace fr {

constexpr int ROW_WARPS = 8;            // query rows a block, one a warp
constexpr int ROW_KEYS = 4;             // keys scored together
constexpr int ROW_CHUNK = 128;          // dims a chunk: a float4 a lane

// Lane's dims 128 i + 4 lane .. + 3 of chunk i of a D-long row; dims past
// D read as 0.
template <int NC>
__device__ __forceinline__ void load_row(float (&r)[NC][4],
                                         const float* __restrict__ src, int D,
                                         int lane, int vec) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int d = i * ROW_CHUNK + 4 * lane;
    if (vec) {                          // D % 4 == 0: a float4 is whole
      const float4 t = d < D ? __ldg(reinterpret_cast<const float4*>(src + d))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      r[i][0] = t.x; r[i][1] = t.y; r[i][2] = t.z; r[i][3] = t.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) r[i][c] = d + c < D ? __ldg(src + d + c) : 0.f;
    }
  }
}

// q, o: row r = (b * S + s) * H + h at r * D; k, v (B, Skv, Hkv, D).
// NC chunks of ROW_CHUNK dims a row (D <= ROW_CHUNK * NC).
template <int NC>
__global__ void __launch_bounds__(ROW_WARPS * 32)
flash_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  int rows, int S, int Skv, int H, int Hkv, int D,
                  float scale, int causal, int window, int vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;              // the whole warp; no barrier follows
  const int h = row % H, s = (row / H) % S, b = row / H / S;
  const int hk = h / (H / Hkv);
  // the keys row s sees: [kb, ke)
  const int ke = causal ? min(Skv, s + 1) : Skv;
  const int kb = window > 0 ? max(0, s - window + 1) : 0;
  const size_t kstride = (size_t)Hkv * D;
  const float* kbase = k + ((size_t)b * Skv * Hkv + hk) * D;
  const float* vbase = v + ((size_t)b * Skv * Hkv + hk) * D;

  float qr[NC][4], acc[NC][4];
  load_row<NC>(qr, q + (size_t)row * D, D, lane, vec);
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      qr[i][c] *= scale;
      acc[i][c] = 0.f;
    }
  float m = NEG_INF, l = 0.f;           // warp-uniform
  for (int k0 = kb; k0 < ke; k0 += ROW_KEYS) {
    const int nk = min(ROW_KEYS, ke - k0);
    float sc[ROW_KEYS];
#pragma unroll
    for (int j = 0; j < ROW_KEYS; ++j) {
      sc[j] = NEG_INF;
      if (j < nk) {
        float kr[NC][4];
        load_row<NC>(kr, kbase + (size_t)(k0 + j) * kstride, D, lane, vec);
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < NC; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) part = fmaf(qr[i][c], kr[i][c], part);
        sc[j] = warp_sum(part);         // every lane: the same sum
      }
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < ROW_KEYS; ++j) mx = fmaxf(mx, sc[j]);
    const float corr = expf(m - mx);
    float p[ROW_KEYS], ps = 0.f;
#pragma unroll
    for (int j = 0; j < ROW_KEYS; ++j) {
      p[j] = j < nk ? expf(sc[j] - mx) : 0.f;
      ps += p[j];
    }
    l = l * corr + ps;
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= corr;
#pragma unroll
    for (int j = 0; j < ROW_KEYS; ++j) {
      if (j < nk) {
        float vr[NC][4];
        load_row<NC>(vr, vbase + (size_t)(k0 + j) * kstride, D, lane, vec);
#pragma unroll
        for (int i = 0; i < NC; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(p[j], vr[i][c], acc[i][c]);
      }
    }
    m = mx;
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  float* orow = o + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int d = i * ROW_CHUNK + 4 * lane;
    if (vec) {
      if (d < D)
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv,
                        acc[i][3] * inv);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (d + c < D) orow[d + c] = acc[i][c] * inv;
    }
  }
}

template <int NC>
cudaError_t launch_rows(const float* q, const float* k, const float* v,
                        float* o, int B, int S, int Skv, int H, int Hkv,
                        int D, float scale, int causal, int window, int vec,
                        cudaStream_t stream) {
  const int rows = B * S * H;
  flash_rows_kernel<NC><<<(rows + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32,
                          0, stream>>>(q, k, v, o, rows, S, Skv, H, Hkv, D,
                                       scale, causal, window, vec);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Skv, int H, int Hkv, int D, float scale,
                   int causal, int window, cudaStream_t stream) {
  const int vec = D % 4 == 0 &&
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 == 0;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v;
  float* of = (float*)o;
  if (D <= ROW_CHUNK)
    return launch_rows<1>(qf, kf, vf, of, B, S, Skv, H, Hkv, D, scale, causal,
                          window, vec, stream);
  if (D <= 2 * ROW_CHUNK)
    return launch_rows<2>(qf, kf, vf, of, B, S, Skv, H, Hkv, D, scale, causal,
                          window, vec, stream);
  if (D <= 4 * ROW_CHUNK)
    return launch_rows<4>(qf, kf, vf, of, B, S, Skv, H, Hkv, D, scale, causal,
                          window, vec, stream);
  return launch_rows<8>(qf, kf, vf, of, B, S, Skv, H, Hkv, D, scale, causal,
                        window, vec, stream);
}

}  // namespace fr

// ---- fp32, the rest: 3xTF32 tensor cores, the D-slices a cluster --------
namespace fx {

using ft::BKV;
using ft::BQT;
using ft::DV;
using ft::NWT;
using fc::NT;
using fc::PF;
constexpr int X_STAGES = 2;             // K/V ring stages
constexpr int X_MIN_BLOCKS = 2;         // blocks an SM (shared memory)
constexpr int X_KSTEP = 8;              // m16n8k8: dims (keys) an mma
constexpr int X_CHAIN = 4;              // k8 steps a tensor-core chain

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int S, Skv, H, Hkv, D, Dp, nsl, causal, window;
  float scale_log2;                     // log2(e) / sqrt(D)
  bool vec;                             // 16-byte cp.async (D % 4 == 0)
};

// byte offsets; Q, K and V tiles are fp32 [rows][DV], swizzled (sw)
struct Layout {
  static constexpr int Q = 0;                           // [BQT][DV]
  static constexpr int K = Q + BQT * DV * 4;            // [NS][BKV][DV]
  static constexpr int V = K + X_STAGES * BKV * DV * 4; // [NS][BKV][DV]
  static constexpr int PART = V + X_STAGES * BKV * DV * 4;  // [PF][NT]
  static constexpr int RED = PART + PF * NT * 4;        // [PF][NT]
  static constexpr int BYTES = RED + PF * NT * 4;
  static_assert(BYTES * X_MIN_BLOCKS + 2048 <= 233472, "two blocks an SM");
};

// Element (r, c) of a [rows][DV] fp32 tile: the 16-byte chunk c / 4 of
// row r sits at chunk (c / 4) ^ (r % 8) of the row.
__device__ __forceinline__ int sw(int r, int c) {
  return r * DV + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}

// Rows [0, rows) x dims [0, cols) (cols % 8 == 0) of a tile whose row i
// starts at src + i * rstride, into a swizzled tile; rows >= rvalid and
// dims >= cvalid are zero (cp.async's zero fill).
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      size_t rstride, int rows, int rvalid,
                                      int cols, int cvalid, bool vec) {
  if (vec) {                            // cvalid % 4 == 0
    const int cc = cols >> 2;
    for (int i = threadIdx.x; i < rows * cc; i += NT) {
      const int r = i / cc, c = i - r * cc;
      const bool ok = r < rvalid && 4 * c < cvalid;
      tc::cp_async16(dst + r * DV + ((c ^ (r & 7)) << 2),
                     ok ? src + r * rstride + 4 * c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += NT) {
      const int r = i / cols, c = i - r * cols;
      const bool ok = r < rvalid && c < cvalid;
      tc::cp_async4(dst + sw(r, c), ok ? src + r * rstride + c : src, ok);
    }
  }
}

// grid (nsl * q-tiles * B * H), clusters of (nsl, 1, 1), ordered as
// flash_tc_cluster_kernel's
__global__ void __launch_bounds__(NT, X_MIN_BLOCKS)
flash_tf32x3_kernel(const Args p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw + Layout::Q);
  float* ks = reinterpret_cast<float*>(smem_raw + Layout::K);
  float* vs = reinterpret_cast<float*>(smem_raw + Layout::V);
  float* part = reinterpret_cast<float*>(smem_raw + Layout::PART);
  float* red = reinterpret_cast<float*>(smem_raw + Layout::RED);
  cg::cluster_group cluster = cg::this_cluster();
  const int sl = (int)cluster.block_rank();  // = blockIdx.x % nsl
  const int nqt = (p.S + BQT - 1) / BQT;
  const int cid = (int)(blockIdx.x / p.nsl);
  const int bh = cid / nqt;
  const int b = bh / p.H, h = bh % p.H, hk = h / (p.H / p.Hkv);
  const int d0 = sl * DV, dvp = min(DV, p.Dp - d0);
  const int q0 = (nqt - 1 - cid % nqt) * BQT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3, c2 = 2 * c4;
  const int r0 = warp * 16;             // this warp's first row of the tile
  const int wq0 = q0 + r0;

  const int q_last = min(q0 + BQT, p.S) - 1;
  const int k_end = p.causal ? min(p.Skv, q_last + 1) : p.Skv;
  const int k_begin =
      p.window > 0 ? (max(0, q0 - p.window + 1) / BKV) * BKV : 0;
  const int ntile = k_end > k_begin ? (k_end - k_begin + BKV - 1) / BKV : 0;

  const size_t qstride = (size_t)p.H * p.D, kstride = (size_t)p.Hkv * p.D;
  const float* kbase = p.k + ((size_t)b * p.Skv * p.Hkv + hk) * p.D + d0;
  const float* vbase = p.v + ((size_t)b * p.Skv * p.Hkv + hk) * p.D + d0;
  auto stage_kv = [&](int slot, int kt) {
    stage(ks + slot * BKV * DV, kbase + (size_t)kt * kstride, kstride, BKV,
          p.Skv - kt, dvp, p.D - d0, p.vec);
    stage(vs + slot * BKV * DV, vbase + (size_t)kt * kstride, kstride, BKV,
          p.Skv - kt, dvp, p.D - d0, p.vec);
  };

  float o[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, cr[2];

  if (ntile > 0) {                      // Q's slice rides with tile 0
    stage(qs, p.q + (((size_t)b * p.S + q0) * p.H + h) * p.D + d0, qstride,
          BQT, p.S - q0, dvp, p.D - d0, p.vec);
  }
#pragma unroll
  for (int u = 0; u < X_STAGES - 1; ++u) {
    if (u < ntile) stage_kv(u, k_begin + u * BKV);
    tc::cp_commit();                    // one group a tile, empty or not
  }
  for (int t = 0; t < ntile; ++t) {
    const int kt = k_begin + t * BKV;
    tc::cp_wait<X_STAGES - 2>();        // tile t (and Q) have landed
    __syncthreads();                    // tile t - 1 consumed by every warp
    if (t + X_STAGES - 1 < ntile)
      stage_kv((t + X_STAGES - 1) % X_STAGES, kt + (X_STAGES - 1) * BKV);
    tc::cp_commit();
    const bool active =
        wq0 < p.S && !(p.causal && kt > min(wq0 + 15, p.S - 1)) &&
        !(p.window > 0 && kt + BKV - 1 < wq0 - p.window + 1);
    const float* kst = ks + (t % X_STAGES) * BKV * DV;
    const float* vst = vs + (t % X_STAGES) * BKV * DV;
    float sc[BKV / 8][4];
    if (active) {                       // warp-uniform
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
      // this slice's Q_r K_r^T, X_CHAIN k8 steps a chain on the tensor
      // cores, the chains added in fp32
      for (int d0c = 0; d0c < dvp; d0c += X_CHAIN * X_KSTEP) {
        float cs[BKV / 8][4];
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) cs[n][e] = 0.f;
#pragma unroll
        for (int dc = 0; dc < X_CHAIN * X_KSTEP; dc += X_KSTEP) {
          const int d = d0c + dc;
          if (d >= dvp) break;
          uint32_t qh[4], ql[4];
          tc::split_tf32(qs[sw(r0 + g, d + c4)], qh[0], ql[0]);
          tc::split_tf32(qs[sw(r0 + g + 8, d + c4)], qh[1], ql[1]);
          tc::split_tf32(qs[sw(r0 + g, d + c4 + 4)], qh[2], ql[2]);
          tc::split_tf32(qs[sw(r0 + g + 8, d + c4 + 4)], qh[3], ql[3]);
#pragma unroll
          for (int n = 0; n < BKV / 8; ++n) {
            uint32_t kh[2], kl[2];
            tc::split_tf32(kst[sw(n * 8 + g, d + c4)], kh[0], kl[0]);
            tc::split_tf32(kst[sw(n * 8 + g, d + c4 + 4)], kh[1], kl[1]);
            tc::mma_tf32(cs[n], ql, kh);
            tc::mma_tf32(cs[n], qh, kl);
            tc::mma_tf32(cs[n], qh, kh);
          }
        }
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] += cs[n][e];
      }
      if (p.nsl > 1) {
#pragma unroll
        for (int f = 0; f < PF; ++f) part[f * NT + tid] = sc[f / 4][f % 4];
      }
    }
    if (p.nsl > 1) {                    // uniform over the grid
      cluster_arrive();                 // every rank's partials are out
      cluster_wait();
      if (active) {
        // rank r owns values f = r, r + nsl, ...: the ranks' partials of
        // f added in rank order into red[f]
        for (int f = sl; f < PF; f += p.nsl) {
          float v[fc::MAX_CLUSTER];
#pragma unroll
          for (int r = 0; r < fc::MAX_CLUSTER; ++r)
            if (r < p.nsl) v[r] = *cluster.map_shared_rank(part + f * NT + tid, r);
          float acc = 0.f;
#pragma unroll
          for (int r = 0; r < fc::MAX_CLUSTER; ++r)
            if (r < p.nsl) acc += v[r];
          red[f * NT + tid] = acc;
        }
      }
      cluster_arrive();                 // every sum is in its owner
      cluster_wait();
      if (active) {
#pragma unroll
        for (int f = 0; f < PF; ++f)
          sc[f / 4][f % 4] = *cluster.map_shared_rank(red + f * NT + tid,
                                                      f % p.nsl);
      }
    }
    if (active) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // rows g and g + 8 of the warp
        const int qp = wq0 + g + 8 * hh;
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = kt + n * 8 + c2 + e;
            bool valid = kp < p.Skv;
            if (p.causal) valid = valid && qp >= kp;
            if (p.window > 0) valid = valid && (qp - kp) < p.window;
            const float v = valid ? sc[n][2 * hh + e] * p.scale_log2 : NEG_INF;
            sc[n][2 * hh + e] = v;
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        const float corr = exp2f(m[hh] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = sc[n][2 * hh + e];
            const float pv = v > NEG_INF ? exp2f(v - m_new) : 0.f;
            sc[n][2 * hh + e] = pv;
            rs += pv;
          }
        l[hh] = l[hh] * corr + rs;      // this lane's share of the row
        cr[hh] = corr;
        m[hh] = m_new;
      }
      // P as TF32 hi + lo, keys 0 2 4 6 1 3 5 7 of each k8 block
      uint32_t ph[BKV / 8][4], pl[BKV / 8][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 8; ++kk) {
        tc::split_tf32(sc[kk][0], ph[kk][0], pl[kk][0]);  // (g, key 2c)
        tc::split_tf32(sc[kk][2], ph[kk][1], pl[kk][1]);  // (g + 8, key 2c)
        tc::split_tf32(sc[kk][1], ph[kk][2], pl[kk][2]);  // (g, key 2c + 1)
        tc::split_tf32(sc[kk][3], ph[kk][3], pl[kk][3]);  // (g + 8, 2c + 1)
      }
      // O = O corr + P V: the tile's P V one chain on the tensor cores
      // from zero, added to the rescaled O in fp32
#pragma unroll
      for (int dj = 0; dj < DV / 8; ++dj) {
        if (dj * 8 >= dvp) break;
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < BKV / 8; ++kk) {
          uint32_t vh[2], vl[2];
          tc::split_tf32(vst[sw(kk * 8 + c2, dj * 8 + g)], vh[0], vl[0]);
          tc::split_tf32(vst[sw(kk * 8 + c2 + 1, dj * 8 + g)], vh[1], vl[1]);
          tc::mma_tf32(pv, pl[kk], vh);
          tc::mma_tf32(pv, ph[kk], vl);
          tc::mma_tf32(pv, ph[kk], vh);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dj][e] = o[dj][e] * cr[e / 2] + pv[e];
      }
    }
  }
  tc::cp_wait<0>();                     // no copy outlives the block
  if (ntile > 0 && p.nsl > 1) {         // the others have read our sums
    cluster_arrive();
    cluster_wait();
  }

  const bool pairs = (p.D & 1) == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(FULL, lt, 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int qp = wq0 + g + 8 * hh;
    if (qp >= p.S) continue;
    float* orow = p.o + (((size_t)b * p.S + qp) * p.H + h) * p.D;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int d = d0 + j * 8 + c2;
      if (j * 8 >= dvp) break;
      const float v0 = o[j][2 * hh] * inv, v1 = o[j][2 * hh + 1] * inv;
      if (pairs && d + 1 < p.D) {
        *reinterpret_cast<float2*>(orow + d) = make_float2(v0, v1);
      } else {
        if (d < p.D) orow[d] = v0;
        if (d + 1 < p.D) orow[d + 1] = v1;
      }
    }
  }
}

cudaError_t set_attributes() {
  static bool attr_set = false;
  if (attr_set) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout::BYTES);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_tf32x3_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  attr_set = true;
  return cudaSuccess;
}

cudaError_t launch(const Args& p, int B, int S, cudaStream_t stream) {
  const cudaError_t e = set_attributes();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nsl * ((S + BQT - 1) / BQT) * B * p.H);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = Layout::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nsl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_tf32x3_kernel, p);
}

}  // namespace fx

}  // namespace

// fp32 q/k/v/o: the first design (flash_kernel), kept for the card's
// A/B against the two fp32 routes (the wrapper's force="cuda_v1").
// window <= 0: no sliding window.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Skv, int H, int Hkv, int D,
                                      float scale, int causal, int window,
                                      void* stream) {
  if (B < 1 || S < 1 || Skv < 1 || H < 1 || Hkv < 1 || H % Hkv || D < 1 ||
      D > MAXD || S > 65535 * BQ)
    return (int)cudaErrorInvalidValue;
  return (int)launch_f32(q, k, v, o, B, S, Skv, H, Hkv, D, scale,
                                  causal, window, (cudaStream_t)stream);
}

// fp32 q/k/v/o: route 0 flash_rows_kernel (one warp a query row), route
// 1 flash_tf32x3_kernel (3xTF32 tensor cores, the D-slices a cluster).
// The wrapper picks the route by S (kernels/flash_attention.py, route);
// either takes any shape here. window <= 0: no sliding window.
extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int S, int Skv, int H, int Hkv,
                                          int D, float scale, int causal,
                                          int window, int route,
                                          void* stream) {
  if (B < 1 || S < 1 || Skv < 1 || H < 1 || Hkv < 1 || H % Hkv || D < 1 ||
      D > MAXD || route < 0 || route > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (route == 0) {
    if ((long long)B * S * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    return (int)fr::launch(q, k, v, o, B, S, Skv, H, Hkv, D, scale, causal,
                           window, st);
  }
  fx::Args p;
  p.q = (const float*)q;
  p.k = (const float*)k;
  p.v = (const float*)v;
  p.o = (float*)o;
  p.S = S; p.Skv = Skv; p.H = H; p.Hkv = Hkv; p.D = D;
  p.Dp = (D + fx::X_KSTEP - 1) / fx::X_KSTEP * fx::X_KSTEP;
  p.nsl = (p.Dp + ft::DV - 1) / ft::DV;
  p.causal = causal; p.window = window;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.vec = D % 4 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  if (p.nsl > fc::MAX_CLUSTER ||
      (long long)p.nsl * ((S + ft::BQT - 1) / ft::BQT) * B * H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return (int)fx::launch(p, B, S, st);
}

// Resident blocks an SM of an fp32 route's kernel at its registers and
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor): route 0
// flash_rows_kernel at D <= 1024, route 1 flash_tf32x3_kernel.
extern "C" int flash_attention_f32_occupancy(int route, int* blocks) {
  if (route == 0)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fr::flash_rows_kernel<8>, fr::ROW_WARPS * 32, 0);
  const cudaError_t e = fx::set_attributes();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fx::flash_tf32x3_kernel, fc::NT, fx::Layout::BYTES);
}

// bf16 q/k/v/o: the tensor-core kernels. window <= 0: no sliding window.
// route 0: flash_tc_kernel<2> up to D = 512, flash_tc_cluster_kernel
// above; route 1: flash_tc_kernel<1> (the earlier single-stage D > 512
// path, kept for the card's A/B against the cluster route, never
// chosen).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int S, int Skv, int H, int Hkv,
                                         int D, float scale, int causal,
                                         int window, int route,
                                         void* stream) {
  if (B < 1 || S < 1 || Skv < 1 || H < 1 || Hkv < 1 || H % Hkv || D < 1 ||
      D > MAXD || S > 65535 * ft::BQT || route < 0 || route > 1)
    return (int)cudaErrorInvalidValue;
  ft::Args p;
  p.q = (const __nv_bfloat16*)q;
  p.k = (const __nv_bfloat16*)k;
  p.v = (const __nv_bfloat16*)v;
  p.o = (__nv_bfloat16*)o;
  p.S = S; p.Skv = Skv; p.H = H; p.Hkv = Hkv; p.D = D;
  p.Dp = (D + 15) / 16 * 16;
  p.nsl = (p.Dp + ft::DV - 1) / ft::DV;
  p.causal = causal; p.window = window;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.vec = D % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (route == 1) return (int)ft::launch_tc<1>(p, B, S, st);
  if (p.Dp <= MAXD_FAST) return (int)ft::launch_tc<2>(p, B, S, st);
  if (p.nsl > fc::MAX_CLUSTER ||
      (long long)p.nsl * ((S + ft::BQT - 1) / ft::BQT) * B * H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return (int)fc::launch(p, B, S, st);
}
