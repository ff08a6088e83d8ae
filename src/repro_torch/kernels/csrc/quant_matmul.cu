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
// whole payload in flight at once. At the trainers' rows it ranges from
// memory-bound (Kimi-K2's experts, 7 rows: 2 x 7 flops a half byte) to
// operations-bound on the bf16 tensor cores (Whisper's encoder MLP,
// 6000 rows).
//
// Design: W is never written dense, and the stacked user axis is a grid
// axis, so a whole serve group is one launch. Three routes, chosen by
// the wrapper (kernels/quant_matmul.py) and counted there, and a fourth
// run only when forced; none stands in for another:
//  - GEMV (M <= 4 rows per user, N % 4 == 0, 4-byte aligned payload);
//    gemv.cuh's gemv_kernel with the QmvOut epilogue ("qmv" below). K is
//    split across the CTAs of a thread-block
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
//    before its stores, and the cluster meets at one barrier. The kernel
//    lives in gemv.cuh, shared with lora_gemv.cu's decode route of the
//    fused LoRA linear, which gives it another epilogue.
//  - tc (bf16 x, any other shape); see qmm_tc_kernel. Tensor cores:
//    mma.sync.m16n8k16 on bf16 operands with fp32 accumulators, fed by
//    ldmatrix (mma.cuh), lora_matmul.cu's lora_tc_kernel without its
//    rank-r term. A block owns a BM x 128 output tile of one user and
//    walks its split of K in 32-deep k-tiles: x, the packed payload and
//    the scale rows are staged by cp.async in a ring of 16-byte chunks
//    (tc_tile.cuh's stage_xqs, zero past M, K, the split's end and N),
//    and each k-tile's weights are decoded once per block into a bf16
//    tile in shared memory (tc_tile.cuh's decode_words, code * fp32
//    scale rounded to bf16: one mma pass, the product the plain version
//    forms when it dequantizes to x's bf16), the decode of tile t + 1
//    interleaved with tile t's two k16 steps. W is decoded once per row
//    tile (and split). The row tile fits the three regimes the trainers
//    give it (kernels/quant_matmul.py:plan_tc picks it, with the split):
//     * few rows, long K (Kimi-K2's experts, M = 7, K = 7168, N = 2048):
//       BM = 16 (9 of 16 rows wasted, which costs nothing: the call is
//       memory-bound) in 8 warps of 16 x 16, an 8-deep ring and 3-4
//       blocks an SM; the 16 column tiles cannot fill 132 SMs, so K is
//       split into whole quant groups and whole k-tiles and each split's
//       block streams its slice of W once;
//     * hundreds of rows (RecurrentGemma-2B's MLP, M = 256): BM = 256,
//       16 warps of 64 x 32, a 4-deep ring; one row tile covers M, so
//       each weight is decoded once per call and split;
//     * thousands of rows (Whisper's encoder MLP, M = 6000): BM = 256;
//       the 24 x 32 tiles fill the card without a split and W is decoded
//       once per row tile, 24 times, against 256 rows of products each.
//    BM = 64 (8 warps of 32 x 32) covers the tens of rows between.
//    Split-K partials go to an fp32 (splits, T, M, N) workspace that
//    splitk_sum adds in split order: no atomics, two calls bitwise equal.
//  - tf32x3 (fp32 x, any other shape): qmm_tf32_kernel, the body of
//    tf32_gemm.cuh (shared with lora_matmul.cu's qmt_tf32_kernel): 3xTF32
//    mma.sync.m16n8k8, each fp32 operand split into TF32 hi and lo and
//    each product taken as lo hi + hi lo + hi hi, in chains of 4 k8 steps
//    added in fp32, which keeps fp32 callers at 1e-5. Bound: at the MoE
//    experts' 20 x 4096 x 1536 (NF4) the bytes of W (1.19 us at 3.35
//    TB/s) against 1.53 us of three TF32 products at 494.7 TFLOP/s, so the
//    call is a matter of reading W once and filling the SMs; at the
//    calibrated RecurrentGemma-2B MLP's 2048 x 2560 x 7680 operations
//    (0.488 ms). Each k-tile's weights are decoded once per block into
//    TF32 hi and lo tiles in shared memory that every warp reads; a row
//    tile of 32 rows (two m16 rows, for tens of rows) or 128, and K split
//    on whole quant groups and k-tiles until the grid fills the 132 SMs
//    (kernels/quant_matmul.py:plan_tf32: 11 splits, 132 blocks at 20 x
//    4096 x 1536), the partials summed in split order.
//  - tiled (forced only: the wrapper's force="tiled", the card's A/B):
//    qmm_kernel, the first fp32 design, fp32 CUDA cores. Each block owns
//    a (BM x 64) output tile and walks all of K in 32-row tiles,
//    dequantizing each weight by its own load into shared memory; 24
//    blocks at 20 x 4096 x 1536, 0.50 ms against the new route's 0.027.
// Packed 4-bit row j holds rows 2j (hi nibble) and 2j+1 (lo nibble); the
// decode is dequant.cuh's, shared with lora_matmul.cu, and NF4 codes map
// through the 16-entry codebook in shared memory. A weight is code x
// scale in fp32, the product the plain version computes.
#include "gemv.cuh"
#include "tf32_gemm.cuh"

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
// gemv.cuh's gemv_kernel with QmvOut as the leader's epilogue: the ranks'
// slots added in rank order into y (user t = blockIdx.y: x (T, MR, Kq),
// q (T, G, rows, N), s (T, G, 1, N), y (T, MR, N)).
using gv::GV_CLUSTER_MAX;
using gv::GV_CPT;
using gv::GV_LMAX;
using gv::GV_THREADS;

template <typename T, int MR>
struct QmvOut {
  static constexpr bool kReuse = false;
  T* y;
  __device__ __forceinline__ void operator()(const float* slots, float*,
                                             int per, int csize, int cols,
                                             int n0, int t, int N) const {
    for (int o = threadIdx.x; o < per; o += GV_THREADS) {
      const float v = gv::leader_sum(slots, per, csize, o);
      int m, n;
      gv::out_at(o, cols, n0, &m, &n);
      if (n < N) store_f(y + ((size_t)t * MR + m) * N + n, v);
    }
  }
};

template <typename T, int FMT, int MR>
cudaError_t launch_gemv(const void* x, const void* q, const void* s, void* y,
                        int T_, int Kq, int N, int block, int rows, int cols,
                        int csize, cudaStream_t stream) {
  const int G = Kq / block;
  const int gmax = (G + csize - 1) / csize;
  const size_t smem = sizeof(float) * gv::gv_smem_floats(
      MR, cols, csize, gv::gv_kxp(gmax, block), gmax,
      QmvOut<T, MR>::kReuse || MR > 4);
  auto* kern = gv::gemv_kernel<T, FMT, MR, GV_LMAX, QmvOut<T, MR>>;
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
                            (const float*)s, QmvOut<T, MR>{(T*)y}, Kq, N,
                            block, rows, cols, csize, vec16);
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

// ---- tc route: bf16 x on the tensor cores ------------------------------
namespace qtc {

using tt::BK;
using tt::BN;
using tt::LDW;
using tt::LDX;
using tt::SR;

// The block's shape for a row tile of BM rows: WM x WN warps, each a
// (BM / WM) x (BN / WN) warp tile, an NS-deep cp.async ring, and MINB
// blocks an SM for the register budget.
template <int BM>
struct Cfg {
  static constexpr int WM = BM == 256 ? 4 : BM == 64 ? 2 : 1;
  static constexpr int WN = BM == 16 ? 8 : 4;
  static constexpr int NT = 32 * WM * WN;       // 512, 256, 256 threads
  static constexpr int MI = BM / WM / 16;       // m16 fragments a warp
  static constexpr int NJ = BN / WN / 8;        // n8 blocks a warp
  static constexpr int NS = BM == 256 ? 4 : BM == 64 ? 6 : 8;
  static constexpr int MINB = BM == 256 ? 1 : BM == 64 ? 2 : 3;
  static_assert(BM == 16 || BM == 64 || BM == 256, "row tile");
  static_assert(MI >= 1 && NJ % 2 == 0, "warp tile");
};

template <int FMT, int BM>
struct Layout {
  static constexpr int RSTEP = FMT == FMT_INT8 ? 1 : 2;  // weight rows a byte
  static constexpr int QROWS = BK / RSTEP;               // payload rows a tile
  static constexpr int X = 0;                        // bf16 [BM][LDX]
  static constexpr int Q = X + BM * LDX * 2;         // u8 [QROWS][BN]
  static constexpr int S = Q + QROWS * BN;           // f32 [SR][BN]
  static constexpr int STAGE = S + SR * BN * 4;
  // decoded tiles, double-buffered: bf16 [2][BK][LDW]
  static constexpr int WB = Cfg<BM>::NS * STAGE;
  static constexpr int CODE = WB + 2 * BK * LDW * 2; // f32 [16]
  static constexpr int BYTES = CODE + 16 * 4;
  static_assert(STAGE % 16 == 0 && WB % 16 == 0, "align");
};

struct Args {
  const __nv_bfloat16* x;           // (T, M, Kq)
  const uint8_t* q;                 // (T, G, rows, N)
  const float* s;                   // (T, G, 1, N)
  __nv_bfloat16* y;                 // (T, M, N) when splits == 1
  float* ws;                        // splits > 1: (splits, T, M, N) partials
  int T, M, Kq, N, rows, bshift, unit, splits;  // block = 1 << bshift
  bool x_vec, w_vec;                // 16-byte cp.async for x / payload+scales
};

// y tile (m0.., n0..) of user t, split z = the sum over the split's
// k-tiles of x_tile @ bf16(W)_tile: one mma pass, fp32 accumulators.
// grid (N tiles, M tiles, T * splits).
template <int FMT, int BM>
__global__ void __launch_bounds__(Cfg<BM>::NT, Cfg<BM>::MINB)
qmm_tc_kernel(const Args p) {
  using C = Cfg<BM>;
  using L = Layout<FMT, BM>;
  constexpr int NS = C::NS, NT = C::NT;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem + L::WB);
  float* code = reinterpret_cast<float*>(smem + L::CODE);
  dq::load_codebook(code);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int t = blockIdx.z / p.splits, z = blockIdx.z - t * p.splits;
  const int G = p.Kq >> p.bshift;
  const __nv_bfloat16* x = p.x + (size_t)t * p.M * p.Kq;
  const uint8_t* q = p.q + (size_t)t * G * p.rows * p.N;
  const float* s = p.s + (size_t)t * G * p.N;
  // this split's contraction range: whole units of lcm(block, BK)
  const int nu = (p.Kq + p.unit - 1) / p.unit;
  const int kb = (int)((long long)z * nu / p.splits) * p.unit;
  const int ke = min((int)((long long)(z + 1) * nu / p.splits) * p.unit,
                     p.Kq);
  const int ntile = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  auto stage = [&](int slot, int k0) {
    uint8_t* st = smem + slot * L::STAGE;
    tt::stage_xqs<FMT, BM, NT>(
        x, q, s, p.M, p.Kq, p.N, p.bshift, p.x_vec, p.w_vec,
        reinterpret_cast<__nv_bfloat16*>(st + L::X), st + L::Q,
        reinterpret_cast<float*>(st + L::S), m0, n0, k0, ke);
  };
  auto decode = [&](int slot, __nv_bfloat16* wb, int k0, int part) {
    const uint8_t* st = smem + slot * L::STAGE;
    tt::decode_words<FMT, BK, BN, LDW, NT, false>(
        st + L::Q, reinterpret_cast<const float*>(st + L::S), wb, code, k0,
        ke, p.bshift, part);
  };
  float acc[C::MI][C::NJ][4];
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int u = 0; u < NS - 1; ++u) {
    if (u < ntile) stage(u, kb + u * BK);
    tc::cp_commit();                // one group per tile, empty or not
  }
  tc::cp_wait<NS - 2>();
  __syncthreads();                  // tile 0 and the codebook are in
  if (ntile > 0)
    for (int part = 0; part < 2; ++part) decode(0, wbuf, kb, part);

  for (int u = 0; u < ntile; ++u) {
    tc::cp_wait<NS - 3>();          // tile u + 1 has landed
    __syncthreads();                // tile u decoded; tile u - 1 consumed
    if (u + NS - 1 < ntile) stage((u + NS - 1) % NS, kb + (u + NS - 1) * BK);
    tc::cp_commit();
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(smem + (u % NS) * L::STAGE);
    const __nv_bfloat16* wb = wbuf + (u & 1) * BK * LDW;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t af[C::MI][4];
#pragma unroll
      for (int i = 0; i < C::MI; ++i)
        tc::frag_a(af[i], xs, LDX, wm * (BM / C::WM) + i * 16, kk * 16,
                   lane);
#pragma unroll
      for (int jj = 0; jj < C::NJ / 2; ++jj) {
        uint32_t bf[4];
        tc::frag_b_kn(bf, wb, LDW, kk * 16, wn * (BN / C::WN) + jj * 16,
                      lane);
#pragma unroll
        for (int i = 0; i < C::MI; ++i) {
          tc::mma_bf16(acc[i][2 * jj], af[i], bf[0], bf[1]);
          tc::mma_bf16(acc[i][2 * jj + 1], af[i], bf[2], bf[3]);
        }
      }
      if (u + 1 < ntile)            // decode the next tile meanwhile
        decode((u + 1) % NS, wbuf + ((u + 1) & 1) * BK * LDW,
               kb + (u + 1) * BK, kk);
    }
  }
  tc::cp_wait<0>();                 // no copy outlives the block

  const bool pairs = (p.N & 1) == 0;
  const size_t base = (size_t)t * p.M * p.N;
  float* part = p.splits > 1
                    ? p.ws + (size_t)z * p.T * p.M * p.N + base : nullptr;
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * (BM / C::WM) + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
        const int n = n0 + wn * (BN / C::WN) + j * 8 + c2;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        const size_t o = (size_t)m * p.N + n;
        if (part == nullptr) {
          __nv_bfloat16* y = p.y + base;
          if (pairs && n + 1 < p.N) {
            *reinterpret_cast<uint32_t*>(y + o) = tc::pack_bf16(v0, v1);
          } else {
            if (n < p.N) y[o] = __float2bfloat16(v0);
            if (n + 1 < p.N) y[o + 1] = __float2bfloat16(v1);
          }
        } else if (pairs && n + 1 < p.N) {
          *reinterpret_cast<float2*>(part + o) = make_float2(v0, v1);
        } else {
          if (n < p.N) part[o] = v0;
          if (n + 1 < p.N) part[o + 1] = v1;
        }
      }
    }
}

template <int FMT, int BM>
cudaError_t launch(const Args& p, cudaStream_t st) {
  using L = Layout<FMT, BM>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_tc_kernel<FMT, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::BYTES);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.T * p.splits);
  qmm_tc_kernel<FMT, BM><<<grid, Cfg<BM>::NT, L::BYTES, st>>>(p);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_bm(const Args& p, int bm, cudaStream_t st) {
  switch (bm) {
    case 16: return launch<FMT, 16>(p, st);
    case 64: return launch<FMT, 64>(p, st);
    case 256: return launch<FMT, 256>(p, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace qtc

// ---- tf32x3 route: fp32 x on the tensor cores ---------------------------
namespace qtf {

// y tile (m0.., n0..) of user t, split z: tf32_gemm.cuh's body with W's
// [32 K rows][128 N columns] tile read as it is stored.
template <int FMT, int BM>
__global__ void __launch_bounds__(tg::NT, tg::Cfg<BM>::MINB)
qmm_tf32_kernel(const tg::Args p) {
  tg::gemm_tf32<FMT, BM, false>(p);
}

template <int FMT, int BM>
cudaError_t launch_tile(const tg::Args& p, cudaStream_t st) {
  constexpr int bytes = tg::Layout<FMT, BM, false>::BYTES;
  static bool attr_set = false;
  const cudaError_t e = tg::set_smem(qmm_tf32_kernel<FMT, BM>, bytes,
                                     attr_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.O + tg::BO - 1) / tg::BO, (p.M + BM - 1) / BM,
                  p.T * p.splits);
  qmm_tf32_kernel<FMT, BM><<<grid, tg::NT, bytes, st>>>(p);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_bm(const tg::Args& p, int bm, cudaStream_t st) {
  switch (bm) {
    case 32: return launch_tile<FMT, 32>(p, st);
    case 128: return launch_tile<FMT, 128>(p, st);
  }
  return cudaErrorInvalidValue;
}

template <int FMT, int BM>
cudaError_t occupancy(int* blocks) {
  constexpr int bytes = tg::Layout<FMT, BM, false>::BYTES;
  bool done = false;
  const cudaError_t e = tg::set_smem(qmm_tf32_kernel<FMT, BM>, bytes, done);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, qmm_tf32_kernel<FMT, BM>, tg::NT, bytes);
}

}  // namespace qtf

}  // namespace

// fmt: 0 int8, 1 int4 (packed), 2 NF4 (packed); is_bf16: x and y dtype;
// cols, csize: the GEMV's column tile and cluster size (cols 0: the tiled
// qmm_kernel, the first design, run only when the wrapper is forced to it).
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
  return (int)sizeof(float) *
         gv::gv_smem_floats(M, cols, csize, gv::gv_kxp(gmax, block), gmax,
                            M > 4);
}

// bf16 x, y: the tensor-core kernel with a row tile of bm (16, 64 or 256)
// rows and K in `splits` slices on multiples of unit (a multiple of both
// the block and 32; kernels/quant_matmul.py:plan_tc), then (splits > 1)
// splitk_sum over the fp32 workspace ws (splits, T, M, N). block is a
// power of two >= 16.
extern "C" int quant_matmul_tc_launch(const void* x, const void* q,
                                      const void* s, void* y, void* ws,
                                      int T, int M, int Kq, int N, int block,
                                      int rows, int fmt, int bm, int splits,
                                      int unit, void* stream) {
  const int rstep = fmt == FMT_INT8 ? 1 : 2;
  if (T < 1 || M < 1 || N < 1 || block < tt::MIN_BLOCK ||
      (block & (block - 1)) || Kq < block || Kq % block ||
      rows * rstep != block || bm < 16 || (M + bm - 1) / bm > 65535 ||
      splits < 1 || splits > 64 || (long long)T * splits > 65535 ||
      unit < 1 || unit % tt::BK || unit % block ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  qtc::Args p;
  p.x = (const __nv_bfloat16*)x;
  p.q = (const uint8_t*)q;
  p.s = (const float*)s;
  p.y = (__nv_bfloat16*)y;
  p.ws = (float*)ws;
  p.T = T; p.M = M; p.Kq = Kq; p.N = N; p.rows = rows;
  p.bshift = __builtin_ctz(block); p.unit = unit; p.splits = splits;
  p.x_vec = (uintptr_t)x % 16 == 0;           // Kq % 8 == 0: block >= 16
  p.w_vec = N % 16 == 0 && ((uintptr_t)q | (uintptr_t)s) % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  switch (fmt) {
    case FMT_INT8: err = qtc::launch_bm<FMT_INT8>(p, bm, st); break;
    case FMT_INT4: err = qtc::launch_bm<FMT_INT4>(p, bm, st); break;
    case FMT_NF4: err = qtc::launch_bm<FMT_NF4>(p, bm, st); break;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)tt::sum_splits((const float*)ws, (__nv_bfloat16*)y,
                             (long long)T * M * N, splits, st);
}

// fp32 x, y: the 3xTF32 tensor-core kernel with a row tile of bm (32 or
// 128) rows and K in `splits` slices on multiples of unit (a multiple of
// both the block and 32; kernels/quant_matmul.py:plan_tf32), then (splits
// > 1) splitk_sum over the fp32 workspace ws (splits, T, M, N). block is
// a power of two >= 16.
extern "C" int quant_matmul_tf32_launch(const void* x, const void* q,
                                        const void* s, void* y, void* ws,
                                        int T, int M, int Kq, int N,
                                        int block, int rows, int fmt, int bm,
                                        int splits, int unit, void* stream) {
  const int rstep = fmt == FMT_INT8 ? 1 : 2;
  if (T < 1 || M < 1 || N < 1 || block < tt::MIN_BLOCK ||
      (block & (block - 1)) || Kq < block || Kq % block ||
      rows * rstep != block || bm < 32 || (M + bm - 1) / bm > 65535 ||
      splits < 1 || splits > tg::MAX_SPLITS || (long long)T * splits > 65535 ||
      unit < 1 || unit % tt::BK || unit % block ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  tg::Args p;
  p.a = (const float*)x;
  p.q = (const uint8_t*)q;
  p.s = (const float*)s;
  p.y = (float*)y;
  p.ws = (float*)ws;
  p.T = T; p.M = M; p.C = Kq; p.O = N; p.Kq = Kq; p.N = N; p.rows = rows;
  p.bshift = __builtin_ctz(block); p.unit = unit; p.splits = splits;
  p.a_vec = (uintptr_t)x % 16 == 0;           // Kq % 16 == 0: block >= 16
  p.w_vec = N % 16 == 0 && ((uintptr_t)q | (uintptr_t)s) % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  switch (fmt) {
    case FMT_INT8: err = qtf::launch_bm<FMT_INT8>(p, bm, st); break;
    case FMT_INT4: err = qtf::launch_bm<FMT_INT4>(p, bm, st); break;
    case FMT_NF4: err = qtf::launch_bm<FMT_NF4>(p, bm, st); break;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)tt::sum_splits((const float*)ws, (float*)y,
                             (long long)T * M * N, splits, st);
}

// Resident blocks an SM of qmm_tf32_kernel (row tile bm: 32, else 128;
// fmt 0 int8, else NF4, whose 4-bit stage int4 shares) at its registers
// and shared memory.
extern "C" int quant_matmul_tf32_occupancy(int fmt, int bm, int* blocks) {
  if (fmt == FMT_INT8)
    return (int)(bm == 32 ? qtf::occupancy<FMT_INT8, 32>(blocks)
                          : qtf::occupancy<FMT_INT8, 128>(blocks));
  return (int)(bm == 32 ? qtf::occupancy<FMT_NF4, 32>(blocks)
                        : qtf::occupancy<FMT_NF4, 128>(blocks));
}
