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
// operations-bound on the bf16 tensor-core rate.
//
// Each op has two instantiations, chosen by the activation's dtype in the
// wrapper (kernels/lora_matmul.py), never as a fallback of one another:
// bf16 runs the tensor-core kernels below, fp32 the CUDA-core ones, which
// keep fp32 callers at 1e-5 (tensor cores at fp32 would need TF32).
//
// bf16 x: lora_tc_kernel, tensor cores (lora_matmul_tc_launch).
//  - mma.sync.m16n8k16 (bf16 operands, fp32 accumulators) fed by
//    ldmatrix (csrc/mma.cuh), not wgmma: the trainer's tiles are small
//    (M = 256), the decoded weight tile is written by the block's own
//    threads rather than by TMA, and mma.sync needs no shared-memory
//    descriptors or warpgroup fences; that keeps the kernel short.
//  - Block tile 256 x 128 (BM x BN), 16 warps as 4 x 4, each a 64 x 32
//    warp tile; K walks in 32-deep tiles. BM = 256 covers the trainer's
//    M = 256 tokens, so each weight is decoded once per call (per split).
//    x, the packed payload, the scale rows a tile touches and the rows
//    of A are staged by cp.async in a 4-stage ring as 16-byte chunks
//    (zero-filled past M, K, Kq and N), so three tiles' loads are in
//    flight during each tile's math. Each thread's copies are a fixed,
//    unrolled set of chunks: the first version's generic strided loops
//    and per-row divisions by the block size cost ~2200 SASS
//    instructions per 36 mma (cuobjdump on the card). The block is a
//    power of two >= 16 (shifts, not divisions), A arrives padded to 16
//    or 32 columns, and K % 8 != 0 or N % 16 != 0 take element-wise
//    staging of x or of the payload.
//  - Decode once per block (decode_words): each weight of the block's
//    column range is decoded (code * fp32 scale, the plain version's
//    product) into shared tiles that all 256 rows use, as two bf16
//    parts, hi = bf16(w) and lo = bf16(w - hi), and x multiplies both
//    (two mma passes, about 16 bits of w). One pass (w rounded to bf16,
//    as the TPU's default-precision MXU pass rounds it) held each call
//    to the bf16 bound but moved the 2-layer Yi-9B step's gradients 2.4%
//    (adapter wq/wk) from the CPU's fp32 products, past that check's 2%
//    (PERF.md). The decode of tile t+1 is interleaved with the
//    two k16 steps of tile t's mma (double-buffered weight tiles, one
//    barrier per tile), so the ALUs decode while the tensor cores
//    multiply.
//  - h = x @ A rides in the same loop as an n = 16 / 32 tensor-core
//    product (A split into hi and lo the same way, r padded with zero
//    columns); after the loop h (fp32) and the rows of B (fp32) meet in
//    shared memory and each thread adds scale * h @ B to its
//    accumulators in fp32.
//  - Split-K (grid z) where the tile grid is too small for 132 SMs:
//    kernels/lora_matmul.plan picks the split count; splits fall on
//    multiples of lcm(block, 32), so every split owns whole quant groups
//    and whole k-tiles. Each split writes fp32 partials, its own
//    scale * h_s @ B included (the term is linear in h), to an
//    (splits, M, N) workspace, and splitk_sum adds them in split order
//    and casts to the output dtype: deterministic, no atomics.
//  - Shared memory 140 KB (NF4/int4, r <= 16) to 160 KB (int8,
//    r <= 32): one block of 16 warps per SM.
//  - The staging of x, payload and scales (stage_xqs), the decoder
//    (decode_words) and splitk_sum live in tc_tile.cuh, shared with
//    quant_matmul.cu's qmm_tc_kernel.
//
// bf16 g: qmt_tc_kernel, tensor cores (quant_matmul_t_tc_launch), the
// same design turned over. The trainer's cotangent is bf16 (the model's
// dtype), so it is the A operand as it is: only W is split into hi + lo
// (two mma passes), and g.float() @ W^T and g @ W^T with fp32 products
// are the same sum.
//  - Block tile 256 (M) x 128 (Kq, output columns), 16 warps as 4 x 4,
//    each 64 x 32; the contraction walks N in 32-deep tiles. W's stored
//    orientation (Kq rows, N contiguous) is already the [n][k] layout
//    mma.sync's col-major B operand wants, so a tile decodes into
//    [128 Kq rows][32 N columns] (decode_words, the same decoder as
//    lora_tc_kernel's at another tile shape) and is read with plain
//    ldmatrix (frag_b_nk). g's [256][32] tile, the payload's 64 (4-bit)
//    or 128 (int8) rows of 32 bytes and the tile's 128 / block scale
//    rows are staged by cp.async in a 4-stage ring.
//  - Split over N (grid z): a 128-column tile grid is 32 blocks at
//    Kq = 4096 and 86 at 11008, against 132 SMs. N carries no quant
//    group (the groups run along Kq), so the granule is one 32-wide
//    k-tile; kernels/lora_matmul.plan_t picks the count, fp32 partials
//    (splits, M, Kq) are summed in split order by splitk_sum into fp32
//    or bf16.
//  - Columns past N (ragged N) stage as zeros in both g and W, so they
//    contract inertly, as the Pallas kernel's zero scales make them;
//    Kq rows past the true Kq decode to zero and are not written.
//
// fp32 x: lora_kernel, fp32 CUDA cores, the first design. Each block
// owns a (64 x 128) output tile, 256 threads as 16 x 16, each thread a
// 4 x 8 register micro-tile at stride 16 (conflict-free shared reads).
// The block walks the reduction axis in 32-deep tiles: the activation
// tile is staged transposed, the weight tile is dequantized into shared
// memory straight from the quantized payload (dequant.cuh, the decode
// quant_matmul.cu uses), so W is never written dense. A loop inside the
// block takes the place of the TPU's sequential quant-group grid axis.
//  - lora_matmul also stages the matching rows of A and accumulates
//    h = x @ A (64 x r, fp32 registers) in the same loop, as the Pallas
//    kernel's (bm, r) scratch does; after the loop h and the (r x 128)
//    tile of B meet in shared memory and y = acc + scale * h @ B is
//    written. r is padded to 16 or 32 with zero columns.
// fp32 g: qmt_kernel, the same CUDA-core tiles for quant_matmul_t. It
// reduces over N and writes columns of Kq: its weight tile is W^T, read
// along N (coalesced) and stored transposed in shared memory with a
// padded stride. Columns past N (ragged N) load as zeros.
// Odd K: x and A are masked past the true K and W's pad rows are zero,
// which contracts as the zero-padding of lora_matmul.py:75-84 does.
// All accumulation is fp32. No route writes a dense W to device memory.
#include "tc_tile.cuh"

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
template <int FMT, int RP>
__global__ void __launch_bounds__(NT)
lora_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q,
            const float* __restrict__ s, const float* __restrict__ a,
            const float* __restrict__ b, float* __restrict__ y, int M, int K,
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
template <int FMT>
__global__ void __launch_bounds__(NT)
qmt_kernel(const float* __restrict__ g, const uint8_t* __restrict__ q,
           const float* __restrict__ s, float* __restrict__ o, int M, int Kq,
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

// ---- bf16 x: tensor cores ----------------------------------------------
namespace lt {

using tt::BK;                        // the shared tile (tc_tile.cuh):
using tt::BN;                        // 128 columns, 32-deep k-tiles,
using tt::LDW;                       // padded strides, scale rows, the
using tt::LDX;                       // smallest block
using tt::MIN_BLOCK;
using tt::SR;
constexpr int BM = 256;
constexpr int NS = 4;               // cp.async ring depth (tiles)
constexpr int NT = 512;             // 16 warps: 4 (rows) x 4 (columns)

template <int FMT, int RP>
struct Layout {
  static constexpr int RSTEP = FMT == FMT_INT8 ? 1 : 2;  // weight rows a byte
  static constexpr int QROWS = BK / RSTEP;               // payload rows a tile
  static constexpr int LDA = RP + 8;
  static constexpr int X = 0;                        // bf16 [BM][LDX]
  static constexpr int Q = X + BM * LDX * 2;         // u8 [QROWS][BN]
  static constexpr int S = Q + QROWS * BN;           // f32 [SR][BN]
  static constexpr int A = S + SR * BN * 4;          // f32 [BK][RP]
  static constexpr int STAGE = A + BK * RP * 4;
  // decoded tiles, double-buffered, each as a bf16 hi and lo part
  static constexpr int WB = NS * STAGE;              // bf16 [2][2][BK][LDW]
  static constexpr int AB = WB + 4 * BK * LDW * 2;   // bf16 [2][2][BK][LDA]
  static constexpr int CODE = AB + 4 * BK * LDA * 2; // f32 [16]
  static constexpr int BYTES = CODE + 16 * 4;
  // 16-byte chunks of A a tile stages (x, payload, scales: stage_xqs)
  static constexpr int ACH = BK * RP / 4;            // threads tid < ACH
  static_assert(ACH <= NT, "chunks");
  static_assert(STAGE % 16 == 0 && WB % 16 == 0 && AB % 16 == 0, "align");
  // the epilogue's h [BM][RP + 1] and B rows [RP][BN] reuse the ring
  static_assert((BM * (RP + 1) + RP * BN) * 4 <= WB, "epilogue fits");
};

struct Args {
  const __nv_bfloat16* x;
  const uint8_t* q;
  const float* s;
  const float* a;                   // (K, RP): r zero-padded to RP
  const float* b;                   // (r, N)
  __nv_bfloat16* y;                 // the output when splits == 1
  float* ws;                        // splits > 1: (splits, M, N) partials
  int M, K, Kq, N, r, bshift, unit; // block = 1 << bshift
  float scale;
  bool x_vec, w_vec;                // 16-byte cp.async for x / payload+scales
};

// Stage k-tile [k0, k0 + BK) of the split ending at ke into one ring slot:
// x, the payload and the scale rows by tt::stage_xqs, then the tile's
// rows of A (zero past K).
template <int FMT, int RP>
__device__ __forceinline__ void load_tile(const Args& p, uint8_t* st, int m0,
                                          int n0, int k0, int ke) {
  using L = Layout<FMT, RP>;
  const int tid = threadIdx.x;
  tt::stage_xqs<FMT, BM, NT>(
      p.x, p.q, p.s, p.M, p.K, p.N, p.bshift, p.x_vec, p.w_vec,
      reinterpret_cast<__nv_bfloat16*>(st + L::X), st + L::Q,
      reinterpret_cast<float*>(st + L::S), m0, n0, k0, ke);
  float* as = reinterpret_cast<float*>(st + L::A);
  const int kx = min(p.K, ke);
  if (tid < L::ACH) {               // A rows are RP floats: 16-byte chunks
    const int k = k0 + tid / (RP / 4);
    const bool ok = k < kx;
    tc::cp_async16(as + tid * 4,
                   ok ? p.a + (size_t)k0 * RP + tid * 4 : p.a, ok);
  }
}

// Decode half `part` of a staged tile of lora_tc_kernel into the weight
// tile wb (decode_words); part 0 also splits the tile's A rows into ab
// (hi, lo, [BK][LDA] each).
template <int FMT, int RP>
__device__ __forceinline__ void decode_part(const Args& p, const uint8_t* st,
                                            __nv_bfloat16* wb,
                                            __nv_bfloat16* ab,
                                            const float* code, int k0,
                                            int ke, int part) {
  using L = Layout<FMT, RP>;
  const int tid = threadIdx.x;
  tt::decode_words<FMT, BK, BN, LDW, NT, true>(
      st + L::Q, reinterpret_cast<const float*>(st + L::S), wb, code, k0, ke,
      p.bshift, part);
  static_assert(BK * RP / 2 <= NT, "one A pair per thread");
  if (part == 0 && tid < BK * RP / 2) {
    const float* as = reinterpret_cast<const float*>(st + L::A);
    {
      const int i = tid, kk = (2 * i) / RP, c = (2 * i) % RP;
      const float2 v = *reinterpret_cast<const float2*>(as + 2 * i);
      tc::split_bf16(v.x, v.y,
                     *reinterpret_cast<uint32_t*>(ab + kk * L::LDA + c),
                     *reinterpret_cast<uint32_t*>(ab + (BK + kk) * L::LDA + c));
    }
  }
}

template <int FMT, int RP>
__global__ void __launch_bounds__(NT, 1) lora_tc_kernel(const Args p) {
  using L = Layout<FMT, RP>;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem + L::WB);
  __nv_bfloat16* abuf = reinterpret_cast<__nv_bfloat16*>(smem + L::AB);
  float* code = reinterpret_cast<float*>(smem + L::CODE);
  dq::load_codebook(code);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  // this split's contraction range: whole units of lcm(block, BK)
  const int nu = (p.Kq + p.unit - 1) / p.unit, z = blockIdx.z;
  const int kb = (int)((long long)z * nu / gridDim.z) * p.unit;
  const int ke = min((int)((long long)(z + 1) * nu / gridDim.z) * p.unit,
                     p.Kq);
  const int ntile = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  float acc[4][4][4];
  float hacc[RP / 8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < RP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[j][e] = 0.f;

#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < ntile)
      load_tile<FMT, RP>(p, smem + t * L::STAGE, m0, n0, kb + t * BK, ke);
    tc::cp_commit();                // one group per tile, empty or not
  }
  tc::cp_wait<NS - 2>();
  __syncthreads();                  // tile 0 and the codebook are in
  if (ntile > 0)
    for (int part = 0; part < 2; ++part)
      decode_part<FMT, RP>(p, smem, wbuf, abuf, code, kb, ke, part);

  for (int t = 0; t < ntile; ++t) {
    tc::cp_wait<NS - 3>();          // tile t + 1 has landed
    __syncthreads();                // tile t decoded; tile t - 1 consumed
    if (t + NS - 1 < ntile)
      load_tile<FMT, RP>(p, smem + ((t + NS - 1) % NS) * L::STAGE, m0, n0,
                         kb + (t + NS - 1) * BK, ke);
    tc::cp_commit();
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(smem + (t % NS) * L::STAGE);
    const __nv_bfloat16* wb = wbuf + (t & 1) * 2 * BK * LDW;
    const __nv_bfloat16* ab = abuf + (t & 1) * 2 * BK * L::LDA;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tc::frag_a(af[i], xs, LDX, wm * 64 + i * 16, kk * 16, lane);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t bh[4], bl[4];          // W's hi and lo parts
        tc::frag_b_kn(bh, wb, LDW, kk * 16, wn * 32 + jj * 16, lane);
        tc::frag_b_kn(bl, wb + BK * LDW, LDW, kk * 16, wn * 32 + jj * 16,
                      lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tc::mma_bf16(acc[i][2 * jj], af[i], bh[0], bh[1]);
          tc::mma_bf16(acc[i][2 * jj], af[i], bl[0], bl[1]);
          tc::mma_bf16(acc[i][2 * jj + 1], af[i], bh[2], bh[3]);
          tc::mma_bf16(acc[i][2 * jj + 1], af[i], bl[2], bl[3]);
        }
      }
      // h += x @ A over this warp's 16 rows of h (x rows wm*64 + wn*16..)
      uint32_t ah[4];
      tc::frag_a(ah, xs, LDX, wm * 64 + wn * 16, kk * 16, lane);
#pragma unroll
      for (int jj = 0; jj < RP / 16; ++jj) {
        uint32_t hb[4], hl[4];
        tc::frag_b_kn(hb, ab, L::LDA, kk * 16, jj * 16, lane);
        tc::frag_b_kn(hl, ab + BK * L::LDA, L::LDA, kk * 16, jj * 16, lane);
        tc::mma_bf16(hacc[2 * jj], ah, hb[0], hb[1]);
        tc::mma_bf16(hacc[2 * jj], ah, hl[0], hl[1]);
        tc::mma_bf16(hacc[2 * jj + 1], ah, hb[2], hb[3]);
        tc::mma_bf16(hacc[2 * jj + 1], ah, hl[2], hl[3]);
      }
      if (t + 1 < ntile)            // decode the next tile meanwhile
        decode_part<FMT, RP>(p, smem + ((t + 1) % NS) * L::STAGE,
                             wbuf + ((t + 1) & 1) * 2 * BK * LDW,
                             abuf + ((t + 1) & 1) * 2 * BK * L::LDA, code,
                             kb + (t + 1) * BK, ke, kk);
    }
  }

  // acc += scale * h @ B over the block's tile, in fp32
  tc::cp_wait<0>();
  __syncthreads();
  float* hs = reinterpret_cast<float*>(smem);        // [BM][RP + 1]
  float* bs = hs + BM * (RP + 1);                    // [RP][BN]
#pragma unroll
  for (int j = 0; j < RP / 8; ++j) {
    const int row = wm * 64 + wn * 16 + g, col = j * 8 + c2;
    hs[row * (RP + 1) + col] = hacc[j][0];
    hs[row * (RP + 1) + col + 1] = hacc[j][1];
    hs[(row + 8) * (RP + 1) + col] = hacc[j][2];
    hs[(row + 8) * (RP + 1) + col + 1] = hacc[j][3];
  }
  for (int i = tid; i < RP * BN; i += NT) {
    const int c = i / BN, n = n0 + i % BN;
    bs[i] = (c < p.r && n < p.N) ? p.b[(size_t)c * p.N + n] : 0.f;
  }
  __syncthreads();
  for (int c = 0; c < p.r; ++c) {
    float hv[4][2], bv[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = wm * 64 + i * 16 + g;
      hv[i][0] = p.scale * hs[row * (RP + 1) + c];
      hv[i][1] = p.scale * hs[(row + 8) * (RP + 1) + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j][0] = bs[c * BN + wn * 32 + j * 8 + c2];
      bv[j][1] = bs[c * BN + wn * 32 + j * 8 + c2 + 1];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j][0] = fmaf(hv[i][0], bv[j][0], acc[i][j][0]);
        acc[i][j][1] = fmaf(hv[i][0], bv[j][1], acc[i][j][1]);
        acc[i][j][2] = fmaf(hv[i][1], bv[j][0], acc[i][j][2]);
        acc[i][j][3] = fmaf(hv[i][1], bv[j][1], acc[i][j][3]);
      }
  }

  const bool pairs = (p.N & 1) == 0;
  float* part = gridDim.z > 1 ? p.ws + (size_t)z * p.M * p.N : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + c2;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        const size_t o = (size_t)m * p.N + n;
        if (gridDim.z == 1) {
          if (pairs && n + 1 < p.N) {
            *reinterpret_cast<uint32_t*>(p.y + o) = tc::pack_bf16(v0, v1);
          } else {
            if (n < p.N) p.y[o] = __float2bfloat16(v0);
            if (n + 1 < p.N) p.y[o + 1] = __float2bfloat16(v1);
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

template <int FMT, int RP>
cudaError_t launch(const Args& p, int splits, cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        lora_tc_kernel<FMT, RP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<FMT, RP>::BYTES);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  lora_tc_kernel<FMT, RP><<<grid, NT, Layout<FMT, RP>::BYTES, st>>>(p);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_fmt(const Args& p, int splits, cudaStream_t st) {
  return p.r <= 16 ? launch<FMT, 16>(p, splits, st)
                   : launch<FMT, 32>(p, splits, st);
}

}  // namespace lt

// ---- bf16 g: tensor cores ----------------------------------------------
namespace qmt {

using lt::MIN_BLOCK;
using lt::NS;
using lt::NT;
constexpr int BM = 256;             // rows of g and of dx a block
constexpr int BN = 128;             // columns of dx (rows of W) a block
constexpr int BK = 32;              // N (the contraction) a tile
constexpr int LDG = BK + 8;         // bf16 strides padded by 16 bytes:
constexpr int LDW = BK + 8;         // ldmatrix rows hit distinct banks
constexpr int SR = BN / MIN_BLOCK;  // scale rows a tile can touch

template <int FMT>
struct Layout {
  static constexpr int RSTEP = FMT == FMT_INT8 ? 1 : 2;
  static constexpr int QROWS = BN / RSTEP;           // payload rows a tile
  static constexpr int G = 0;                        // bf16 [BM][LDG]
  static constexpr int Q = G + BM * LDG * 2;         // u8 [QROWS][BK]
  static constexpr int S = Q + QROWS * BK;           // f32 [SR][BK]
  static constexpr int STAGE = S + SR * BK * 4;
  // decoded W tiles, double-buffered, each a bf16 hi and lo [BN][LDW]
  static constexpr int WB = NS * STAGE;
  static constexpr int CODE = WB + 4 * BN * LDW * 2; // f32 [16]
  static constexpr int BYTES = CODE + 16 * 4;
  // 16-byte chunks a tile stages: g, payload (scales: tid < rows * 8)
  static constexpr int GCH = BM * BK / 8 / NT;       // per thread
  static constexpr int QCH = QROWS * BK / 16;        // threads tid < QCH
  static_assert(GCH * NT * 8 == BM * BK && QCH <= NT && SR * 8 <= NT,
                "chunks");
  static_assert(STAGE % 16 == 0 && WB % 16 == 0, "align");
};

struct Args {
  const __nv_bfloat16* g;           // (M, N)
  const uint8_t* q;                 // (G, rows, N)
  const float* s;                   // (G, 1, N)
  void* o;                          // (M, Kq), fp32 or bf16: splits == 1
  float* ws;                        // splits > 1: (splits, M, Kq) partials
  int M, Kq, N, bshift, unit;       // block = 1 << bshift; unit: N granule
  bool out_f32;
  bool g_vec, w_vec;                // 16-byte cp.async for g / payload+scales
};

// Stage N-tile [n0, n0 + BK) (of the split ending at ne) of g rows m0..
// and of W rows kb0.. into one ring slot: payload row j of the (G, rows,
// N) layout is weight row j * RSTEP, so the block's payload is QROWS
// consecutive rows from kb0 / RSTEP, 32 bytes of each; the scale row of
// weight row k is k >> bshift. Zero fill past M, ne (<= N) and Kq;
// N % 8 != 0 (g) or N % 16 != 0 (payload, scales) take element copies.
template <int FMT>
__device__ __forceinline__ void load_tile(const Args& p, uint8_t* st, int m0,
                                          int kb0, int n0, int ne) {
  using L = Layout<FMT>;
  const int tid = threadIdx.x;
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(st + L::G);
  uint8_t* qs = st + L::Q;
  float* ss = reinterpret_cast<float*>(st + L::S);
  if (p.g_vec) {                    // N % 8 == 0: a chunk is all in or out
#pragma unroll
    for (int e = 0; e < L::GCH; ++e) {
      const int i = tid + e * NT, row = i >> 2, c = (i & 3) * 8;
      const int m = m0 + row, n = n0 + c;
      const bool ok = m < p.M && n < ne;
      tc::cp_async16(gs + row * LDG + c, ok ? p.g + (size_t)m * p.N + n : p.g,
                     ok);
    }
  } else {
    for (int i = tid; i < BM * BK; i += NT) {
      const int row = i / BK, c = i % BK, m = m0 + row, n = n0 + c;
      gs[row * LDG + c] = (m < p.M && n < ne) ? p.g[(size_t)m * p.N + n]
                                              : __float2bfloat16(0.f);
    }
  }
  const int g0 = kb0 >> p.bshift;
  const int nsr = p.bshift >= 7 ? 1 : BN >> p.bshift;  // scale rows
  if (p.w_vec) {                    // N % 16 == 0
    if (tid < L::QCH) {
      const int pr = tid >> 1, c = (tid & 1) * 16, n = n0 + c;
      const bool ok = kb0 + L::RSTEP * pr < p.Kq && n < ne;
      tc::cp_async16(
          qs + pr * BK + c,
          ok ? p.q + (size_t)(kb0 / L::RSTEP + pr) * p.N + n : p.q, ok);
    }
    if (tid < nsr * 8) {
      const int sr = tid >> 3, c = (tid & 7) * 4, n = n0 + c;
      const bool ok = n < ne && ((g0 + sr) << p.bshift) < p.Kq;
      tc::cp_async16(ss + sr * BK + c,
                     ok ? p.s + (size_t)(g0 + sr) * p.N + n : p.s, ok);
    }
  } else {
    for (int i = tid; i < L::QROWS * BK; i += NT) {
      const int pr = i / BK, n = n0 + i % BK;
      qs[i] = (kb0 + L::RSTEP * pr < p.Kq && n < ne)
                  ? p.q[(size_t)(kb0 / L::RSTEP + pr) * p.N + n]
                  : (uint8_t)0;
    }
    for (int i = tid; i < nsr * BK; i += NT) {
      const int sr = i / BK, n = n0 + i % BK;
      const bool ok = n < ne && ((g0 + sr) << p.bshift) < p.Kq;
      tc::cp_async4(ss + i, ok ? p.s + (size_t)(g0 + sr) * p.N + n : p.s,
                    ok);
    }
  }
}

template <int FMT>
__device__ __forceinline__ void decode(const Args& p, const uint8_t* st,
                                       __nv_bfloat16* wb, const float* code,
                                       int kb0, int part) {
  using L = Layout<FMT>;
  tt::decode_words<FMT, BN, BK, LDW, NT, true>(
      st + L::Q, reinterpret_cast<const float*>(st + L::S), wb, code, kb0,
      p.Kq, p.bshift, part);
}

// dx tile (m0.., kb0..) of split z = sum over its N-tiles of
// g_tile @ (W hi + W lo)_tile^T: two mma passes, fp32 accumulators.
template <int FMT>
__global__ void __launch_bounds__(NT, 1) qmt_tc_kernel(const Args p) {
  using L = Layout<FMT>;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem + L::WB);
  float* code = reinterpret_cast<float*>(smem + L::CODE);
  dq::load_codebook(code);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int kb0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  // this split's contraction range: whole units of BK columns of N
  const int nu = (p.N + p.unit - 1) / p.unit, z = blockIdx.z;
  const int nb = (int)((long long)z * nu / gridDim.z) * p.unit;
  const int ne = min((int)((long long)(z + 1) * nu / gridDim.z) * p.unit,
                     p.N);
  const int ntile = ne > nb ? (ne - nb + BK - 1) / BK : 0;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < ntile)
      load_tile<FMT>(p, smem + t * L::STAGE, m0, kb0, nb + t * BK, ne);
    tc::cp_commit();                // one group per tile, empty or not
  }
  tc::cp_wait<NS - 2>();
  __syncthreads();                  // tile 0 and the codebook are in
  if (ntile > 0)
    for (int part = 0; part < 2; ++part)
      decode<FMT>(p, smem, wbuf, code, kb0, part);

  for (int t = 0; t < ntile; ++t) {
    tc::cp_wait<NS - 3>();          // tile t + 1 has landed
    __syncthreads();                // tile t decoded; tile t - 1 consumed
    if (t + NS - 1 < ntile)
      load_tile<FMT>(p, smem + ((t + NS - 1) % NS) * L::STAGE, m0, kb0,
                     nb + (t + NS - 1) * BK, ne);
    tc::cp_commit();
    const __nv_bfloat16* gs =
        reinterpret_cast<const __nv_bfloat16*>(smem + (t % NS) * L::STAGE);
    const __nv_bfloat16* wb = wbuf + (t & 1) * 2 * BN * LDW;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tc::frag_a(af[i], gs, LDG, wm * 64 + i * 16, kk * 16, lane);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t bh[4], bl[4];          // W's hi and lo parts, [n][k]
        tc::frag_b_nk(bh, wb, LDW, wn * 32 + jj * 16, kk * 16, lane);
        tc::frag_b_nk(bl, wb + BN * LDW, LDW, wn * 32 + jj * 16, kk * 16,
                      lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tc::mma_bf16(acc[i][2 * jj], af[i], bh[0], bh[1]);
          tc::mma_bf16(acc[i][2 * jj], af[i], bl[0], bl[1]);
          tc::mma_bf16(acc[i][2 * jj + 1], af[i], bh[2], bh[3]);
          tc::mma_bf16(acc[i][2 * jj + 1], af[i], bl[2], bl[3]);
        }
      }
      if (t + 1 < ntile)            // decode the next tile meanwhile
        decode<FMT>(p, smem + ((t + 1) % NS) * L::STAGE,
                    wbuf + ((t + 1) & 1) * 2 * BN * LDW, code, kb0, kk);
    }
  }

  // Kq is a multiple of the block (>= 16), so a column pair k, k + 1 is
  // all in or all out
  float* part = gridDim.z > 1 ? p.ws + (size_t)z * p.M * p.Kq : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = kb0 + wn * 32 + j * 8 + c2;
        if (k >= p.Kq) continue;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        const size_t o = (size_t)m * p.Kq + k;
        if (part != nullptr)
          *reinterpret_cast<float2*>(part + o) = make_float2(v0, v1);
        else if (p.out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(p.o) + o) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.o) +
                                       o) = tc::pack_bf16(v0, v1);
      }
    }
}

template <int FMT>
cudaError_t launch(const Args& p, int splits, cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmt_tc_kernel<FMT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<FMT>::BYTES);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((p.Kq + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  qmt_tc_kernel<FMT><<<grid, NT, Layout<FMT>::BYTES, st>>>(p);
  return cudaGetLastError();
}

}  // namespace qmt

template <int FMT>
cudaError_t lora_fmt(const void* x, const void* q, const void* s,
                     const void* a, const void* b, void* y, int M, int K,
                     int Kq, int N, int r, int block, int rows, float scale,
                     cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (r <= 16)
    lora_kernel<FMT, 16><<<grid, NT, 0, st>>>(
        (const float*)x, (const uint8_t*)q, (const float*)s, (const float*)a,
        (const float*)b, (float*)y, M, K, Kq, N, r, block, rows, scale);
  else
    lora_kernel<FMT, 32><<<grid, NT, 0, st>>>(
        (const float*)x, (const uint8_t*)q, (const float*)s, (const float*)a,
        (const float*)b, (float*)y, M, K, Kq, N, r, block, rows, scale);
  return cudaGetLastError();
}

cudaError_t lora_f32(int fmt, const void* x, const void* q, const void* s,
                     const void* a, const void* b, void* y, int M, int K,
                     int Kq, int N, int r, int block, int rows, float scale,
                     cudaStream_t st) {
  switch (fmt) {
    case FMT_INT8:
      return lora_fmt<FMT_INT8>(x, q, s, a, b, y, M, K, Kq, N, r, block, rows, scale, st);
    case FMT_INT4:
      return lora_fmt<FMT_INT4>(x, q, s, a, b, y, M, K, Kq, N, r, block, rows, scale, st);
    case FMT_NF4:
      return lora_fmt<FMT_NF4>(x, q, s, a, b, y, M, K, Kq, N, r, block, rows, scale, st);
  }
  return cudaErrorInvalidValue;
}

cudaError_t qmt_f32(int fmt, const void* g, const void* q, const void* s,
                    void* o, int M, int Kq, int N, int block, int rows,
                    cudaStream_t st) {
  const dim3 grid((Kq + BN - 1) / BN, (M + BM - 1) / BM);
  switch (fmt) {
    case FMT_INT8:
      qmt_kernel<FMT_INT8><<<grid, NT, 0, st>>>(
          (const float*)g, (const uint8_t*)q, (const float*)s, (float*)o, M, Kq, N, block, rows);
      break;
    case FMT_INT4:
      qmt_kernel<FMT_INT4><<<grid, NT, 0, st>>>(
          (const float*)g, (const uint8_t*)q, (const float*)s, (float*)o, M, Kq, N, block, rows);
      break;
    case FMT_NF4:
      qmt_kernel<FMT_NF4><<<grid, NT, 0, st>>>(
          (const float*)g, (const uint8_t*)q, (const float*)s, (float*)o, M, Kq, N, block, rows);
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

// fp32 x, y: the CUDA-core kernel. fmt: 0 int8, 1 int4 (packed), 2 NF4
// (packed); a and b are fp32. K is x's true width, Kq = G * block >= K.
extern "C" int lora_matmul_launch(const void* x, const void* q, const void* s,
                                  const void* a, const void* b, void* y,
                                  int M, int K, int Kq, int N, int r,
                                  int block, int rows, int fmt, float scale,
                                  void* stream) {
  if (M < 1 || N < 1 || K < 1 || K > Kq || r < 1 || r > 32 ||
      (M + BM - 1) / BM > 65535 || bad_layout(fmt, Kq, block, rows))
    return (int)cudaErrorInvalidValue;
  return (int)lora_f32(fmt, x, q, s, a, b, y, M, K, Kq, N, r, block, rows,
                       scale, (cudaStream_t)stream);
}

// bf16 x, y: the tensor-core kernel, then (splits > 1) splitk_sum over
// the fp32 workspace ws (splits, M, N). a is (K, RP) fp32 with r
// zero-padded to RP = 16 (r <= 16) or 32; block is a power of two >= 16;
// unit, the split granule, is a multiple of both block and 32
// (kernels/lora_matmul.plan).
extern "C" int lora_matmul_tc_launch(const void* x, const void* q,
                                     const void* s, const void* a,
                                     const void* b, void* y, void* ws, int M,
                                     int K, int Kq, int N, int r, int block,
                                     int rows, int fmt, float scale,
                                     int splits, int unit, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K > Kq || r < 1 || r > 32 ||
      (M + lt::BM - 1) / lt::BM > 65535 || bad_layout(fmt, Kq, block, rows) ||
      block < lt::MIN_BLOCK || (block & (block - 1)) || splits < 1 ||
      splits > 64 || unit < 1 || unit % lt::BK || unit % block ||
      (splits > 1 && ws == nullptr) || (uintptr_t)a % 16)
    return (int)cudaErrorInvalidValue;
  lt::Args p;
  p.x = (const __nv_bfloat16*)x;
  p.q = (const uint8_t*)q;
  p.s = (const float*)s;
  p.a = (const float*)a;
  p.b = (const float*)b;
  p.y = (__nv_bfloat16*)y;
  p.ws = (float*)ws;
  p.M = M; p.K = K; p.Kq = Kq; p.N = N; p.r = r;
  p.bshift = __builtin_ctz(block); p.unit = unit; p.scale = scale;
  p.x_vec = K % 8 == 0 && (uintptr_t)x % 16 == 0;
  p.w_vec = N % 16 == 0 && ((uintptr_t)q | (uintptr_t)s) % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  switch (fmt) {
    case FMT_INT8: err = lt::launch_fmt<FMT_INT8>(p, splits, st); break;
    case FMT_INT4: err = lt::launch_fmt<FMT_INT4>(p, splits, st); break;
    case FMT_NF4: err = lt::launch_fmt<FMT_NF4>(p, splits, st); break;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)tt::sum_splits((const float*)ws, (__nv_bfloat16*)y,
                             (long long)M * N, splits, st);
}

// fp32 g, o: the CUDA-core kernel. g (M, N) -> o (M, Kq).
extern "C" int quant_matmul_t_launch(const void* g, const void* q,
                                     const void* s, void* o, int M, int Kq,
                                     int N, int block, int rows, int fmt,
                                     void* stream) {
  if (M < 1 || N < 1 || Kq < 1 || (M + BM - 1) / BM > 65535 ||
      bad_layout(fmt, Kq, block, rows))
    return (int)cudaErrorInvalidValue;
  return (int)qmt_f32(fmt, g, q, s, o, M, Kq, N, block, rows,
                      (cudaStream_t)stream);
}

// bf16 g: the tensor-core kernel, g (M, N) -> o (M, Kq) in fp32
// (out_f32) or bf16, then (splits > 1) splitk_sum over the fp32
// workspace ws (splits, M, Kq). block is a power of two >= 16; unit, the
// split granule along N, is a multiple of 32 (kernels/lora_matmul.plan_t).
extern "C" int quant_matmul_t_tc_launch(const void* g, const void* q,
                                        const void* s, void* o, void* ws,
                                        int M, int Kq, int N, int block,
                                        int rows, int fmt, int out_f32,
                                        int splits, int unit, void* stream) {
  if (M < 1 || N < 1 || Kq < 1 || (M + qmt::BM - 1) / qmt::BM > 65535 ||
      bad_layout(fmt, Kq, block, rows) || block < qmt::MIN_BLOCK ||
      (block & (block - 1)) || splits < 1 || splits > 64 || unit < 1 ||
      unit % qmt::BK || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  qmt::Args p;
  p.g = (const __nv_bfloat16*)g;
  p.q = (const uint8_t*)q;
  p.s = (const float*)s;
  p.o = o;
  p.ws = (float*)ws;
  p.M = M; p.Kq = Kq; p.N = N;
  p.bshift = __builtin_ctz(block); p.unit = unit;
  p.out_f32 = out_f32 != 0;
  p.g_vec = N % 8 == 0 && (uintptr_t)g % 16 == 0;
  p.w_vec = N % 16 == 0 && ((uintptr_t)q | (uintptr_t)s) % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  switch (fmt) {
    case FMT_INT8: err = qmt::launch<FMT_INT8>(p, splits, st); break;
    case FMT_INT4: err = qmt::launch<FMT_INT4>(p, splits, st); break;
    case FMT_NF4: err = qmt::launch<FMT_NF4>(p, splits, st); break;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long mn = (long long)M * Kq;
  return p.out_f32
             ? (int)tt::sum_splits((const float*)ws, (float*)o, mn, splits, st)
             : (int)tt::sum_splits((const float*)ws, (__nv_bfloat16*)o, mn,
                                   splits, st);
}
