// The fp32 quantized-weight GEMMs on Hopper's tensor cores in the 3xTF32
// split, shared by quant_matmul.cu's qmm_tf32_kernel (y = x @ W, the
// contraction along W's rows Kq) and lora_matmul.cu's qmt_tf32_kernel
// (dx = g @ W^T, the contraction along W's columns N) and
// lora_tf32_kernel (y = x @ W + scale (x @ A) @ B): one body, with W's
// tile read straight (TRANS false) or turned over (TRANS true), and with
// RP > 0 the rank-r term carried beside it.
//
//   A (T, M, C) fp32 row-major: x (C = Kq) or g (C = N)
//   W (T, G, rows, N) quantized, scales (T, G, 1, N): the QTensor layout
//   out (T, M, O) fp32: O = N (y) or Kq (dx)
//
//  - mma.sync.m16n8k8 with TF32 operands and fp32 accumulators
//    (mma.cuh's mma_tf32, split_tf32): each fp32 operand v enters as hi =
//    tf32_rna(v) and lo = tf32_rna(v - hi), each product as lo hi + hi lo
//    + hi hi in that order, so fp32 callers keep 1e-5 (about 22 bits of
//    each operand where one TF32 pass keeps 11). A tensor-core chain is
//    CHAIN k8 steps long (one 32-deep k-tile), started from zero, and the
//    chains are added in fp32 on the CUDA cores: the tensor cores' own
//    adds do not round to nearest, and a chain over all of K drifts past
//    1e-5 (flash_attention.cu's 3xTF32 route found it at 1500 keys).
//  - Decode once per block: each k-tile's weights are decoded once into
//    shared memory as TF32 hi and lo tiles (tc_tile.cuh's decode_words:
//    code * fp32 scale, the plain version's product, then split), which
//    every warp of the block reads; W is never written dense. The decode
//    of tile t + 1 is interleaved with tile t's k8 steps (double-buffered
//    tiles, one barrier a tile). A is split in registers as its fragment
//    is read (4 values a lane a k8 step), so its tile holds fp32 once.
//  - A, the packed payload and the scale rows are staged by cp.async in
//    a ring of 16-byte chunks (stage_rows, stage_w), zero past M, the
//    split's end, Kq and N (element copies where C % 4 or N % 16 != 0).
//  - Bank-conflict-free fragments by padding: A [BM][36] fp32 (rows g,
//    columns c: banks 4 g + c), W [32][136] for y (k rows c, columns g:
//    banks 8 c + g) and [128][36] for dx (rows g, columns c).
//  - The row tile and the split come from the wrapper's plan
//    (kernels/quant_matmul.plan_tf32): BM = 32 (two m16 rows) for the
//    tens of rows of the MoE's expert products, 128 past them. Where the
//    output tiles do not fill the 132 SMs (12 column tiles at 20 x 4096 x
//    1536) the contraction is split on whole quant groups and whole
//    k-tiles (unit); each split writes fp32 partials to an (splits, T, M,
//    O) workspace that splitk_sum adds in split order: no atomics, two
//    calls bitwise equal.
//  - mma.sync, not wgmma: at the 20-row products the call is bound by
//    reading W and by filling the SMs, not by the tensor rate.
//  - The rank-r term (RP = r padded to 16 or 32 with zero columns; only
//    TRANS false): each k-tile's rows of A (K, RP) ride the same cp.async
//    ring, and after the tile's W chains each warp adds its units of h =
//    x @ A (an m16 row fragment by an n8 column block) as chains of the
//    same 4 k8 steps and 3 products, x split again from the staged tile
//    and A as its fragment is read, into an fp32 h tile [BM][RP + 8] in
//    shared memory that only that warp touches. h lives in shared memory,
//    not registers: the BM = 128 body already holds 242-253 registers.
//    After the loop B's (RP x 128) tile takes the drained ring and each
//    thread adds scale * (h @ B) (its own fp32 sum over r, as the Pallas
//    kernel's flush adds scale * delta) to its accumulators. A split adds
//    its own scale * (h_s @ B): the term is linear in h.
#pragma once

#include "tc_tile.cuh"

namespace tg {

using tt::BK;                       // contraction a k-tile (32)
constexpr int BO = 128;             // output columns a block
constexpr int NT = 256;             // threads: 8 warps
constexpr int KSTEP = 8;            // m16n8k8: contraction an mma
constexpr int CHAIN = BK / KSTEP;   // k8 steps a tensor-core chain
constexpr int LDA = BK + 4;         // fp32 strides padded by 16 bytes:
constexpr int LDWN = BO + 8;        // the fragments' reads hit 32 banks
constexpr int LDWT = BK + 4;
constexpr int MAX_SPLITS = 64;

// A row tile of BM rows: WM x WN warps, each (BM / WM) x (BO / WN), an
// NS-deep cp.async ring and MINB blocks an SM (shared memory; registers
// at BM = 128: two accumulator sets of 64)
template <int BM>
struct Cfg {
  static constexpr int WM = BM == 128 ? 4 : 2;
  static constexpr int WN = 8 / WM;
  static constexpr int MI = BM / WM / 16;       // m16 fragments a warp
  static constexpr int NJ = BO / WN / 8;        // n8 blocks a warp
  static constexpr int NS = BM == 128 ? 3 : 4;
  static constexpr int MINB = BM == 128 ? 1 : 2;
  static_assert(BM == 32 || BM == 128, "row tile");
};

// Byte offsets of one block's shared memory. W's tile: WR weight rows
// (of Kq) by WC columns (of N), decoded [WR][LDW] as u32 TF32 patterns.
// RP > 0 adds A's rows to each ring slot and the h tile; RP = 0 is the
// plain GEMM's layout.
template <int FMT, int BM, bool TRANS, int RP = 0>
struct Layout {
  static constexpr int RSTEP = FMT == dq::FMT_INT8 ? 1 : 2;
  static constexpr int WR = TRANS ? BO : BK;
  static constexpr int WC = TRANS ? BK : BO;
  static constexpr int LDW = TRANS ? LDWT : LDWN;
  static constexpr int LDL = RP + 8;                 // A rows and h: the
                                                     // fragments' banks
  static constexpr int SRM = WR / tt::MIN_BLOCK;     // scale rows at most
  static constexpr int A = 0;                        // f32 [BM][LDA]
  static constexpr int Q = A + BM * LDA * 4;         // u8 [WR / RSTEP][WC]
  static constexpr int S = Q + WR / RSTEP * WC;      // f32 [SRM][WC]
  static constexpr int LA = S + SRM * WC * 4;        // f32 [BK][LDL]: A
  static constexpr int STAGE = LA + (RP ? BK * LDL * 4 : 0);
  static constexpr int WTILE = 2 * WR * LDW;         // u32: hi, then lo
  static constexpr int WB = Cfg<BM>::NS * STAGE;     // [2][WTILE]
  static constexpr int CODE = WB + 2 * WTILE * 4;    // f32 [16]
  static constexpr int H = CODE + 16 * 4;            // f32 [BM][LDL]: h
  static constexpr int BYTES = H + (RP ? BM * LDL * 4 : 0);
  static_assert(STAGE % 16 == 0 && WB % 16 == 0, "align");
  static_assert((BYTES + 1024) * Cfg<BM>::MINB <= 233472, "blocks an SM");
  static_assert(RP == 0 || RP == 16 || RP == 32, "rank padded to 16 / 32");
  static_assert(RP == 0 || (!TRANS && RP * BO * 4 <= WB &&
                            BK * RP / 4 <= NT), "the rank-r term");
};

struct Args {
  const float* a;                   // (T, M, C)
  const uint8_t* q;                 // (T, G, rows, N)
  const float* s;                   // (T, G, 1, N)
  float* y;                         // (T, M, O) when splits == 1
  float* ws;                        // splits > 1: (splits, T, M, O)
  int T, M, C, O, Kq, N, rows, bshift, unit, splits;  // block 1 << bshift
  bool a_vec, w_vec;                // 16-byte cp.async for A / payload
  // the rank-r term (RP > 0; T = 1): la (C, RP) fp32, r zero-padded to
  // RP, 16-byte aligned; lb (r, O) fp32
  const float* la = nullptr;
  const float* lb = nullptr;
  int r = 0;
  float scale = 0.f;
};

// The output tile (m0.., o0..) of user t, split z: the sum over the
// split's k-tiles of chains of 3xTF32 products, in fp32, and with RP > 0
// scale * (h_z @ B), h_z = x @ A over the same k-tiles in the same
// chains. Grid (O tiles, M tiles, T * splits); the caller's __global__
// sets the launch bounds.
template <int FMT, int BM, bool TRANS, int RP = 0>
__device__ __forceinline__ void gemm_tf32(const Args& p) {
  using C = Cfg<BM>;
  using L = Layout<FMT, BM, TRANS, RP>;
  constexpr int NS = C::NS, LDW = L::LDW;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* wbuf = reinterpret_cast<uint32_t*>(smem + L::WB);
  float* code = reinterpret_cast<float*>(smem + L::CODE);
  dq::load_codebook(code);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int g = lane >> 2, c4 = lane & 3, c2 = 2 * c4;
  const int o0 = blockIdx.x * BO, m0 = blockIdx.y * BM;
  const int t = blockIdx.z / p.splits, z = blockIdx.z - t * p.splits;
  const int G = p.Kq >> p.bshift;
  const float* a = p.a + (size_t)t * p.M * p.C;
  const uint8_t* q = p.q + (size_t)t * G * p.rows * p.N;
  const float* s = p.s + (size_t)t * G * p.N;
  // this split's contraction range: whole units (quant groups, k-tiles)
  const int nu = (p.C + p.unit - 1) / p.unit;
  const int kb = (int)((long long)z * nu / p.splits) * p.unit;
  const int ke = min((int)((long long)(z + 1) * nu / p.splits) * p.unit,
                     p.C);
  const int ntile = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  auto stage = [&](int slot, int k0) {
    uint8_t* st = smem + slot * L::STAGE;
    float* ss = reinterpret_cast<float*>(st + L::S);
    tt::stage_rows<float, BM, NT, LDA>(a, p.C, p.M, ke, p.a_vec,
                                       reinterpret_cast<float*>(st + L::A),
                                       m0, k0);
    if (TRANS)    // W rows o0.. (of Kq), columns k0.. (of N) to ke
      tt::stage_w<FMT, L::WR, L::WC, NT>(q, s, p.N, p.bshift, p.w_vec,
                                         st + L::Q, ss, o0, p.Kq, k0, ke);
    else          // W rows k0.. to ke, columns o0.. (of N)
      tt::stage_w<FMT, L::WR, L::WC, NT>(q, s, p.N, p.bshift, p.w_vec,
                                         st + L::Q, ss, k0, ke, o0, p.N);
    if constexpr (RP > 0) {   // A rows k0.. to ke: RP / 4 chunks a row
      if (tid < BK * RP / 4) {
        const int kk = tid / (RP / 4), c = (tid % (RP / 4)) * 4;
        const bool ok = k0 + kk < ke;
        tc::cp_async16(reinterpret_cast<float*>(st + L::LA) + kk * L::LDL + c,
                       ok ? p.la + (size_t)(k0 + kk) * RP + c : p.la, ok);
      }
    }
  };
  auto decode = [&](int slot, uint32_t* wb, int k0, int part) {
    const uint8_t* st = smem + slot * L::STAGE;
    const float* ss = reinterpret_cast<const float*>(st + L::S);
    tt::decode_words<FMT, L::WR, L::WC, LDW, NT, true, uint32_t>(
        st + L::Q, ss, wb, code, TRANS ? o0 : k0, TRANS ? p.Kq : ke,
        p.bshift, part);
  };
  float acc[C::MI][C::NJ][4];
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if constexpr (RP > 0) {
    float* hs = reinterpret_cast<float*>(smem + L::H);
    for (int i = tid; i < BM * L::LDL; i += NT) hs[i] = 0.f;
  }
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
    const float* as =
        reinterpret_cast<const float*>(smem + (u % NS) * L::STAGE + L::A);
    const uint32_t* wh = wbuf + (u & 1) * L::WTILE;
    const uint32_t* wl = wh + L::WR * LDW;
    float ch[C::MI][C::NJ][4];      // this k-tile's chain, from zero
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ch[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < CHAIN; ++kk) {
      const int k = kk * KSTEP;
      uint32_t ah[C::MI][4], al[C::MI][4];
#pragma unroll
      for (int i = 0; i < C::MI; ++i) {   // (g, c) (g+8, c) (g, c+4) (g+8, c+4)
        const float* ar = as + (wm * (BM / C::WM) + i * 16 + g) * LDA + k + c4;
        tc::split_tf32(ar[0], ah[i][0], al[i][0]);
        tc::split_tf32(ar[8 * LDA], ah[i][1], al[i][1]);
        tc::split_tf32(ar[4], ah[i][2], al[i][2]);
        tc::split_tf32(ar[8 * LDA + 4], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {   // B (k c, n g) and (k c+4, n g)
        const int o = wn * (BO / C::WN) + j * 8 + g;
        const int i0 = TRANS ? o * LDW + k + c4 : (k + c4) * LDW + o;
        const int i1 = TRANS ? i0 + 4 : i0 + 4 * LDW;
        const uint32_t bh[2] = {wh[i0], wh[i1]}, bl[2] = {wl[i0], wl[i1]};
#pragma unroll
        for (int i = 0; i < C::MI; ++i) {
          tc::mma_tf32(ch[i][j], al[i], bh);
          tc::mma_tf32(ch[i][j], ah[i], bl);
          tc::mma_tf32(ch[i][j], ah[i], bh);
        }
      }
      if ((kk & 1) && u + 1 < ntile)  // decode the next tile meanwhile
        decode((u + 1) % NS, wbuf + ((u + 1) & 1) * L::WTILE,
               kb + (u + 1) * BK, kk >> 1);
    }
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += ch[i][j][e];
    if constexpr (RP > 0) {         // h += this k-tile's chains of x @ A
      constexpr int NB = RP / 8, UNITS = C::MI * NB;
      const float* ls = reinterpret_cast<const float*>(
          smem + (u % NS) * L::STAGE + L::LA);
      float* hs = reinterpret_cast<float*>(smem + L::H);
#pragma unroll
      for (int e = 0; e < (UNITS + C::WN - 1) / C::WN; ++e) {
        const int un = wn + e * C::WN;  // a unit: m16 fragment i, n8 block
        if (un >= UNITS) break;
        const int i = un / NB, jn = un % NB;
        const int row = wm * (BM / C::WM) + i * 16 + g;
        float hc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < CHAIN; ++kk) {
          const int k = kk * KSTEP;
          uint32_t ah[4], al[4], bh[2], bl[2];
          const float* ar = as + row * LDA + k + c4;
          tc::split_tf32(ar[0], ah[0], al[0]);
          tc::split_tf32(ar[8 * LDA], ah[1], al[1]);
          tc::split_tf32(ar[4], ah[2], al[2]);
          tc::split_tf32(ar[8 * LDA + 4], ah[3], al[3]);
          const float* br = ls + (k + c4) * L::LDL + jn * 8 + g;
          tc::split_tf32(br[0], bh[0], bl[0]);
          tc::split_tf32(br[4 * L::LDL], bh[1], bl[1]);
          tc::mma_tf32(hc, al, bh);
          tc::mma_tf32(hc, ah, bl);
          tc::mma_tf32(hc, ah, bh);
        }
        float2* h0 = reinterpret_cast<float2*>(hs + row * L::LDL + jn * 8 + c2);
        float2* h1 = h0 + 4 * L::LDL;   // row + 8
        float2 v0 = *h0, v1 = *h1;
        v0.x += hc[0];
        v0.y += hc[1];
        v1.x += hc[2];
        v1.y += hc[3];
        *h0 = v0;
        *h1 = v1;
      }
    }
  }
  tc::cp_wait<0>();                 // no copy outlives the block

  if constexpr (RP > 0) {           // acc += scale * (h @ B), in fp32
    __syncthreads();                // h is whole; the ring is drained
    float* bs = reinterpret_cast<float*>(smem);      // [RP][BO]
    const float* hs = reinterpret_cast<const float*>(smem + L::H);
    for (int i = tid; i < RP * BO; i += NT) {
      const int c = i / BO, o = o0 + i % BO;
      bs[i] = (c < p.r && o < p.O) ? p.lb[(size_t)c * p.O + o] : 0.f;
    }
    __syncthreads();
    float d[C::MI][C::NJ][4];
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[i][j][e] = 0.f;
    for (int c = 0; c < p.r; ++c) {
      float hv[C::MI][2], bv[C::NJ][2];
#pragma unroll
      for (int i = 0; i < C::MI; ++i) {
        const int row = wm * (BM / C::WM) + i * 16 + g;
        hv[i][0] = hs[row * L::LDL + c];
        hv[i][1] = hs[(row + 8) * L::LDL + c];
      }
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
        const float2 b2 = *reinterpret_cast<const float2*>(
            bs + c * BO + wn * (BO / C::WN) + j * 8 + c2);
        bv[j][0] = b2.x;
        bv[j][1] = b2.y;
      }
#pragma unroll
      for (int i = 0; i < C::MI; ++i)
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) {
          d[i][j][0] = fmaf(hv[i][0], bv[j][0], d[i][j][0]);
          d[i][j][1] = fmaf(hv[i][0], bv[j][1], d[i][j][1]);
          d[i][j][2] = fmaf(hv[i][1], bv[j][0], d[i][j][2]);
          d[i][j][3] = fmaf(hv[i][1], bv[j][1], d[i][j][3]);
        }
    }
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += p.scale * d[i][j][e];
  }

  const bool pairs = (p.O & 1) == 0;
  const size_t base = (size_t)t * p.M * p.O;
  float* out = p.splits > 1 ? p.ws + (size_t)z * p.T * p.M * p.O + base
                            : p.y + base;
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * (BM / C::WM) + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
        const int o = o0 + wn * (BO / C::WN) + j * 8 + c2;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        float* dst = out + (size_t)m * p.O + o;
        if (pairs && o + 1 < p.O) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (o < p.O) dst[0] = v0;
          if (o + 1 < p.O) dst[1] = v1;
        }
      }
    }
}

// Set a kernel instance's shared memory once: BYTES of dynamic shared
// memory (past the default 48 KB) and the carveout that fits MINB blocks.
template <typename Kernel>
cudaError_t set_smem(Kernel kern, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done = true;
  return e;
}

}  // namespace tg
