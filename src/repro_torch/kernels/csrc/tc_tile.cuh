// Tensor-core tile pieces shared by the port's bf16 quantized-weight
// kernels: lora_matmul.cu's lora_tc_kernel and qmt_tc_kernel, and
// quant_matmul.cu's qmm_tc_kernel.
//
//   stage_xqs     cp.async staging of one 32-deep k-tile: BM rows of bf16
//                 x, the packed payload's rows of a 128-column tile and
//                 the scale rows the tile touches, as 16-byte chunks
//                 (element copies where K % 8 != 0 or N % 16 != 0), zero
//                 past M, K, the split's end and N
//   decode_words  a staged quantized tile into bf16 weight tiles in
//                 shared memory (code * fp32 scale, then bf16: one part,
//                 or a hi and a lo part for two mma passes)
//   splitk_sum    the split-K partials added in split order: no atomics
//
// Each kernel passes its own thread count (NTH), so a block of 256 or
// 512 threads runs the same code; the tile's width (BN = 128 columns) and
// depth (BK = 32) are fixed here.
#pragma once

#include "dequant.cuh"
#include "mma.cuh"

namespace tt {

constexpr int BN = 128;             // output columns a block
constexpr int BK = 32;              // contraction depth a k-tile
constexpr int SR = 2;               // scale rows per tile (2 when block 16)
constexpr int MIN_BLOCK = 16;       // block: a power of two >= 16
constexpr int LDX = BK + 8;         // bf16 strides padded by 16 bytes:
constexpr int LDW = BN + 8;         // ldmatrix rows hit distinct banks

// Stage k-tile [k0, k0 + BK) of the split ending at ke into one ring
// slot: x rows m0 .. m0 + BM into xs [BM][LDX] (bf16), the payload rows
// of weight rows k0.. into qs [BK / RSTEP][BN] (payload row j of the (G,
// rows, N) layout is weight row j * RSTEP, so a tile's payload is
// consecutive rows from k0 / RSTEP) and the scale rows into ss [SR][BN]
// (the scale row of weight row k is k >> bshift). Each thread copies a
// fixed, unrolled set of 16-byte chunks. Zero fill past M, K, ke and N;
// x_vec false (K % 8 != 0) or w_vec false (N % 16 != 0) take element
// copies instead.
template <int FMT, int BM, int NTH>
__device__ __forceinline__ void stage_xqs(
    const __nv_bfloat16* x, const uint8_t* q, const float* s, int M, int K,
    int N, int bshift, bool x_vec, bool w_vec, __nv_bfloat16* xs,
    uint8_t* qs, float* ss, int m0, int n0, int k0, int ke) {
  constexpr int RSTEP = FMT == dq::FMT_INT8 ? 1 : 2;  // weight rows a byte
  constexpr int QROWS = BK / RSTEP;                   // payload rows a tile
  constexpr int XC = BM * BK / 8;                     // x chunks a tile
  constexpr int XCH = (XC + NTH - 1) / NTH;           // ... a thread
  constexpr int QCH = QROWS * BN / 16;                // threads tid < QCH
  static_assert(BK == 32 && BN == 128 && QCH <= NTH && SR * BN / 4 <= NTH,
                "chunks");
  const int tid = threadIdx.x;
  const int kx = min(K, ke);
  if (x_vec) {                      // K % 8 == 0: a chunk is all in or out
#pragma unroll
    for (int e = 0; e < XCH; ++e) {
      const int i = tid + e * NTH, row = i >> 2, c = (i & 3) * 8;
      if (XC % NTH == 0 || i < XC) {
        const int m = m0 + row, k = k0 + c;
        const bool ok = m < M && k < kx;
        tc::cp_async16(xs + row * LDX + c, ok ? x + (size_t)m * K + k : x,
                       ok);
      }
    }
  } else {
    for (int i = tid; i < BM * BK; i += NTH) {
      const int row = i / BK, c = i % BK, m = m0 + row, k = k0 + c;
      xs[row * LDX + c] = (m < M && k < kx) ? x[(size_t)m * K + k]
                                            : __float2bfloat16(0.f);
    }
  }
  const int g0 = k0 >> bshift;
  const int nsr = bshift >= 5 ? 1 : SR;            // block 16: two groups
  if (w_vec) {                      // N % 16 == 0
    if (tid < QCH) {
      const int pr = tid >> 3, c = (tid & 7) * 16, n = n0 + c;
      const bool ok = k0 + RSTEP * pr < ke && n < N;
      tc::cp_async16(qs + pr * BN + c,
                     ok ? q + (size_t)(k0 / RSTEP + pr) * N + n : q, ok);
    }
    if (tid < nsr * BN / 4) {
      const int sr = tid >> 5, c = (tid & 31) * 4, n = n0 + c;
      const bool ok = n < N && ((g0 + sr) << bshift) < ke;
      tc::cp_async16(ss + sr * BN + c,
                     ok ? s + (size_t)(g0 + sr) * N + n : s, ok);
    }
  } else {
    for (int i = tid; i < QROWS * BN; i += NTH) {
      const int pr = i / BN, c = i % BN, n = n0 + c;
      qs[i] = (k0 + RSTEP * pr < ke && n < N)
                  ? q[(size_t)(k0 / RSTEP + pr) * N + n]
                  : (uint8_t)0;
    }
    for (int i = tid; i < nsr * BN; i += NTH) {
      const int n = n0 + i % BN;
      const bool ok = n < N && ((g0 + i / BN) << bshift) < ke;
      tc::cp_async4(ss + i, ok ? s + (size_t)(g0 + i / BN) * N + n : s, ok);
    }
  }
}

template <int FMT>
__device__ __forceinline__ float code4(int nib, const float* code) {
  return FMT == dq::FMT_NF4 ? code[nib] : (float)(nib - 8);
}

// Decode half `part` (0 or 1) of a staged quantized tile of ROWS weight
// rows by COLS columns into bf16 tiles [ROWS][LDW] at wb (w = code *
// scale in fp32, then bf16). LO: two parts, hi = bf16(w) at wb and lo =
// bf16(w - hi) at wb + ROWS * LDW (split_bf16), for two mma passes; else
// hi alone, w rounded to bf16 as the plain version's dequantize to bf16
// rounds it. Staged as the (G, rows, N) layout lies: payload [ROWS /
// RSTEP][COLS] bytes (byte row j holds weight rows RSTEP j ..), scales
// [.][COLS] fp32, the scale row of weight row k0 + row at ((k0 + row) >>
// bshift) - (k0 >> bshift). Weight rows at or past ke decode to zero
// (their staged scale rows may be stale). Each of the NTH threads takes
// fixed 4-byte payload words: with one word a thread per tile, the first
// half of the block decodes in part 0 and the second in part 1; with
// more, each part takes half of them. lora_tc_kernel and qmm_tc_kernel
// decode [32 K rows][128 N columns] tiles, qmt_tc_kernel [128 Kq rows][32
// N columns]: the same [weight row][column] orientation.
template <int FMT, int ROWS, int COLS, int LDW, int NTH, bool LO>
__device__ __forceinline__ void decode_words(const uint8_t* qs,
                                             const float* ss,
                                             __nv_bfloat16* wb,
                                             const float* code, int k0,
                                             int ke, int bshift, int part) {
  constexpr int RSTEP = FMT == dq::FMT_INT8 ? 1 : 2;  // weight rows a byte
  constexpr int WPR = COLS / 4;                    // words a payload row
  constexpr int PER = ROWS / RSTEP * WPR / NTH;    // words a thread
  constexpr int PP = PER >= 2 ? PER / 2 : 1;       // ... a part
  static_assert(PER >= 1 && (PER == 1 || PER % 2 == 0), "words a thread");
  const int tid = threadIdx.x;
  const bool full = k0 + ROWS <= ke;
  const bool mine = PER >= 2 || (tid >= NTH / 2) == (part == 1);
#pragma unroll
  for (int e = 0; e < PP; ++e) {
    if (!mine) break;
    const int w = PER >= 2 ? tid + (part * PP + e) * NTH : tid;
    const int pr = (int)((unsigned)w / WPR);
    const int c4 = (int)((unsigned)w % WPR) * 4;
    const int row = RSTEP * pr;                      // first weight row
    const uint32_t word = *reinterpret_cast<const uint32_t*>(qs + pr * COLS + c4);
    const int sr = ((k0 + row) >> bshift) - (k0 >> bshift);
    const float4 sc4 = *reinterpret_cast<const float4*>(ss + sr * COLS + c4);
    const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
    const bool ok = full || k0 + row < ke;
    float wv[RSTEP][4];                // rows row (hi nibble), row + 1
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int byte = (word >> (8 * j)) & 0xff;
      if (FMT == dq::FMT_INT8) {
        wv[0][j] = ok ? (float)(int8_t)byte * sc[j] : 0.f;
      } else {
        wv[0][j] = ok ? code4<FMT>(byte >> 4, code) * sc[j] : 0.f;
        wv[RSTEP - 1][j] = ok ? code4<FMT>(byte & 0xf, code) * sc[j] : 0.f;
      }
    }
#pragma unroll
    for (int rr = 0; rr < RSTEP; ++rr) {
      uint2 h, l;
      if (LO) {
        tc::split_bf16(wv[rr][0], wv[rr][1], h.x, l.x);
        tc::split_bf16(wv[rr][2], wv[rr][3], h.y, l.y);
      } else {
        h.x = tc::pack_bf16(wv[rr][0], wv[rr][1]);
        h.y = tc::pack_bf16(wv[rr][2], wv[rr][3]);
      }
      *reinterpret_cast<uint2*>(wb + (row + rr) * LDW + c4) = h;
      if (LO) *reinterpret_cast<uint2*>(wb + (ROWS + row + rr) * LDW + c4) = l;
    }
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* y, float4 v) {
  *reinterpret_cast<uint2*>(y) =
      make_uint2(tc::pack_bf16(v.x, v.y), tc::pack_bf16(v.z, v.w));
}
__device__ __forceinline__ void store4(float* y, float4 v) {
  *reinterpret_cast<float4*>(y) = v;
}

// y = T(the sum over s of ws[s]), split 0 first: a fixed order
template <typename T>
__global__ void splitk_sum(const float* __restrict__ ws, T* __restrict__ y,
                           long long mn, int splits) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= mn) return;
  if (mn % 4 == 0) {
    float4 v = *reinterpret_cast<const float4*>(ws + i);
    for (int s = 1; s < splits; ++s) {
      const float4 u = *reinterpret_cast<const float4*>(ws + s * mn + i);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    store4(y + i, v);
    return;
  }
  for (long long j = i; j < i + 4 && j < mn; ++j) {
    float v = ws[j];
    for (int s = 1; s < splits; ++s) v += ws[s * mn + j];
    dq::store_f(y + j, v);
  }
}

template <typename T>
cudaError_t sum_splits(const float* ws, T* y, long long mn, int splits,
                       cudaStream_t st) {
  const int threads = 256;
  const long long blocks = (mn + 4LL * threads - 1) / (4LL * threads);
  splitk_sum<T><<<(unsigned)blocks, threads, 0, st>>>(ws, y, mn, splits);
  return cudaGetLastError();
}

}  // namespace tt
