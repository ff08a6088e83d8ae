// The fused LoRA linear at decode rows for Hopper (sm_90a):
//   y (M, N) = x @ dequant(W_q) + scale * (x @ A) @ B,   M <= 8 rows.
//
// Replaces: src/repro/kernels/lora_matmul.py:lora_matmul (Pallas TPU
// kernel, body _lora_kernel) at the rows a decode step gives it (one
// token of each stream: 4 in the token phases, 8 a rank's decode block).
// The training rows keep lora_matmul.cu's kernels; the wrapper
// (kernels/lora_matmul.py:route) picks this route by the row count, and
// neither stands in for the other.
//
// Bound on the H100: bytes. At M = 4 a weight costs half a byte (NF4) and
// 2 M = 8 flops, so Yi-9B's wg/wu (4096 x 11008) moves 22.5 MB, about
// 7 us at 3.35 TB/s, against 0.36 GFLOP. The tensor-core kernel built for
// 256 training rows kept 1/64 of the rows it computed here and spent its
// time on split-K partials (PERF.md): this route is the serve head's
// GEMV design instead (gemv.cuh, shared with quant_matmul.cu's
// GEMV), with the rank-r term added.
//
// Two launches, on one stream:
//  - lora_h_kernel: h = x @ A (M x r, fp32) in HCHUNK-row chunks of K
//    (at most HCHUNKS_MAX), one CTA a chunk (256 threads: 8 row lanes x
//    32 rank columns; lane l sums K rows l, l + 8, ... of its chunk in
//    order, then the lanes are added in order), each chunk's partial
//    written to hpart (chunks, M, r). A is read once. The GEMV is
//    launched as its programmatic dependent (griddepcontrol): it starts
//    while this launch runs, and only its leaders wait for it, just
//    before they read hpart, so the x@A launch's time hides behind the
//    GEMV's streaming of W. Making h in the GEMV's CTAs instead would read
//    all of A (K x r fp32, 256 KB at K = 4096, r = 16) once per column
//    tile: 86 tiles at N = 11008, as many L2 bytes as W itself.
//  - gemv.cuh's gemv_kernel, the serve GEMV (K split over a cluster of
//    csize CTAs, 16-byte code streaming, code * fp32 scale * fp32(x) FMAs
//    in registers, the row lanes then the ranks summed in order into the
//    leader's shared memory), with LoraGemvOut as the leader's epilogue:
//    it adds h's chunks in order, then for each of its outputs y = (sum
//    of the ranks) + scale * (h @ B)[m, n] (the r products in
//    rank-column order, fp32) and writes y in x's dtype. W is never
//    written dense; no atomics, so two calls are bitwise equal.
// MR (1, 2, 4, 8) is the kernel's row count: the wrapper pads x with zero
// rows to MR (rows 3, 5, 6, 7) and passes the true M, whose rows alone
// are written. At 8 rows a thread keeps 4 code rows in flight (LMAX),
// for its registers.
#include "gemv.cuh"

namespace {

using gv::GV_CPT;
using gv::GV_THREADS;

constexpr int HROWS = 8;            // h's row bound (the GEMV's MR)
constexpr int HLANES = 8;           // K-row lanes of the h kernel
constexpr int HCOLS = 32;           // rank columns (r <= 32)
constexpr int HTHREADS = HLANES * HCOLS;
constexpr int HCHUNK = 256;         // K rows a chunk of the h kernel
constexpr int HCHUNKS_MAX = 128;
constexpr int HSTAGE_MAX = 49152;   // 48 KB: x's chunk in shared memory

__host__ __device__ constexpr int h_chunks(int K) {
  return (K + HCHUNK - 1) / HCHUNK < HCHUNKS_MAX
             ? (K + HCHUNK - 1) / HCHUNK : HCHUNKS_MAX;
}

// hpart[c][m][j] = sum over K rows k of chunk c of x[m][k] * A[k][j]: lane
// l of column j takes rows k0 + l, k0 + l + 8, ... in order; the lanes'
// sums are added in lane order. x (M, ldx), A (K, r), chunk c covers
// [c * kc, min(K, (c + 1) * kc)). The chunk's x is staged in shared
// memory first (coalesced, fp32: M * kc floats of dynamic shared memory),
// and a lane's loads of A go out 8 rows ahead of its FMAs (the unrolled
// loop; the FMAs stay in row order).
template <typename T>
__global__ void __launch_bounds__(HTHREADS)
lora_h_kernel(const T* __restrict__ x, const float* __restrict__ a,
              float* __restrict__ hpart, int M, int K, int ldx, int r,
              int kc) {
  extern __shared__ float xs[];                 // [M][kc]
  __shared__ float red[HLANES][HROWS][HCOLS];
  // the GEMV behind this launch may start now (it waits for hpart only
  // where its leaders read it)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int j = threadIdx.x % HCOLS, lane = threadIdx.x / HCOLS;
  const int c = blockIdx.x;
  const int k0 = c * kc, n = min(K, k0 + kc) - k0;
  for (int i = threadIdx.x; i < M * n; i += HTHREADS) {
    const int m = i / n, kk = i - m * n;
    xs[m * kc + kk] = dq::load_f(x + (size_t)m * ldx + k0 + kk);
  }
  __syncthreads();
  float acc[HROWS];
#pragma unroll
  for (int m = 0; m < HROWS; ++m) acc[m] = 0.f;
  if (j < r) {
#pragma unroll 8
    for (int k = lane; k < n; k += HLANES) {
      const float av = a[(size_t)(k0 + k) * r + j];
#pragma unroll
      for (int m = 0; m < HROWS; ++m)
        if (m < M) acc[m] = fmaf(xs[m * kc + k], av, acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < HROWS; ++m) red[lane][m][j] = acc[m];
  __syncthreads();
  for (int i = threadIdx.x; i < M * HCOLS; i += HTHREADS) {
    const int m = i / HCOLS, jj = i % HCOLS;
    if (jj >= r) continue;
    float v = 0.f;
#pragma unroll
    for (int l = 0; l < HLANES; ++l) v += red[l][m][jj];
    hpart[((size_t)c * M + m) * r + jj] = v;
  }
}

// shared memory (floats): the GEMV's (gemv.cuh), then h summed over its
// chunks ([HROWS][HCOLS], the leader's)
__host__ __device__ constexpr int lg_smem_floats(int MR, int cols, int csize,
                                                 int kxp, int gmax) {
  return gv::gv_smem_floats(MR, cols, csize, kxp, gmax, true) +
         HROWS * HCOLS;
}

// The leader's epilogue of gemv.cuh's gemv_kernel for the fused LoRA
// linear: h = hpart's chunks added in chunk order (once the x@A launch
// has completed), then y = (the ranks' sum) + scale * (h @ B) for the
// tile's outputs of the true M rows. hpart (hchunks, M, r), b (r, N)
// fp32, y (M, N) in x's dtype.
template <typename T>
struct LoraGemvOut {
  static constexpr bool kReuse = true;
  const float* hpart;
  const float* b;
  T* y;
  int M, r, hchunks;
  float scale;
  __device__ __forceinline__ void operator()(const float* slots, float* hs,
                                             int per, int csize, int cols,
                                             int n0, int, int N) const {
    // the x@A launch before this one has completed (programmatic
    // dependent launch: only the leaders wait for it)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int i = threadIdx.x; i < M * r; i += GV_THREADS) {
      const int m = i / r, j = i % r;
      float h = 0.f;
#pragma unroll 8
      for (int c = 0; c < hchunks; ++c)
        h += hpart[((size_t)c * M + m) * r + j];
      hs[m * HCOLS + j] = h;
    }
    __syncthreads();
    for (int o = threadIdx.x; o < per; o += GV_THREADS) {
      const float v = gv::leader_sum(slots, per, csize, o);
      int m, n;
      gv::out_at(o, cols, n0, &m, &n);
      if (m >= M || n >= N) continue;
      float t = 0.f;
      for (int j = 0; j < r; ++j)
        t = fmaf(hs[m * HCOLS + j], b[(size_t)j * N + n], t);
      dq::store_f(y + (size_t)m * N + n, v + scale * t);
    }
  }
};

template <typename T, int FMT, int MR>
cudaError_t launch_gemv(const T* x, const uint8_t* q, const float* s,
                        const float* hpart, const float* b, T* y, int M,
                        int Kq, int N, int block, int rows, int cols,
                        int csize, int r, int hchunks, float scale,
                        cudaStream_t stream) {
  constexpr int LMAX = MR <= 4 ? gv::GV_LMAX : 4;  // registers at 8 rows
  const int G = Kq / block;
  const int gmax = (G + csize - 1) / csize;
  const size_t smem = sizeof(float) * lg_smem_floats(
      MR, cols, csize, gv::gv_kxp(gmax, block), gmax);
  auto* kern = gv::gemv_kernel<T, FMT, MR, LMAX, LoraGemvOut<T>>;
  static size_t smem_set = 48 * 1024;   // dynamic beyond 48 KB: set once
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const int vec16 = N % 16 == 0 && (uintptr_t)q % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + cols - 1) / cols) * csize);
  cfg.blockDim = dim3(GV_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // programmatic dependent launch: the GEMV streams W while the x@A
  // launch runs
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kern, x, q, s,
                            LoraGemvOut<T>{hpart, b, y, M, r, hchunks, scale},
                            Kq, N, block, rows, cols, csize, vec16);
}

template <typename T, int FMT>
cudaError_t launch_mr(int mr, const T* x, const uint8_t* q, const float* s,
                      const float* hpart, const float* b, T* y, int M,
                      int Kq, int N, int block, int rows, int cols,
                      int csize, int r, int hchunks, float scale,
                      cudaStream_t st) {
  switch (mr) {
    case 1: return launch_gemv<T, FMT, 1>(x, q, s, hpart, b, y, M, Kq, N, block, rows, cols, csize, r, hchunks, scale, st);
    case 2: return launch_gemv<T, FMT, 2>(x, q, s, hpart, b, y, M, Kq, N, block, rows, cols, csize, r, hchunks, scale, st);
    case 4: return launch_gemv<T, FMT, 4>(x, q, s, hpart, b, y, M, Kq, N, block, rows, cols, csize, r, hchunks, scale, st);
    case 8: return launch_gemv<T, FMT, 8>(x, q, s, hpart, b, y, M, Kq, N, block, rows, cols, csize, r, hchunks, scale, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_typed(int fmt, const void* x, const void* q,
                         const void* s, const void* a, const void* b,
                         void* y, void* hpart, int M, int K, int Kq, int N,
                         int r, int block, int rows, int cols, int csize,
                         float scale, cudaStream_t st) {
  const int mr = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8;
  const int hc = h_chunks(K), kc = (K + hc - 1) / hc;
  lora_h_kernel<T><<<hc, HTHREADS, sizeof(float) * M * kc, st>>>(
      (const T*)x, (const float*)a, (float*)hpart, M, K, Kq, r, kc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  switch (fmt) {
    case dq::FMT_INT8:
      return launch_mr<T, dq::FMT_INT8>(mr, (const T*)x, (const uint8_t*)q, (const float*)s, (const float*)hpart, (const float*)b, (T*)y, M, Kq, N, block, rows, cols, csize, r, hc, scale, st);
    case dq::FMT_INT4:
      return launch_mr<T, dq::FMT_INT4>(mr, (const T*)x, (const uint8_t*)q, (const float*)s, (const float*)hpart, (const float*)b, (T*)y, M, Kq, N, block, rows, cols, csize, r, hc, scale, st);
    case dq::FMT_NF4:
      return launch_mr<T, dq::FMT_NF4>(mr, (const T*)x, (const uint8_t*)q, (const float*)s, (const float*)hpart, (const float*)b, (T*)y, M, Kq, N, block, rows, cols, csize, r, hc, scale, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x (MR, Kq) in fp32 (is_bf16 0) or bf16, MR the row bound of M (1, 2,
// 4 or 8), its rows past M and columns past the true K zero; A (K, r)
// and B (r, N) fp32; hpart an fp32 scratch of lora_gemv_hpart_floats(M,
// K, r); y (M, N) in x's dtype. fmt: 0 int8,
// 1 int4, 2 NF4 (packed); cols, csize: the plan's column tile and cluster
// size (kernels/lora_matmul.py:plan_gemv). Refuses what the route does
// not take: more than 8 rows, r > 32, N % 4 != 0, an unaligned payload, a
// tile whose 16-column threads do not split the CTA, a cluster past 8
// CTAs or past the quant groups.
extern "C" int lora_gemv_launch(const void* x, const void* q, const void* s,
                                const void* a, const void* b, void* y,
                                void* hpart, int M, int K, int Kq, int N,
                                int r, int block, int rows, int fmt,
                                int is_bf16, int cols, int csize,
                                float scale, void* stream) {
  const int rstep = fmt == dq::FMT_INT8 ? 1 : 2;
  if (M < 1 || M > HROWS || N < 1 || K < 1 || K > Kq || r < 1 ||
      r > HCOLS || block < 1 || Kq % block || rows * rstep != block ||
      N % 4 || (uintptr_t)q % 4 || cols < GV_CPT || cols % GV_CPT ||
      GV_THREADS % (cols / GV_CPT) || csize < 1 || csize > 8 ||
      csize > Kq / block || hpart == nullptr ||
      sizeof(float) * M * ((K + h_chunks(K) - 1) / h_chunks(K)) > HSTAGE_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      is_bf16 ? launch_typed<__nv_bfloat16>(fmt, x, q, s, a, b, y, hpart, M, K, Kq, N, r, block, rows, cols, csize, scale, st)
              : launch_typed<float>(fmt, x, q, s, a, b, y, hpart, M, K, Kq, N, r, block, rows, cols, csize, scale, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Floats of the h scratch for M rows, K and rank r: (chunks, M, r).
extern "C" int lora_gemv_hpart_floats(int M, int K, int r) {
  return h_chunks(K) * M * r;
}

// Dynamic shared memory (bytes) of one CTA of the GEMV for M rows (its
// template bound), Kq = G block, a column tile of cols and a cluster of
// csize.
extern "C" int lora_gemv_smem(int M, int Kq, int block, int cols,
                              int csize) {
  const int mr = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8;
  const int G = Kq / block;
  const int gmax = (G + csize - 1) / csize;
  return (int)sizeof(float) *
         lg_smem_floats(mr, cols, csize, gv::gv_kxp(gmax, block), gmax);
}
