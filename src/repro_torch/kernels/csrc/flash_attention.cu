// Blocked online-softmax attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (Pallas
// TPU kernel, body _kernel).
//
// Bound on the H100: at the serve oracle's shape (B=1, S=1, H=4, D=192)
// the work is a few kilobytes and the launch dominates; at long S it is
// memory-bound on K/V for small D and turns compute-bound (fp32 CUDA
// cores here) as S grows.
//
// Design: grid (B*H, ceil(S/16)); 4 warps per block, each warp owns 4 of
// the block's 16 query rows and keeps their running max m, sum l and
// output accumulator in fp32 registers: DPL = 8 dims per lane for
// D <= 256 and 16 for D <= 512 (the adapter's 4096 / 8 heads at Yi-9B
// width), two instantiations so the short-D path keeps its registers. The
// block loops over 32-key tiles of K and V staged in shared memory (K
// rows padded to D+1 floats, so lane j reading key j is conflict-free):
// lane j scores key j, the warp reduces max and sum with shuffles, and
// p_j is broadcast by shuffle into the P.V update (over the keys that
// exist only; rows past S are skipped whole). The mask is
// kpos < Skv, plus qpos >= kpos when causal, plus qpos - kpos < window;
// tiles wholly outside the causal/window band are skipped, which is exact
// since a masked key adds nothing. GQA reads kv head h / (H / Hkv). A row
// with no valid key gives 0, as the TPU kernel's max(l, 1e-30) does.
// D need not be a power of two (192 at CLIP width); D <= 512. At D = 512
// the block's Q, K and V tiles take 164 KB of shared memory, past the
// 48 KB default: the launcher raises the kernel's dynamic limit once per
// instantiation (cudaFuncSetAttribute), so one block runs per SM there.
// Simple first: no tensor cores. The gradient is not a kernel yet: the
// port's autograd.Function (kernels/ops.py) recomputes P in PyTorch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NWARP = 4;
constexpr int BQ = 16;                  // query rows per block
constexpr int RPW = BQ / NWARP;         // rows per warp
constexpr int BK = 32;                  // keys per tile (one per lane)
constexpr int MAXD = 512;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)BQ * D + (size_t)BK * (D + 1) + (size_t)BK * D);
}

// q (B, S, H, D); k, v (B, Skv, Hkv, D) -> o (B, S, H, D)
// DPL: output dims per lane, so D <= 32 * DPL
template <typename T, int DPL>
__global__ void __launch_bounds__(NWARP * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int Skv,
             int H, int Hkv, int D, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* qs = smem;                      // BQ x D
  float* ks = qs + BQ * D;               // BK x (D + 1)
  float* vs = ks + BK * (D + 1);         // BK x D
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, qp = q0 + r;
    qs[i] = qp < S ? load_f(q + (((size_t)b * S + qp) * H + h) * D + d) * scale
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
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();   // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D, kp = kt + j;
      const size_t off = (((size_t)b * Skv + kp) * Hkv + hk) * D + d;
      ks[j * (D + 1) + d] = kp < Skv ? load_f(k + off) : 0.f;
      vs[j * D + d] = kp < Skv ? load_f(v + off) : 0.f;
    }
    __syncthreads();
    const int kp = kt + lane;
    const int nk = min(BK, Skv - kt);    // keys of this tile that exist
    const float* krow = ks + lane * (D + 1);
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int qr = warp * RPW + rr, qp = q0 + qr;
      if (qp >= S) continue;             // warp-uniform: the whole row
      const float* qrow = qs + qr * D;
      // four partial sums break the FMA dependency chain over D
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      int d = 0;
      for (; d + 4 <= D; d += 4) {
        s0 = fmaf(qrow[d], krow[d], s0);
        s1 = fmaf(qrow[d + 1], krow[d + 1], s1);
        s2 = fmaf(qrow[d + 2], krow[d + 2], s2);
        s3 = fmaf(qrow[d + 3], krow[d + 3], s3);
      }
      for (; d < D; ++d) s0 = fmaf(qrow[d], krow[d], s0);
      float sc = (s0 + s1) + (s2 + s3);
      bool valid = kp < Skv;
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
    T* orow = o + (((size_t)b * S + qp) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) store_f(orow + d, acc[rr][i] * inv);
    }
  }
}

template <typename T, int DPL>
cudaError_t launch_dpl(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int Skv, int H, int Hkv, int D,
                       float scale, int causal, int window,
                       cudaStream_t stream) {
  const size_t bytes = smem_bytes(D);
  static bool attr_set = false;   // the 32 * DPL bound: one setting is enough
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(32 * DPL));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_kernel<T, DPL><<<grid, NWARP * 32, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, Skv, H, Hkv, D, scale,
      causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int Skv, int H, int Hkv, int D,
                         float scale, int causal, int window,
                         cudaStream_t stream) {
  if (D <= 256)
    return launch_dpl<T, 8>(q, k, v, o, B, S, Skv, H, Hkv, D, scale, causal,
                            window, stream);
  return launch_dpl<T, 16>(q, k, v, o, B, S, Skv, H, Hkv, D, scale, causal,
                           window, stream);
}

}  // namespace

// window <= 0 means no sliding window; is_bf16 selects bf16 q/k/v/o.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Skv, int H, int Hkv, int D,
                                      float scale, int causal, int window,
                                      int is_bf16, void* stream) {
  if (B < 1 || S < 1 || Skv < 1 || H < 1 || Hkv < 1 || H % Hkv || D < 1 ||
      D > MAXD || S > 65535 * BQ)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      is_bf16 ? launch_typed<__nv_bfloat16>(q, k, v, o, B, S, Skv, H, Hkv, D,
                                            scale, causal, window, st)
              : launch_typed<float>(q, k, v, o, B, S, Skv, H, Hkv, D, scale,
                                    causal, window, st);
  return (int)err;
}
