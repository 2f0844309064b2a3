// Fused panel factorization of the blocked complex LU, for Hopper (sm_90a).
//
// Replaces the TPU kernel gaunegf_tpu/ops/pallas/panel_fused.py
// (factor_panel_fused, body _make_kernel): the whole virtually pivoted
// panel in one program.  The panel is transposed, (bs, m): rows are panel
// columns, lanes are panel rows.  For each strip of S = min(32, bs) rows:
//   * S eliminations (row j of the strip): pivot p = the first available
//     lane of largest |c| (jnp.hypot's formula); reciprocal
//     (pr, -pi) / (pr^2 + pi^2), a zero denominator reading as 1;
//     multipliers l = c / p at the available lanes other than p; rank-1
//     update of the strip rows below j with u[r] = strip[r][p]; piv = p,
//     and lane p leaves the available set;
//   * the deferred update of the later rows: G[j][k] = strip[j][piv_k]
//     (its strict upper part is L11^T), W = U (L11^T)^-1 for each later
//     row's values U at the pivot lanes (forward substitution), then
//     rest[r][l] -= sum_k W[r][k] * strip[k][l] over the still-available
//     lanes l, and W written into the pivot lanes.
// Every product, sum and quotient is rounded as its own operation (the
// __f*_rn intrinsics forbid fused multiply-adds) and every sum over k runs
// one term at a time in ascending k, so the kernel returns bit for bit
// what the plain PyTorch version computes
// (gaunegf_tpu_torch/ops/kernels/panel_fused.py::factor_panel_fused_plain).
// The trailing products run on FP32 CUDA cores, never on TF32 tensor cores.
//
// Bound on the card: the eliminations are latency-bound like the strip
// kernel (S dependent block-wide argmaxes per strip); the deferred updates
// hold the flops, about m * bs^2 / 2 complex multiply-adds per panel (rest
// rows x 32 x m per strip), issued as unfused FP32 CUDA-core instructions.  A (1024, 256) panel is 2 MB, beyond shared memory, so it
// stays in global memory (L2-resident for a chunk of energies).  Design:
// one thread block per batch element; shared memory holds the argmax
// partials, the pivot column of the strip, G (32 x 32) and W of all later
// rows ((bs - 32) x 33 with padding, dynamic, 58 KB at bs = 256); each
// thread solves its later rows' W in place there.  In the trailing
// update each thread owns lanes l, l + 256, ..., keeps the strip's 32
// values at its lane in registers and reads W as shared-memory
// broadcasts, so its global loads and stores are contiguous across the
// warp.
//
// C interface (ctypes): returns the cudaGetLastError() code of the launch.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 32;
constexpr int kWs = kStrip + 1;    // row stride of s_W (padding spreads banks)
constexpr int kMaxBs = 512;

__device__ __forceinline__ float hypot_ref(float x, float y) {
  // jnp.hypot: big * sqrt(1 + (small / big)^2), 0 where big == 0, inf if
  // either input is infinite
  const float ax = fabsf(x), ay = fabsf(y);
  const float big = fmaxf(ax, ay), small = fminf(ax, ay);
  const float q = __fdiv_rn(small, big == 0.f ? 1.f : big);
  const float r = big == 0.f
      ? big
      : __fmul_rn(big, __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(q, q))));
  return (isinf(ax) || isinf(ay)) ? INFINITY : r;
}

// (m1, i1) replaces (m0, i0): larger magnitude, or equal at a smaller lane
__device__ __forceinline__ bool better(float m1, int i1, float m0, int i0) {
  return m1 > m0 || (m1 == m0 && i1 < i0);
}

__device__ __forceinline__ void warp_argmax(float& mag, int& idx) {
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_down_sync(0xffffffffu, mag, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    if (better(om, oi, mag, idx)) {
      mag = om;
      idx = oi;
    }
  }
}

// a - w * b, complex, each operation rounded: (a.x - (w.x b.x - w.y b.y),
// a.y - (w.x b.y + w.y b.x))
__device__ __forceinline__ float2 sub_mul(float2 a, float2 w, float2 b) {
  a.x = __fsub_rn(a.x, __fsub_rn(__fmul_rn(w.x, b.x), __fmul_rn(w.y, b.y)));
  a.y = __fsub_rn(a.y, __fadd_rn(__fmul_rn(w.x, b.y), __fmul_rn(w.y, b.x)));
  return a;
}

__global__ void __launch_bounds__(kThreads)
panel_fused_kernel(float2* __restrict__ panel, unsigned char* __restrict__ avail,
                   int* __restrict__ piv, int m, int bs, int strip) {
  float2* pt = panel + static_cast<size_t>(blockIdx.x) * bs * m;
  unsigned char* av = avail + static_cast<size_t>(blockIdx.x) * m;
  int* pv = piv + static_cast<size_t>(blockIdx.x) * bs;
  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float2 s_W[];            // (bs - strip) x kWs
  __shared__ float2 s_G[kStrip][kStrip];
  __shared__ float s_mag[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float2 s_u[kStrip];
  __shared__ float2 s_inv;
  __shared__ int s_p;
  __shared__ int s_piv[kStrip];

  for (int s0 = 0; s0 < bs; s0 += strip) {
    float2* sb = pt + static_cast<size_t>(s0) * m;

    // ---- eliminations of the strip's rows ----
    for (int j = 0; j < strip; ++j) {
      const float2* rowj = sb + static_cast<size_t>(j) * m;
      float best = -INFINITY;
      int bidx = INT_MAX;
      for (int l = tid; l < m; l += kThreads) {
        const float2 c = rowj[l];
        const float mag = av[l] ? hypot_ref(c.x, c.y) : -1.f;
        if (mag > best) {
          best = mag;
          bidx = l;
        }
      }
      warp_argmax(best, bidx);
      if (wl == 0) {
        s_mag[warp] = best;
        s_idx[warp] = bidx;
      }
      __syncthreads();
      if (warp == 0) {
        best = wl < kWarps ? s_mag[wl] : -INFINITY;
        bidx = wl < kWarps ? s_idx[wl] : INT_MAX;
        warp_argmax(best, bidx);
        if (wl == 0) {
          if (bidx == INT_MAX) bidx = 0;       // no candidate (NaN lanes)
          const float2 pval = rowj[bidx];
          float den = __fadd_rn(__fmul_rn(pval.x, pval.x),
                                __fmul_rn(pval.y, pval.y));
          if (den == 0.f) den = 1.f;
          s_inv = make_float2(__fdiv_rn(pval.x, den), __fdiv_rn(-pval.y, den));
          s_p = bidx;
          s_piv[j] = bidx;
          pv[s0 + j] = bidx;
        }
      }
      __syncthreads();
      const int p = s_p;
      if (tid < strip) {
        s_u[tid] = tid > j ? sb[static_cast<size_t>(tid) * m + p]
                           : make_float2(0.f, 0.f);
      }
      __syncthreads();

      const float2 inv = s_inv;
      for (int l = tid; l < m; l += kThreads) {
        if (l == p) {
          av[l] = 0;
          continue;
        }
        if (!av[l]) continue;
        const size_t o = static_cast<size_t>(j) * m + l;
        const float2 c = sb[o];
        const float lr = __fsub_rn(__fmul_rn(c.x, inv.x), __fmul_rn(c.y, inv.y));
        const float li = __fadd_rn(__fmul_rn(c.x, inv.y), __fmul_rn(c.y, inv.x));
        const float2 lv = make_float2(lr, li);
        sb[o] = lv;
        for (int r = j + 1; r < strip; ++r) {
          const size_t q = static_cast<size_t>(r) * m + l;
          sb[q] = sub_mul(sb[q], s_u[r], lv);
        }
      }
      __syncthreads();
    }

    const int s1 = s0 + strip;
    if (s1 >= bs) break;
    const int rest = bs - s1;

    // ---- G[j][k] = strip[j][piv_k] ----
    for (int e = tid; e < strip * strip; e += kThreads) {
      const int jj = e / strip, kk = e % strip;
      s_G[jj][kk] = sb[static_cast<size_t>(jj) * m + s_piv[kk]];
    }
    __syncthreads();

    // ---- W = U (L11^T)^-1, one later row per thread, in s_W ----
    for (int rr = tid; rr < rest; rr += kThreads) {
      float2* row = pt + static_cast<size_t>(s1 + rr) * m;
      float2* w = s_W + rr * kWs;
      for (int k = 0; k < strip; ++k) w[k] = row[s_piv[k]];
      for (int i = 0; i < strip; ++i) {
        const float2 wi = w[i];
        for (int k = i + 1; k < strip; ++k) w[k] = sub_mul(w[k], wi, s_G[i][k]);
      }
      for (int k = 0; k < strip; ++k) row[s_piv[k]] = w[k];
    }
    __syncthreads();

    // ---- rest -= W L over the still-available lanes ----
    for (int l = tid; l < m; l += kThreads) {
      if (!av[l]) continue;
      float2 L[kStrip];
#pragma unroll
      for (int k = 0; k < kStrip; ++k) {
        L[k] = k < strip ? sb[static_cast<size_t>(k) * m + l]
                         : make_float2(0.f, 0.f);
      }
      for (int rr = 0; rr < rest; ++rr) {
        float2* q = pt + static_cast<size_t>(s1 + rr) * m + l;
        float2 a = *q;
        const float2* wrow = s_W + rr * kWs;
#pragma unroll
        for (int k = 0; k < kStrip; ++k) {
          if (k < strip) a = sub_mul(a, wrow[k], L[k]);
        }
        *q = a;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// panel: (batch, bs, m) complex64 (float2), the transposed panels,
//        factored in place.
// avail: (batch, m) bool (one byte per lane), all true on entry, updated.
// piv:   (batch, bs) int32, written.
extern "C" int gaunegf_panel_fused_c64(void* panel, void* avail, void* piv,
                                       int batch, int m, int bs,
                                       void* stream) {
  const int strip = bs < kStrip ? bs : kStrip;
  if (batch < 0 || bs < 1 || bs > kMaxBs || m < bs || bs % strip != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const size_t smem = static_cast<size_t>(bs - strip) * kWs * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      panel_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  panel_fused_kernel<<<batch, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(panel), static_cast<unsigned char*>(avail),
      static_cast<int*>(piv), m, bs, strip);
  return static_cast<int>(cudaGetLastError());
}
