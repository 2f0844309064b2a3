// Strip elimination of the blocked complex LU's panel, for Hopper (sm_90a).
//
// Replaces the TPU kernel gaunegf_tpu/ops/pallas/strip_elim.py
// (eliminate_strip, body _make_kernel): ROWS (<= 32) sequential pivoted
// eliminations of one transposed panel strip (rows are panel columns,
// lanes are panel rows).  For each row j:
//   * pivot p = the first lane of largest |c| among the available lanes,
//     |c| by the formula of jnp.hypot;
//   * reciprocal of the pivot value by two divisions by |p| (a division
//     by |p|^2 underflows for |p| < ~1e-19); a zero pivot reads as 1, so
//     padded lanes and singular columns give zeros, not NaN;
//   * multipliers l = c / p at the available lanes other than p; row j
//     stores l there and keeps its values elsewhere;
//   * rank-1 update of rows j+1.. with the pivot column u[r] = strip[r, p];
//   * piv[j] = p, and lane p leaves the available set.
// Every product, sum and quotient is rounded as its own operation (the
// __f*_rn intrinsics forbid fused multiply-adds), so the kernel returns
// bit for bit what the plain PyTorch version computes
// (gaunegf_tpu_torch/ops/kernels/strip_elim.py::eliminate_strip_plain).
//
// Bound on the card: the latency of ROWS dependent steps, each a
// block-wide argmax and a rank-1 update of at most 32 x m complex values,
// not bytes or flops (one strip is 32 * m * 8 bytes, 256 KB at m = 1024).
// Design: one thread block per batch element (the energies of a chunk run
// in parallel on the SMs, independent of each other); the strip stays in
// global memory, where it lives in L2, since 256 KB exceeds a block's
// shared memory; shared memory holds only the argmax partials, the pivot
// reciprocal and the pivot column.  Each thread owns the lanes tid,
// tid + 256, ... and is the only writer of them, so one barrier per step
// orders the row read of step j+1 after the update of step j.
//
// C interface (ctypes): returns the cudaGetLastError() code of the launch.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 32;

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

__global__ void __launch_bounds__(kThreads)
strip_elim_kernel(float2* __restrict__ strip, unsigned char* __restrict__ avail,
                  int* __restrict__ piv, int rows, int m) {
  float2* sb = strip + static_cast<size_t>(blockIdx.x) * rows * m;
  unsigned char* av = avail + static_cast<size_t>(blockIdx.x) * m;
  int* pv = piv + static_cast<size_t>(blockIdx.x) * rows;
  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const int warp = tid >> 5;

  __shared__ float s_mag[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float2 s_u[kMaxRows];
  __shared__ float2 s_inv;
  __shared__ int s_p;

  for (int j = 0; j < rows; ++j) {
    const float2* rowj = sb + static_cast<size_t>(j) * m;

    // masked argmax; lanes are visited in ascending order, so a strict
    // comparison keeps the first of equal magnitudes
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
        const float2 pval = rowj[bidx];
        float pm = hypot_ref(pval.x, pval.y);
        if (pm == 0.f) pm = 1.f;
        s_inv = make_float2(__fdiv_rn(__fdiv_rn(pval.x, pm), pm),
                            -__fdiv_rn(__fdiv_rn(pval.y, pm), pm));
        s_p = bidx;
        pv[j] = bidx;
      }
    }
    __syncthreads();
    const int p = s_p;
    if (tid < rows) {
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
      sb[o] = make_float2(lr, li);
      for (int r = j + 1; r < rows; ++r) {
        const float2 u = s_u[r];
        const size_t q = static_cast<size_t>(r) * m + l;
        float2 s = sb[q];
        s.x = __fsub_rn(s.x, __fsub_rn(__fmul_rn(u.x, lr), __fmul_rn(u.y, li)));
        s.y = __fsub_rn(s.y, __fadd_rn(__fmul_rn(u.x, li), __fmul_rn(u.y, lr)));
        sb[q] = s;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// strip: (batch, rows, m) complex64 (float2), factored in place.
// avail: (batch, m) bool (one byte per lane), updated in place.
// piv:   (batch, rows) int32, written.
extern "C" int gaunegf_strip_elim_c64(void* strip, void* avail, void* piv,
                                      int batch, int rows, int m,
                                      void* stream) {
  if (batch < 0 || rows < 1 || rows > kMaxRows || m < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  strip_elim_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(strip), static_cast<unsigned char*>(avail),
      static_cast<int*>(piv), rows, m);
  return static_cast<int>(cudaGetLastError());
}
