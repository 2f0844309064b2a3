// Swap-pivoted panel LU of the blocked complex LU, for Hopper (sm_90a), in
// complex64 and complex128.
//
// Replaces the TPU kernel gaunegf_tpu/ops/pallas/panel_lu.py
// (factor_panel_pallas, body _make_kernel): partial-pivot LU of one
// (m, bs) panel with physical row swaps.  For each column j:
//   * pivot p = the first row >= j of largest re^2 + im^2 (the TPU
//     kernel's squared magnitude, not hypot);
//   * rows j and p swap across the panel, and so do perm[j] and perm[p];
//   * reciprocal of the pivot (pr, -pi) / (pr^2 + pi^2); a zero
//     denominator reads as 1, so padded rows and singular columns give
//     zeros, not NaN;
//   * rows r > j: l = a[r][j] * recip is stored in column j, and
//     a[r][c] -= l * a[j][c] for c > j.
// Every product, sum and quotient is rounded as its own operation (the
// __f*_rn / __d*_rn intrinsics forbid fused multiply-adds), so the kernel
// returns bit for bit what the plain PyTorch version computes
// (gaunegf_tpu_torch/ops/kernels/panel_lu.py::factor_panel_lu_plain).
//
// Bound on the card: the bs dependent steps, each a block-wide argmax over
// one column and a rank-1 update of the trailing (m-j-1) x (bs-j-1) block.
// A (1024, 256) complex128 panel is 4 MB, beyond shared memory, so the
// panel stays in global memory and the rank-1 updates stream it: about
// m * bs^2 / 2 complex read-modify-writes per panel.  A chunk's panels
// (64 x 2-4 MB) exceed the 50 MB L2, so device-memory bandwidth and the
// per-column latency bound it, not flops.  Design: one thread block of
// 1024 threads per batch element (the energies of a chunk run in parallel
// on the SMs; 32 warps per SM keep loads in flight); shared memory holds
// the argmax partials, the reciprocal and the pivot row right of the
// diagonal.  In the update each warp owns whole rows and its lanes walk
// the columns, so a warp's loads and stores are contiguous.
//
// C interface (ctypes): each entry returns the cudaGetLastError() code of
// its launch.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBs = 1024;

// the correctly rounded operations of one real type
template <typename R> struct Ops;
template <> struct Ops<float> {
  using C = float2;
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
};
template <> struct Ops<double> {
  using C = double2;
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
};

// (m1, i1) replaces (m0, i0): larger magnitude, or equal at a smaller row
template <typename R>
__device__ __forceinline__ bool better(R m1, int i1, R m0, int i0) {
  return m1 > m0 || (m1 == m0 && i1 < i0);
}

template <typename R>
__device__ __forceinline__ void warp_argmax(R& mag, int& idx) {
  for (int off = 16; off > 0; off >>= 1) {
    const R om = __shfl_down_sync(0xffffffffu, mag, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    if (better(om, oi, mag, idx)) {
      mag = om;
      idx = oi;
    }
  }
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
panel_lu_kernel(typename Ops<R>::C* __restrict__ panel,
                long long* __restrict__ perm, int m, int bs) {
  using O = Ops<R>;
  using C = typename O::C;
  C* a = panel + static_cast<size_t>(blockIdx.x) * m * bs;
  long long* pm = perm + static_cast<size_t>(blockIdx.x) * m;
  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const int warp = tid >> 5;

  __shared__ R s_mag[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ C s_inv;
  __shared__ int s_p;
  __shared__ C s_u[kMaxBs];

  for (int r = tid; r < m; r += kThreads) pm[r] = r;
  __syncthreads();

  for (int j = 0; j < bs; ++j) {
    // argmax of |a[r][j]|^2 over rows r >= j; each thread visits its rows
    // in ascending order and keeps the first of equal magnitudes
    R best = -INFINITY;
    int bidx = INT_MAX;
    for (int r = j + tid; r < m; r += kThreads) {
      const C c = a[static_cast<size_t>(r) * bs + j];
      R mag = O::add(O::mul(c.x, c.x), O::mul(c.y, c.y));
      if (isnan(mag)) mag = static_cast<R>(INFINITY);   // argmax takes NaN
      if (mag > best) {
        best = mag;
        bidx = r;
      }
    }
    warp_argmax(best, bidx);
    if (wl == 0) {
      s_mag[warp] = best;
      s_idx[warp] = bidx;
    }
    __syncthreads();
    if (warp == 0) {
      best = wl < kWarps ? s_mag[wl] : static_cast<R>(-INFINITY);
      bidx = wl < kWarps ? s_idx[wl] : INT_MAX;
      warp_argmax(best, bidx);
      if (wl == 0) s_p = bidx == INT_MAX ? j : bidx;
    }
    __syncthreads();
    const int p = s_p;

    // swap rows j and p (whole panel row) and their perm entries; keep the
    // pivot row right of the diagonal in shared memory
    C* rowj = a + static_cast<size_t>(j) * bs;
    C* rowp = a + static_cast<size_t>(p) * bs;
    for (int c = tid; c < bs; c += kThreads) {
      const C vj = rowj[c];
      const C vp = rowp[c];
      rowj[c] = vp;
      rowp[c] = vj;
      s_u[c] = vp;
    }
    if (tid == 0) {
      const long long t = pm[j];
      pm[j] = pm[p];
      pm[p] = t;
    }
    __syncthreads();
    if (tid == 0) {
      const C pv = s_u[j];
      R den = O::add(O::mul(pv.x, pv.x), O::mul(pv.y, pv.y));
      if (den == static_cast<R>(0)) den = static_cast<R>(1);
      C inv;
      inv.x = O::div(pv.x, den);
      inv.y = O::div(-pv.y, den);
      s_inv = inv;
    }
    __syncthreads();

    // multipliers and rank-1 update: warp w owns rows j+1+w, j+1+w+kWarps,
    // ...; its lanes walk the columns right of j
    const C inv = s_inv;
    for (int r = j + 1 + warp; r < m; r += kWarps) {
      C* row = a + static_cast<size_t>(r) * bs;
      const C c = row[j];
      C l;
      l.x = O::sub(O::mul(c.x, inv.x), O::mul(c.y, inv.y));
      l.y = O::add(O::mul(c.x, inv.y), O::mul(c.y, inv.x));
      for (int col = j + 1 + wl; col < bs; col += 32) {
        const C u = s_u[col];
        C v = row[col];
        v.x = O::sub(v.x, O::sub(O::mul(l.x, u.x), O::mul(l.y, u.y)));
        v.y = O::sub(v.y, O::add(O::mul(l.x, u.y), O::mul(l.y, u.x)));
        row[col] = v;
      }
      __syncwarp();
      if (wl == 0) row[j] = l;
    }
    __syncthreads();
  }
}

template <typename R>
int launch(void* panel, void* perm, int batch, int m, int bs, void* stream) {
  if (batch < 0 || bs < 1 || bs > kMaxBs || m < bs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  panel_lu_kernel<R><<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<typename Ops<R>::C*>(panel), static_cast<long long*>(perm),
      m, bs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// panel: (batch, m, bs) complex64 (float2) or complex128 (double2),
//        row-major, factored in place.
// perm:  (batch, m) int64, written.
extern "C" int gaunegf_panel_lu_c64(void* panel, void* perm, int batch, int m,
                                    int bs, void* stream) {
  return launch<float>(panel, perm, batch, m, bs, stream);
}

extern "C" int gaunegf_panel_lu_c128(void* panel, void* perm, int batch,
                                     int m, int bs, void* stream) {
  return launch<double>(panel, perm, batch, m, bs, stream);
}
