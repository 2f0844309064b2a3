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
// Bound on the card at B = 64 panels of (1024, 256): the work is
// sum_j (m-j-1)(bs-j-1) ~ (m bs^2 - bs^3/3) / 2 complex updates of 8 real
// operations each, 15.7 G operations, 0.235 ms at the 67 TFLOP/s peak
// (FP32 CUDA cores; FP64 tensor cores); the panel's bytes read and written
// once take 0.160 ms (complex128), so operations bound it.  Without fused
// multiply-adds (bit-identity) the floor is the CUDA cores' separately
// rounded rate: ~0.94 ms in complex128 (16.7 T ops/s), ~0.47 ms in
// complex64 (33.5 T ops/s).
//
// Design: left-looking in column sub-panels of width nb held on chip
// across a thread-block cluster, one cluster per panel.
//   * Traffic.  A right-looking rank-1 update per column streams the whole
//     trailing block through device memory bs times.  Here the ncta CTAs
//     of a cluster each hold a contiguous block of R rows of the current
//     sub-panel J = [j0, j0+nb) in shared memory.  J first takes the
//     pending updates of every earlier sub-panel K = [k0, k0+nb), in k
//     order: the K rows of J are solved with K's unit-lower triangle (each
//     CTA solves the nb x nb block itself, right-looking over k, reading
//     the owner's rows through distributed shared memory), then every row
//     below takes K's rank-nb update with K's multipliers streamed from
//     device memory once.  Then J's columns are factored right-looking on
//     chip.  Each panel element is loaded and stored once per sub-panel
//     (bs/nb times in all); the multipliers are read once per later
//     sub-panel.  Each element still takes its updates in ascending k
//     with the same rounding as the right-looking plain version, so the
//     result is identical.
//   * Pivot search.  The column argmax reads shared memory: a warp-shuffle
//     argmax inside each CTA; each CTA then publishes its candidate (the
//     partial, the candidate row and its reciprocal, and the owner of row
//     j that row) in buffers that alternate by column parity, so one
//     cluster barrier per column orders every read: after it each CTA
//     combines the partials (first row on ties) and reads the winner's row
//     and reciprocal through distributed shared memory.
//   * Occupancy.  ncta = SMs / batch CTAs per panel (1 to 8), so a chunk
//     of panels runs as one wave of CTAs, one per SM: at 64 energies, 2
//     CTAs of 512 threads per panel, 128 CTAs on the 132 SMs (the first
//     version's 4 CTAs per panel ran ~2.9 waves and took 1.7x longer).
//     nb is 32 where R rows fit shared memory, else 16 (complex128 at
//     m = 1024), else more CTAs, then 8 .. 1, so the sub-panel stays on
//     chip for every m whose matrix fits an 80 GB card.
// Row swaps: within J they are applied on chip at the moment of pivoting;
// the other columns of the panel take J's nb swaps in pivot order right
// after J is factored (nothing reads them in between), and so does perm.
// Sub-panel loads and stores are row-contiguous (nb values per row).
// What bounds it now (phase timers on the H100, complex128, (64, 1024,
// 256)): the K rank-nb updates (~half the time, near 60% of the FP64
// rate), then the 256 dependent per-column steps (~1 us each: barriers,
// shuffles, divisions), then the K-block solves.
//
// C interface (ctypes): each entry returns the CUDA error code of its
// launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

// Phase timers (tools/phase_timers.py builds this file with
// -DGAUNEGF_PHASE_CLOCKS): thread 0 of every CTA adds the clock cycles
// since its previous mark to phase k; without the define the marks vanish.
#ifdef GAUNEGF_PHASE_CLOCKS
__device__ unsigned long long g_phase_clk[8];
#define PHASE_START unsigned long long phase_t_ = clock64(), phase_acc_[8] = {};
#define PHASE(k)                                    \
  if (threadIdx.x == 0) {                           \
    const unsigned long long t_ = clock64();        \
    phase_acc_[k] += t_ - phase_t_;                 \
    phase_t_ = t_;                                  \
  }
#define PHASE_END                                                        \
  if (threadIdx.x == 0) {                                                \
    for (int k_ = 0; k_ < 8; ++k_) atomicAdd(&g_phase_clk[k_], phase_acc_[k_]); \
  }
#else
#define PHASE_START
#define PHASE(k)
#define PHASE_END
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBs = 1024;
constexpr int kMaxNb = 32;         // every nb divides 32, so R % nb == 0
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kRowAlign = 32;
constexpr int kTile = 4;           // rows per thread in the rank-nb update
constexpr size_t kSmemBudget = 220 * 1024;   // dynamic; static uses ~1.5 KB

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

// v -= l * u, in the plain version's order and rounding
template <typename R>
__device__ __forceinline__ void update(typename Ops<R>::C& v,
                                       typename Ops<R>::C l,
                                       typename Ops<R>::C u) {
  using O = Ops<R>;
  v.x = O::sub(v.x, O::sub(O::mul(l.x, u.x), O::mul(l.y, u.y)));
  v.y = O::sub(v.y, O::add(O::mul(l.x, u.y), O::mul(l.y, u.x)));
}

// l = c * inv
template <typename R>
__device__ __forceinline__ typename Ops<R>::C multiplier(
    typename Ops<R>::C c, typename Ops<R>::C inv) {
  using O = Ops<R>;
  typename Ops<R>::C l;
  l.x = O::sub(O::mul(c.x, inv.x), O::mul(c.y, inv.y));
  l.y = O::add(O::mul(c.x, inv.y), O::mul(c.y, inv.x));
  return l;
}

// 1 / p = (pr, -pi) / (pr^2 + pi^2), a zero denominator read as 1
template <typename R>
__device__ __forceinline__ typename Ops<R>::C reciprocal(typename Ops<R>::C p) {
  using O = Ops<R>;
  R den = O::add(O::mul(p.x, p.x), O::mul(p.y, p.y));
  if (den == static_cast<R>(0)) den = static_cast<R>(1);
  typename Ops<R>::C inv;
  inv.x = O::div(p.x, den);
  inv.y = O::div(-p.y, den);
  return inv;
}

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

// One cluster of ncta CTAs per panel; CTA `rank` holds rows
// [rank * rows, rank * rows + nrows) of the current sub-panel in s_a
// (row stride nb + 1: a column read is free of bank conflicts).
template <typename R>
__global__ void __launch_bounds__(kThreads, 1)
panel_lu_kernel(typename Ops<R>::C* __restrict__ panel,
                long long* __restrict__ perm, int m, int bs, int nb,
                int rows) {
  using O = Ops<R>;
  using C = typename O::C;
  PHASE_START
  cg::cluster_group cluster = cg::this_cluster();
  const int ncta = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  C* a = panel + static_cast<size_t>(blockIdx.x / ncta) * m * bs;
  long long* pm = perm + static_cast<size_t>(blockIdx.x / ncta) * m;
  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const int warp = tid >> 5;
  const int r0 = rank * rows;
  const int nrows = max(0, min(rows, m - r0));
  const int ld = nb + 1;
  // thread -> (column c, row group g) of the sub-panel; G groups
  const int c = tid % nb;
  const int g = tid / nb;
  const int G = kThreads / nb;
  // a one-CTA cluster needs only the CTA barrier
  auto sync_all = [&]() {
    if (ncta > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };

  extern __shared__ __align__(16) unsigned char smem[];
  C* s_a = reinterpret_cast<C*>(smem);        // rows x ld: the sub-panel
  C* s_U = s_a + static_cast<size_t>(rows) * ld;   // nb x ld: K's U block
  C* s_L = s_U + nb * ld;                     // nb x ld: K's unit-lower L
  __shared__ C s_u[kMaxNb];                   // pivot row (after the swap)
  __shared__ C s_inv;                         // the pivot's reciprocal
  __shared__ R s_wmag[kWarps];
  __shared__ int s_widx[kWarps];
  // this CTA's candidate, read by the cluster, by column parity
  __shared__ R s_cmag[2];
  __shared__ int s_cidx[2];
  __shared__ C s_cinv[2];
  __shared__ C s_cand[2][kMaxNb];
  __shared__ C s_rowj[2][kMaxNb];             // row j, from its owner
  __shared__ int s_piv[kMaxNb];               // the sub-panel's pivot rows

  for (int r = tid; r < nrows; r += kThreads) pm[r0 + r] = r0 + r;

  for (int j0 = 0; j0 < bs; j0 += nb) {
    const int w = min(nb, bs - j0);           // width of this sub-panel
    for (int e = tid; e < nrows * nb; e += kThreads) {
      const int i = e / nb, cc = e % nb;
      if (cc < w) s_a[i * ld + cc] = a[static_cast<size_t>(r0 + i) * bs + j0 + cc];
    }
    __syncthreads();
    PHASE(0)

    // ---- pending updates of the earlier sub-panels, in k order --------
    for (int k0 = 0; k0 < j0; k0 += nb) {
      sync_all();                  // the owner's rows [k0, k0+nb) are current
      const int owner = k0 / rows;
      const C* src = cluster.map_shared_rank(s_a, owner) +
                     static_cast<size_t>(k0 - owner * rows) * ld;
      for (int e = tid; e < nb * nb; e += kThreads) {
        const int i = e / nb, cc = e % nb;
        if (cc < w) s_U[i * ld + cc] = src[i * ld + cc];
        s_L[i * ld + cc] = a[static_cast<size_t>(k0 + i) * bs + k0 + cc];
      }
      __syncthreads();
      // forward substitution with K's unit-lower triangle, right-looking
      // over k (step k updates the rows below it), so every element takes
      // k = 0 .. r-1 in order
      for (int k = 0; k + 1 < nb; ++k) {
        if (c < w) {
          const C u = s_U[k * ld + c];
          for (int r = k + 1 + g; r < nb; r += G) {
            update<R>(s_U[r * ld + c], s_L[r * ld + k], u);
          }
        }
        __syncthreads();
      }
      sync_all();                  // every CTA has read the owner's rows
      PHASE(1)
      if (rank == owner) {
        for (int e = tid; e < nb * nb; e += kThreads) {
          const int i = e / nb, cc = e % nb;
          if (cc < w) s_a[(k0 - r0 + i) * ld + cc] = s_U[i * ld + cc];
        }
      }
      // rank-nb update of the rows below K: kTile rows per thread, each
      // element's k = k0 .. k0+nb-1 in order
      const int i_begin = max(0, k0 + nb - r0);
      if (c < w) {
        for (int i = i_begin + g; i < nrows; i += kTile * G) {
          C acc[kTile];
          const C* lrow[kTile];
#pragma unroll
          for (int q = 0; q < kTile; ++q) {
            const int ii = min(i + q * G, nrows - 1);
            acc[q] = s_a[ii * ld + c];
            lrow[q] = a + static_cast<size_t>(r0 + ii) * bs + k0;
          }
#pragma unroll 4
          for (int k = 0; k < nb; ++k) {
            const C u = s_U[k * ld + c];
#pragma unroll
            for (int q = 0; q < kTile; ++q) update<R>(acc[q], lrow[q][k], u);
          }
#pragma unroll
          for (int q = 0; q < kTile; ++q) {
            if (i + q * G < nrows) s_a[(i + q * G) * ld + c] = acc[q];
          }
        }
      }
      __syncthreads();
      PHASE(2)
    }

    // ---- factor the sub-panel's columns on chip ------------------------
    for (int t = 0; t < w; ++t) {
      const int j = j0 + t;
      // argmax of |a[r][j]|^2 over rows r >= j; each thread visits its
      // rows in ascending order and keeps the first of equal magnitudes
      R best = -INFINITY;
      int bidx = INT_MAX;
      for (int i = max(0, j - r0) + tid; i < nrows; i += kThreads) {
        const C v = s_a[i * ld + t];
        R mag = O::add(O::mul(v.x, v.x), O::mul(v.y, v.y));
        if (isnan(mag)) mag = static_cast<R>(INFINITY);   // argmax takes NaN
        if (mag > best) {
          best = mag;
          bidx = r0 + i;
        }
      }
      warp_argmax(best, bidx);
      if (wl == 0) {
        s_wmag[warp] = best;
        s_widx[warp] = bidx;
      }
      __syncthreads();
      // publish this CTA's candidate: its argmax partial, the candidate
      // row and its reciprocal, and (the owner of row j) row j; buffers
      // alternate by column parity, so one cluster barrier per column
      // orders every read of them
      const int par = t & 1;
      if (warp == 0) {
        best = wl < kWarps ? s_wmag[wl] : static_cast<R>(-INFINITY);
        bidx = wl < kWarps ? s_widx[wl] : INT_MAX;
        warp_argmax(best, bidx);
        bidx = __shfl_sync(0xffffffffu, bidx, 0);
        if (bidx != INT_MAX) {
          const C* row = s_a + (bidx - r0) * ld;
          if (wl < w) s_cand[par][wl] = row[wl];
          if (wl == 0) s_cinv[par] = reciprocal<R>(row[t]);
        }
        if (rank == j / rows && wl < w) s_rowj[par][wl] = s_a[(j - r0) * ld + wl];
        if (wl == 0) {
          s_cmag[par] = best;
          s_cidx[par] = bidx;
        }
      }
      sync_all();                  // every CTA's candidate is published
      PHASE(3)
      if (warp == 0) {
        best = wl < ncta ? cluster.map_shared_rank(s_cmag, wl)[par]
                         : static_cast<R>(-INFINITY);
        bidx = wl < ncta ? cluster.map_shared_rank(s_cidx, wl)[par] : INT_MAX;
        warp_argmax(best, bidx);
        const int p = __shfl_sync(0xffffffffu, bidx, 0);
        const int op = p / rows, oj = j / rows;
        // the pivot row, and the swap of rows j and p by their owners
        if (wl < w) {
          const C u = cluster.map_shared_rank(s_cand[par], op)[wl];
          s_u[wl] = u;
          if (p != j) {
            if (rank == oj) s_a[(j - r0) * ld + wl] = u;
            if (rank == op) {
              s_a[(p - r0) * ld + wl] = cluster.map_shared_rank(s_rowj[par], oj)[wl];
            }
          }
        }
        if (wl == 0) {
          s_inv = cluster.map_shared_rank(s_cinv, op)[par];
          s_piv[t] = p;
        }
      }
      __syncthreads();
      PHASE(4)
      // multipliers of column t, then the rank-1 update of the columns
      // right of t (rows > j); kTile rows at a time: all loads, then the
      // arithmetic, then the stores
      const C inv = s_inv;
      const int first = max(0, j + 1 - r0);
      for (int i = first + tid; i < nrows; i += kThreads) {
        s_a[i * ld + t] = multiplier<R>(s_a[i * ld + t], inv);
      }
      __syncthreads();
      if (c > t && c < w) {
        const C u = s_u[c];
        for (int i = first + g; i < nrows; i += kTile * G) {
          C v[kTile], l[kTile];
#pragma unroll
          for (int q = 0; q < kTile; ++q) {
            const int ii = min(i + q * G, nrows - 1);
            l[q] = s_a[ii * ld + t];
            v[q] = s_a[ii * ld + c];
          }
#pragma unroll
          for (int q = 0; q < kTile; ++q) update<R>(v[q], l[q], u);
#pragma unroll
          for (int q = 0; q < kTile; ++q) {
            if (i + q * G < nrows) s_a[(i + q * G) * ld + c] = v[q];
          }
        }
      }
      __syncthreads();
      PHASE(5)
    }

    // ---- store the sub-panel; the other columns take its row swaps -----
    for (int e = tid; e < nrows * nb; e += kThreads) {
      const int i = e / nb, cc = e % nb;
      if (cc < w) a[static_cast<size_t>(r0 + i) * bs + j0 + cc] = s_a[i * ld + cc];
    }
    for (int x = rank * kThreads + tid; x < bs - w; x += ncta * kThreads) {
      const int col = x < j0 ? x : x + w;
      for (int t = 0; t < w; ++t) {
        const int p = s_piv[t];
        if (p == j0 + t) continue;
        C* xj = a + static_cast<size_t>(j0 + t) * bs + col;
        C* xp = a + static_cast<size_t>(p) * bs + col;
        const C vj = *xj;
        *xj = *xp;
        *xp = vj;
      }
    }
    if (rank == 0 && tid == 0) {
      for (int t = 0; t < w; ++t) {
        const int p = s_piv[t];
        const long long v = pm[j0 + t];
        pm[j0 + t] = pm[p];
        pm[p] = v;
      }
    }
    sync_all();                    // swaps and stores seen by the cluster
    PHASE(6)
  }
  PHASE_END
}

struct Config {
  int nb, ncta, rows;
  size_t smem;
};

// The cluster size aims at one wave of CTAs, one per SM: sms / batch
// CTAs per panel (1 to 8).  The sub-panel is the widest that fits shared
// memory, down to 16 columns at that size; past it, more CTAs, then
// narrower sub-panels.
bool pick_config(int m, size_t elem, int batch, int sms, Config* cfg) {
  const int want = std::min(kMaxCluster, std::max(1, sms / std::max(batch, 1)));
  for (int nb_min : {16, 8, 1}) {
    for (int ncta = want; ncta <= kMaxCluster; ++ncta) {
      for (int nb = kMaxNb; nb >= nb_min; nb /= 2) {
        const int per = (m + ncta - 1) / ncta;
        const int rows = (per + kRowAlign - 1) / kRowAlign * kRowAlign;
        const size_t smem =
            (static_cast<size_t>(rows) + 2 * nb) * (nb + 1) * elem;
        if (smem <= kSmemBudget) {
          *cfg = {nb, ncta, rows, smem};
          return true;
        }
      }
    }
  }
  return false;
}

// SMs of the current device, or 0 where CUDA cannot say
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  return n;
}

template <typename R>
int launch(void* panel, void* perm, int batch, int m, int bs, void* stream) {
  using C = typename Ops<R>::C;
  Config cfg;
  if (batch < 0 || bs < 1 || bs > kMaxBs || m < bs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaGetLastError());
  if (!pick_config(m, sizeof(C), batch, sms, &cfg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = panel_lu_kernel<R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(cfg.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(static_cast<unsigned>(batch) * cfg.ncta);
  lc.blockDim = dim3(kThreads);
  lc.dynamicSmemBytes = cfg.smem;
  lc.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cfg.ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.attrs = attr;
  lc.numAttrs = 1;
  err = cudaLaunchKernelEx(&lc, kernel, static_cast<C*>(panel),
                           static_cast<long long*>(perm), m, bs, cfg.nb,
                           cfg.rows);
  if (err != cudaSuccess) return static_cast<int>(err);
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

// The sub-panel width, CTAs per cluster and rows per CTA the kernel picks
// for a batch of panels of height m (elem = bytes of one complex value) on
// the current device: written to out[0..2]; returns 0, or
// cudaErrorInvalidValue when no configuration fits.
extern "C" int gaunegf_panel_lu_config(int m, int elem, int batch, int* out) {
  Config cfg;
  const int sms = sm_count();
  if (m < 1 || batch < 1 || sms == 0 ||
      !pick_config(m, static_cast<size_t>(elem), batch, sms, &cfg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = cfg.nb;
  out[1] = cfg.ncta;
  out[2] = cfg.rows;
  return 0;
}

#ifdef GAUNEGF_PHASE_CLOCKS
// The phase timers' cycle sums (8 values) into out, then zeroed.
extern "C" int gaunegf_panel_lu_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_clk, sizeof(g_phase_clk));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_clk, zero, sizeof(zero)));
}
#endif
