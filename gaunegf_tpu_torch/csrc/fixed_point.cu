// Kernel A: the relaxed Jacobi fixed point of the Bethe-lattice
// self-energies on 9x9 blocks, the whole loop inside one launch.
//
// Replaces the jitted `lax.while_loop`s of the JAX package:
//   gaunegf_tpu/models/bethe.py:135   bethe_sigma_k (Jacobi and Seidel,
//                                     with and without exclusion)
//   gaunegf_tpu/models/bethe.py:184   bethe_sigma_surface (the in-plane
//                                     re-relaxation after the bulk loop)
//   gaunegf_tpu/models/kspace.py:384  kspace_sigma_surface (the same
//                                     re-relaxation around the k-averaged
//                                     half-space term)
// None of them is a `pallas_call`: on the TPU each is one compiled XLA
// while loop, so the iteration never leaves the device.  The eager port
// ran each sweep as ~12 small launches with a host check every few sweeps
// (0.55-0.69 ms a sweep on the H100 at any batch).
//
// Per lane (one energy, or one energy x k point) it iterates
//     sigma_k <- mix * B_k g_k B_k^+ + (1 - mix) * sigma_k
// on the updated slots, with g_k = inv(A - sum_j sigma_j + sigma_pair(k))
// (exclusion) or one shared g = inv(A - sum_j sigma_j), until the lane's
// relative change max|sigma - sigma_old| / max(max|sigma_old|, 1e-30) is
// <= conv or max_iter sweeps have run.  Modes:
//   bulk    12 slots, all updated; Jacobi (every direction from the sweep's
//           old state) or Seidel (directions 0..5 first, then 6..11 with
//           their opposite slot already refreshed -- the reference's order,
//           which needs only two rounds because pair(k) = k +- 6);
//   surface 9 slots, the 6 in-plane ones (PLANE_DIRS) updated from one
//           shared inverse; after a bulk loop it starts from the bulk
//           state's first 9 slots in the same launch.
//
// What bounds it on this card: not bytes (a lane reads 17 KB once) and not
// FP64 operations (~2.3e5 a bulk sweep, microseconds for a whole batch at
// 67 TFLOP/s), but the latency of the dependent chain inside a sweep: nine
// pivot steps of each 9x9 inverse, then two 9x9 products, then a lane-wide
// max.  The design keeps that chain on one SM and out of device memory:
// one CTA per lane, twelve warps, one per direction (each inverts and
// multiplies its own block, so the twelve inverses of a sweep run side by
// side), sigma, A, B and each warp's work blocks in shared memory (~65 KB,
// above the 48 KB default, so the launch raises the limit), the metric a
// CTA-wide max, and the convergence test read by every thread from shared
// memory -- no host synchronisation and no launch per sweep.  The inverse
// is Gauss-Jordan in place with partial pivoting (|re| + |im| as LAPACK's
// izamax, the first row on ties), which differs from the plain version's
// getrf/getri only in rounding.  Everything is complex128.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 9;              // orbitals of an spd atom
constexpr int DD = D * D;
constexpr int NN = 12;            // nearest-neighbour directions (fcc)
constexpr int NS = 9;             // surface slots (the 3 upward ones dropped)
constexpr int NP = 6;             // in-plane slots
constexpr int WARPS = NN;         // one warp per direction
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

constexpr int BULK_NONE = 0, BULK_SEIDEL = 2;   // 1: Jacobi

__constant__ int kPair[NN] = {6, 7, 8, 9, 10, 11, 0, 1, 2, 3, 4, 5};
__constant__ int kPlane[NP] = {0, 1, 2, 6, 7, 8};

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * conj(b)
__device__ __forceinline__ double2 cmulc(double2 a, double2 b) {
  return make_double2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}
__device__ __forceinline__ double cabs2(double2 a) { return hypot(a.x, a.y); }
// 1 / a by Smith's rule (no overflow of |a|^2)
__device__ __forceinline__ double2 crecip(double2 a) {
  if (fabs(a.x) >= fabs(a.y)) {
    const double r = a.y / a.x, d = a.x + a.y * r;
    return make_double2(1.0 / d, -r / d);
  }
  const double r = a.x / a.y, d = a.x * r + a.y;
  return make_double2(r / d, -1.0 / d);
}
// max that keeps a NaN, as torch's amax does
__device__ __forceinline__ double nanmax(double a, double b) {
  return (a != a || b != b) ? NAN : fmax(a, b);
}

// In-place inverse of the 9x9 block W (row-major) by one warp: Gauss-Jordan
// with partial pivoting, the row swaps undone as column swaps at the end.
// F is the warp's 9-entry scratch for the pivot column.
__device__ void warp_inverse9(double2* W, double2* F, int lane) {
  int swaps[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    double mag = -1.0;
    int row = D;
    if (lane >= c && lane < D) {
      const double2 v = W[lane * D + c];
      mag = fabs(v.x) + fabs(v.y);
      row = lane;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const double om = __shfl_xor_sync(FULL, mag, off);
      const int orow = __shfl_xor_sync(FULL, row, off);
      if (om > mag || (om == mag && orow < row)) {
        mag = om;
        row = orow;
      }
    }
    swaps[c] = row;
    if (row != c) {                      // warp-uniform
      if (lane < D) {
        const double2 t = W[c * D + lane];
        W[c * D + lane] = W[row * D + lane];
        W[row * D + lane] = t;
      }
      __syncwarp();
    }
    const double2 inv = crecip(W[c * D + c]);
    double2 rc = make_double2(0.0, 0.0);
    if (lane < D) {
      F[lane] = W[lane * D + c];
      rc = W[c * D + lane];
    }
    __syncwarp();
    if (lane < D)
      W[c * D + lane] = cmul(lane == c ? make_double2(1.0, 0.0) : rc, inv);
    __syncwarp();
    for (int e = lane; e < DD; e += 32) {
      const int r = e / D, j = e - r * D;
      if (r != c) {
        const double2 w = j == c ? make_double2(0.0, 0.0) : W[e];
        W[e] = csub(w, cmul(F[r], W[c * D + j]));
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int c = D - 1; c >= 0; --c) {
    const int p = swaps[c];
    if (p != c) {
      if (lane < D) {
        const double2 t = W[lane * D + p];
        W[lane * D + p] = W[lane * D + c];
        W[lane * D + c] = t;
      }
      __syncwarp();
    }
  }
}

// sigma_k <- mix * (B_k g) B_k^+ + (1 - mix) sigma_k by one warp; returns
// the warp lane's largest |new - old|.
__device__ double update_slot(double2* sig_k, const double2* Bk,
                              const double2* g, double2* T, double mix,
                              int lane) {
  for (int e = lane; e < DD; e += 32) {
    const int i = e / D, j = e - i * D;
    double2 s = make_double2(0.0, 0.0);
#pragma unroll
    for (int l = 0; l < D; ++l) s = cadd(s, cmul(Bk[i * D + l], g[l * D + j]));
    T[e] = s;
  }
  __syncwarp();
  double dmax = 0.0;
  for (int e = lane; e < DD; e += 32) {
    const int i = e / D, j = e - i * D;
    double2 s = make_double2(0.0, 0.0);
#pragma unroll
    for (int l = 0; l < D; ++l) s = cadd(s, cmulc(T[i * D + l], Bk[j * D + l]));
    const double2 old = sig_k[e];
    const double2 nw = make_double2(mix * s.x + (1.0 - mix) * old.x,
                                    mix * s.y + (1.0 - mix) * old.y);
    dmax = nanmax(dmax, cabs2(csub(nw, old)));
    sig_k[e] = nw;
  }
  return dmax;
}

struct Smem {
  double2* A;      // DD
  double2* B;      // NN * DD
  double2* sig;    // NN * DD
  double2* tot;    // DD
  double2* W;      // WARPS * DD: each warp's block to invert
  double2* T;      // WARPS * DD: each warp's B_k g
  double2* F;      // WARPS * D: each warp's pivot column
  double* red;     // 2 * WARPS
};

__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(double2) * (DD + 2 * NN * DD + DD + 2 * WARPS * DD + WARPS * D)
         + sizeof(double) * 2 * WARPS;
}

// One fixed-point loop on the lane's state in S.sig; returns the sweeps run
// and leaves the last metric in *metric.
__device__ int run_loop(const Smem& S, bool bulk, int bulk_mode,
                        bool exclusion, double conv, double mix, int max_iter,
                        double* metric) {
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int nslots = bulk ? NN : NS;
  double diff = INFINITY;
  int it = 0;
  while (it < max_iter && diff > conv) {
    double omax = 0.0, dmax = 0.0;
    if (tid < DD) {
      double2 s = make_double2(0.0, 0.0);
      for (int k = 0; k < nslots; ++k) {
        const double2 v = S.sig[k * DD + tid];
        s = cadd(s, v);
        omax = nanmax(omax, cabs2(v));
      }
      S.tot[tid] = s;
    }
    __syncthreads();
    if (bulk && exclusion) {
      const int rounds = bulk_mode == BULK_SEIDEL ? 2 : 1;
      for (int round = 0; round < rounds; ++round) {
        // Jacobi: every warp in the one round; Seidel: 0..5, then 6..11
        const bool active = rounds == 1 || (w < NP) == (round == 0);
        double2* W = S.W + w * DD;
        if (active) {
          const double2* sp = S.sig + kPair[w] * DD;
          for (int e = lane; e < DD; e += 32)
            W[e] = cadd(csub(S.A[e], S.tot[e]), sp[e]);
        }
        __syncthreads();            // every M built before a slot changes
        if (active) {
          __syncwarp();
          warp_inverse9(W, S.F + w * D, lane);
          dmax = nanmax(dmax, update_slot(S.sig + w * DD, S.B + w * DD, W,
                                          S.T + w * DD, mix, lane));
        }
        __syncthreads();
      }
    } else {
      if (w == 0) {
        for (int e = lane; e < DD; e += 32) S.W[e] = csub(S.A[e], S.tot[e]);
        __syncwarp();
        warp_inverse9(S.W, S.F, lane);
      }
      __syncthreads();
      if (bulk || w < NP) {
        const int k = bulk ? w : kPlane[w];
        dmax = update_slot(S.sig + k * DD, S.B + k * DD, S.W, S.T + w * DD,
                           mix, lane);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dmax = nanmax(dmax, __shfl_xor_sync(FULL, dmax, off));
      omax = nanmax(omax, __shfl_xor_sync(FULL, omax, off));
    }
    if (lane == 0) {
      S.red[w] = dmax;
      S.red[WARPS + w] = omax;
    }
    __syncthreads();
    double d = 0.0, o = 0.0;
    for (int i = 0; i < WARPS; ++i) {
      d = nanmax(d, S.red[i]);
      o = nanmax(o, S.red[WARPS + i]);
    }
    __syncthreads();                  // red is rewritten by the next sweep
    diff = d / fmax(o, 1e-30);
    if (o != o) diff = NAN;
    ++it;
  }
  *metric = diff;
  return it;
}

__global__ void __launch_bounds__(THREADS)
fixed_point_kernel(const double2* __restrict__ A,
                   const double2* __restrict__ B, double2* sig_bulk,
                   double2* sig_surf, int* counts, double* metrics,
                   int bulk_mode, int exclusion, int surface, double conv,
                   double mix, int max_iter) {
  extern __shared__ double2 smem[];
  Smem S;
  S.A = smem;
  S.B = S.A + DD;
  S.sig = S.B + NN * DD;
  S.tot = S.sig + NN * DD;
  S.W = S.tot + DD;
  S.T = S.W + WARPS * DD;
  S.F = S.T + WARPS * DD;
  S.red = reinterpret_cast<double*>(S.F + WARPS * D);

  const size_t ln = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < DD; i += THREADS) S.A[i] = A[ln * DD + i];
  for (int i = tid; i < NN * DD; i += THREADS) S.B[i] = B[ln * NN * DD + i];
  const bool bulk = bulk_mode != BULK_NONE;
  if (bulk) {
    for (int i = tid; i < NN * DD; i += THREADS)
      S.sig[i] = sig_bulk[ln * NN * DD + i];
  } else {
    for (int i = tid; i < NS * DD; i += THREADS)
      S.sig[i] = sig_surf[ln * NS * DD + i];
  }
  __syncthreads();
  double metric = INFINITY;
  int n = 0;
  if (bulk) {
    n = run_loop(S, true, bulk_mode, exclusion != 0, conv, mix, max_iter,
                 &metric);
    for (int i = tid; i < NN * DD; i += THREADS)
      sig_bulk[ln * NN * DD + i] = S.sig[i];
    if (tid == 0) {
      counts[2 * ln] = n;
      metrics[2 * ln] = metric;
    }
    __syncthreads();
  }
  if (surface) {
    n = run_loop(S, false, BULK_NONE, false, conv, mix, max_iter, &metric);
    for (int i = tid; i < NS * DD; i += THREADS)
      sig_surf[ln * NS * DD + i] = S.sig[i];
    if (tid == 0) {
      counts[2 * ln + 1] = n;
      metrics[2 * ln + 1] = metric;
    }
  }
}

}  // namespace

extern "C" {

// One launch, one CTA per lane.  A (b, 9, 9), B (b, 12, 9, 9) complex128;
// bulk_mode 0 (none), 1 (Jacobi) or 2 (Seidel) with sig_bulk (b, 12, 9, 9)
// the seed, overwritten by the result; surface != 0 runs the in-plane loop
// into sig_surf (b, 9, 9, 9): from the bulk result when a bulk loop ran,
// else from sig_surf's own content.  counts (b, 2) int32 and metrics (b, 2)
// float64 receive each loop's sweeps and last relative change.  Returns the
// CUDA error of the launch (0 on success).
int gaunegf_fixed_point_c128(const void* A, const void* B, void* sig_bulk,
                             void* sig_surf, void* counts, void* metrics,
                             int b, int bulk_mode, int exclusion, int surface,
                             double conv, double mix, int max_iter,
                             void* stream) {
  if (b <= 0 || bulk_mode < BULK_NONE || bulk_mode > BULK_SEIDEL
      || (bulk_mode == BULK_NONE && !surface))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        fixed_point_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes());
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  fixed_point_kernel<<<b, THREADS, smem_bytes(),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(A), static_cast<const double2*>(B),
      static_cast<double2*>(sig_bulk), static_cast<double2*>(sig_surf),
      static_cast<int*>(counts), static_cast<double*>(metrics), bulk_mode,
      exclusion, surface, conv, mix, max_iter);
  return (int)cudaGetLastError();
}

}  // extern "C"
