// Kernel B: Sancho-Rubio decimation and the relaxed Dyson map of a
// semi-infinite lead's surface Green's function on n x n blocks, the whole
// loop inside one launch.
//
// Replaces the jitted `lax.while_loop`s of the JAX package:
//   gaunegf_tpu/models/chain1d.py:108  surface_g_sancho (balanced
//                                      decimation, quadratic convergence)
//   gaunegf_tpu/models/chain1d.py:135  surface_g_dyson (the reference's
//                                      relaxed fixed point)
//   and, through surface_g_sancho, the per-k decimation of
//   gaunegf_tpu/models/kspace.py:292 kspace_sigma_down.
// None of them is a `pallas_call`: on the TPU each is one compiled XLA
// while loop.  The eager port ran every iteration as a dozen launches and
// synchronised the host on each one.
//
// Per lane (one energy, or one energy x k point):
//   sancho  eps_s = eps = A, al = B, be = B^+, c = 0; per iteration
//           g = inv(eps), agb = (al g) be 2^c, bga = (be g) al 2^c,
//           eps_s -= agb, eps -= agb + bga, al = (al g) al / sa,
//           be = (be g) be / sb with sa, sb the powers of two
//           exp2(ceil(log2(max|.|))) of the new couplings (exact), and
//           c = 2c + log2 sa + log2 sb; stop when
//           max|eps_s' - eps_s| / max(max|eps_s'|, 1e-30) <= conv or after
//           max_iter iterations; return inv(eps_s);
//   dyson   g = inv(A); per iteration g' = inv(A - (B g) B^+),
//           metric max(|g' - g| / max(|g'|, 1e-12)), g = g' relax +
//           g (1 - relax); return g.
//
// What bounds it on this card: at the paths' sizes (n = 1 for the chains,
// 9 for the k-space lanes, tens for wide lead cells) neither bytes nor FP64
// operations (an iteration is ~14 n^3 complex multiply-adds) but the
// dependent chain of an iteration: n pivot steps of the inverse, then the
// products, then a lane-wide max.  The design keeps that chain on one SM:
// one CTA per lane (up to 256 threads, one per entry of the block), the
// nine live blocks of a decimation (five of the Dyson map) in shared memory
// for n <= 32 (148 KB at n = 32, above the 48 KB default, so the launch
// raises the limit) and in a global scratch the wrapper allocates beyond
// that -- the same code, other addresses, so every n launches the kernel.
// The inverse is a CTA-wide Gauss-Jordan in place with partial pivoting
// (|re| + |im| as LAPACK's izamax, the first row on ties); it differs from
// the plain version's getrf/getri only in rounding.  No host
// synchronisation and no launch per iteration.  Everything is complex128.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_SHARED_N = 32;
constexpr int SANCHO_BLOCKS = 9;
constexpr int DYSON_BLOCKS = 5;
constexpr int MODE_SANCHO = 0, MODE_DYSON = 1;
constexpr unsigned FULL = 0xffffffffu;

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
__device__ __forceinline__ double2 cscale(double2 a, double s) {
  return make_double2(a.x * s, a.y * s);
}
__device__ __forceinline__ double cabs2(double2 a) { return hypot(a.x, a.y); }
__device__ __forceinline__ double2 crecip(double2 a) {
  if (fabs(a.x) >= fabs(a.y)) {
    const double r = a.y / a.x, d = a.x + a.y * r;
    return make_double2(1.0 / d, -r / d);
  }
  const double r = a.x / a.y, d = a.x * r + a.y;
  return make_double2(r / d, -1.0 / d);
}
__device__ __forceinline__ double nanmax(double a, double b) {
  return (a != a || b != b) ? NAN : fmax(a, b);
}

struct Small {          // per-CTA scratch, always in shared memory
  double2* F;           // n: the pivot column
  double* red;          // 4 * 32 warp partials
  int* swaps;           // n
};

__host__ __device__ inline size_t small_bytes(int n) {
  return sizeof(double2) * n + sizeof(double) * 4 * 32 + sizeof(int) * n;
}

__device__ Small carve_small(void* at, int n) {
  Small s;
  s.F = static_cast<double2*>(at);
  s.red = reinterpret_cast<double*>(s.F + n);
  s.swaps = reinterpret_cast<int*>(s.red + 4 * 32);
  return s;
}

// CTA-wide max of up to four values (NaN kept); every thread gets them.
__device__ void block_max(double* v, int k, const Small& s) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  for (int q = 0; q < k; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[q] = nanmax(v[q], __shfl_xor_sync(FULL, v[q], off));
    if (lane == 0) s.red[q * 32 + w] = v[q];
  }
  __syncthreads();
  for (int q = 0; q < k; ++q) {
    double m = 0.0;
    for (int i = 0; i < warps; ++i) m = nanmax(m, s.red[q * 32 + i]);
    v[q] = m;
  }
  __syncthreads();
}

// In-place inverse of the n x n block W (row-major) by the whole CTA:
// Gauss-Jordan with partial pivoting, the row swaps undone as column swaps.
__device__ void block_inverse(double2* W, int n, const Small& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int c = 0; c < n; ++c) {
    if (tid < 32) {
      double mag = -1.0;
      int row = n;
      for (int r = c + tid; r < n; r += 32) {
        const double2 v = W[r * n + c];
        const double m = fabs(v.x) + fabs(v.y);
        if (m > mag) {
          mag = m;
          row = r;
        }
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
      if (tid == 0) s.swaps[c] = row < n ? row : c;
    }
    __syncthreads();
    const int p = s.swaps[c];
    if (p != c) {                        // CTA-uniform
      for (int j = tid; j < n; j += nt) {
        const double2 t = W[c * n + j];
        W[c * n + j] = W[p * n + j];
        W[p * n + j] = t;
      }
      __syncthreads();
    }
    const double2 inv = crecip(W[c * n + c]);
    for (int r = tid; r < n; r += nt) s.F[r] = W[r * n + c];
    __syncthreads();
    for (int j = tid; j < n; j += nt)
      W[c * n + j] = cmul(j == c ? make_double2(1.0, 0.0) : W[c * n + j], inv);
    __syncthreads();
    for (int e = tid; e < n * n; e += nt) {
      const int r = e / n, j = e - r * n;
      if (r != c) {
        const double2 w = j == c ? make_double2(0.0, 0.0) : W[e];
        W[e] = csub(w, cmul(s.F[r], W[c * n + j]));
      }
    }
    __syncthreads();
  }
  for (int c = n - 1; c >= 0; --c) {
    const int p = s.swaps[c];
    if (p != c) {
      for (int r = tid; r < n; r += nt) {
        const double2 t = W[r * n + p];
        W[r * n + p] = W[r * n + c];
        W[r * n + c] = t;
      }
      __syncthreads();
    }
  }
}

__device__ void copy_block(double2* dst, const double2* src, int nn) {
  for (int e = threadIdx.x; e < nn; e += blockDim.x) dst[e] = src[e];
}

// The lane's blocks: at the start of shared memory, ahead of the small
// scratch, when on chip; else in the lane's slice of the global scratch.
struct Lane {
  double2* blocks;
  Small s;
};

__device__ Lane lane_memory(double2* scratch, int n, int nblocks) {
  extern __shared__ double2 smem[];
  Lane L;
  const size_t nn = (size_t)n * n;
  if (scratch == nullptr) {
    L.blocks = smem;
    L.s = carve_small(smem + nblocks * nn, n);
  } else {
    L.blocks = scratch + (size_t)blockIdx.x * nblocks * nn;
    L.s = carve_small(smem, n);
  }
  return L;
}

__global__ void __launch_bounds__(MAX_THREADS)
sancho_kernel(const double2* __restrict__ A, const double2* __restrict__ B,
              double2* G, int* counts, double* metrics, double2* scratch,
              int n, double conv, int max_iter) {
  const int nn = n * n;
  const Lane L = lane_memory(scratch, n, SANCHO_BLOCKS);
  double2* eps_s = L.blocks;
  double2* eps = eps_s + nn;
  double2* al = eps + nn;
  double2* be = al + nn;
  double2* al2 = be + nn;
  double2* be2 = al2 + nn;
  double2* W = be2 + nn;
  double2* X = W + nn;
  double2* Y = X + nn;
  const size_t ln = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const double2* Al = A + ln * nn;
  const double2* Bl = B + ln * nn;
  for (int e = tid; e < nn; e += nt) {
    const int i = e / n, j = e - i * n;
    eps_s[e] = eps[e] = Al[e];
    al[e] = Bl[e];
    const double2 t = Bl[j * n + i];
    be[e] = make_double2(t.x, -t.y);
  }
  __syncthreads();
  const double tiny = 1.1754943508222875e-38;   // float32's tiny
  double c = 0.0, diff = INFINITY;
  int it = 0;
  while (it < max_iter && diff > conv) {
    copy_block(W, eps, nn);
    __syncthreads();
    block_inverse(W, n, L.s);                     // g = inv(eps)
    for (int e = tid; e < nn; e += nt) {
      const int i = e / n, j = e - i * n;
      double2 x = make_double2(0.0, 0.0), y = x;
      for (int l = 0; l < n; ++l) {
        const double2 g = W[l * n + j];
        x = cadd(x, cmul(al[i * n + l], g));
        y = cadd(y, cmul(be[i * n + l], g));
      }
      X[e] = x;
      Y[e] = y;
    }
    __syncthreads();
    const double scale = exp2(c);
    double v[4] = {0.0, 0.0, 0.0, 0.0};   // max |d eps_s|, |eps_s'|, |al'|, |be'|
    for (int e = tid; e < nn; e += nt) {
      const int i = e / n, j = e - i * n;
      double2 xb = make_double2(0.0, 0.0), ya = xb, xa = xb, yb = xb;
      for (int l = 0; l < n; ++l) {
        const double2 x = X[i * n + l], y = Y[i * n + l];
        const double2 a = al[l * n + j], b = be[l * n + j];
        xb = cadd(xb, cmul(x, b));
        ya = cadd(ya, cmul(y, a));
        xa = cadd(xa, cmul(x, a));
        yb = cadd(yb, cmul(y, b));
      }
      const double2 agb = cscale(xb, scale), bga = cscale(ya, scale);
      const double2 es = eps_s[e];
      const double2 es_new = csub(es, agb);
      eps[e] = csub(csub(eps[e], agb), bga);
      eps_s[e] = es_new;
      al2[e] = xa;
      be2[e] = yb;
      v[0] = nanmax(v[0], cabs2(csub(es_new, es)));
      v[1] = nanmax(v[1], cabs2(es_new));
      v[2] = nanmax(v[2], cabs2(xa));
      v[3] = nanmax(v[3], cabs2(yb));
    }
    block_max(v, 4, L.s);
    const double ma = v[2] != v[2] ? v[2] : fmax(v[2], tiny);
    const double mb = v[3] != v[3] ? v[3] : fmax(v[3], tiny);
    const double sa = exp2(ceil(log2(ma))), sb = exp2(ceil(log2(mb)));
    c = 2.0 * c + log2(sa) + log2(sb);
    for (int e = tid; e < nn; e += nt) {
      const double2 a = al2[e], b = be2[e];
      al[e] = make_double2(a.x / sa, a.y / sa);
      be[e] = make_double2(b.x / sb, b.y / sb);
    }
    diff = v[1] != v[1] ? NAN : v[0] / fmax(v[1], 1e-30);
    ++it;
    __syncthreads();
  }
  copy_block(W, eps_s, nn);
  __syncthreads();
  block_inverse(W, n, L.s);
  copy_block(G + ln * nn, W, nn);
  if (tid == 0) {
    counts[ln] = it;
    metrics[ln] = diff;
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
dyson_kernel(const double2* __restrict__ A, const double2* __restrict__ B,
             double2* G, int* counts, double* metrics, double2* scratch,
             int n, double conv, double relax, int max_iter) {
  const int nn = n * n;
  const Lane L = lane_memory(scratch, n, DYSON_BLOCKS);
  double2* a = L.blocks;
  double2* b = a + nn;
  double2* g = b + nn;
  double2* T = g + nn;
  double2* W = T + nn;
  const size_t ln = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  copy_block(a, A + ln * nn, nn);
  copy_block(b, B + ln * nn, nn);
  copy_block(W, A + ln * nn, nn);
  __syncthreads();
  block_inverse(W, n, L.s);                       // g0 = inv(A)
  copy_block(g, W, nn);
  __syncthreads();
  double diff = INFINITY;
  int it = 0;
  while (it < max_iter && diff > conv) {
    for (int e = tid; e < nn; e += nt) {
      const int i = e / n, j = e - i * n;
      double2 t = make_double2(0.0, 0.0);
      for (int l = 0; l < n; ++l) t = cadd(t, cmul(b[i * n + l], g[l * n + j]));
      T[e] = t;
    }
    __syncthreads();
    for (int e = tid; e < nn; e += nt) {
      const int i = e / n, j = e - i * n;
      double2 t = make_double2(0.0, 0.0);
      for (int l = 0; l < n; ++l) t = cadd(t, cmulc(T[i * n + l], b[j * n + l]));
      W[e] = csub(a[e], t);
    }
    __syncthreads();
    block_inverse(W, n, L.s);                     // g' = inv(A - B g B^+)
    double v[1] = {0.0};
    for (int e = tid; e < nn; e += nt) {
      const double2 gn = W[e], go = g[e];
      v[0] = nanmax(v[0], cabs2(csub(gn, go)) / fmax(cabs2(gn), 1e-12));
      g[e] = cadd(cscale(gn, relax), cscale(go, 1.0 - relax));
    }
    block_max(v, 1, L.s);
    diff = v[0];
    ++it;
  }
  copy_block(G + ln * nn, g, nn);
  if (tid == 0) {
    counts[ln] = it;
    metrics[ln] = diff;
  }
}

size_t shared_bytes(int n, int nblocks, bool on_chip) {
  return (on_chip ? sizeof(double2) * nblocks * (size_t)n * n : 0)
         + small_bytes(n);
}

int threads_for(int n) {
  const int want = ((n * n + 31) / 32) * 32;
  return want < 32 ? 32 : (want > MAX_THREADS ? MAX_THREADS : want);
}

}  // namespace

extern "C" {

// One launch, one CTA per lane.  A, B (b, n, n) complex128 in, G (b, n, n)
// out; counts (b,) int32 and metrics (b,) float64 receive each lane's
// iterations and last metric.  mode 0: Sancho-Rubio (max_iter iterations
// at most, relax unused); mode 1: the relaxed Dyson map.  scratch: null
// keeps the blocks in shared memory (n <= 32); else a device buffer of
// b * (9 or 5) * n * n complex128 that holds them.  Returns the CUDA error
// of the launch (0 on success).
int gaunegf_sancho_rubio_c128(const void* A, const void* B, void* G,
                              void* counts, void* metrics, void* scratch,
                              int b, int n, int mode, double conv,
                              double relax, int max_iter, void* stream) {
  if (b <= 0 || n <= 0 || (mode != MODE_SANCHO && mode != MODE_DYSON)
      || (scratch == nullptr && n > MAX_SHARED_N))
    return (int)cudaErrorInvalidValue;
  const bool on_chip = scratch == nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(n);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        sancho_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared_bytes(MAX_SHARED_N, SANCHO_BLOCKS, true));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          dyson_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)shared_bytes(MAX_SHARED_N, DYSON_BLOCKS, true));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const double2* a = static_cast<const double2*>(A);
  const double2* bb = static_cast<const double2*>(B);
  double2* g = static_cast<double2*>(G);
  double2* sc = static_cast<double2*>(scratch);
  if (mode == MODE_SANCHO) {
    sancho_kernel<<<b, threads, shared_bytes(n, SANCHO_BLOCKS, on_chip),
                    st>>>(a, bb, g, static_cast<int*>(counts),
                          static_cast<double*>(metrics), sc, n, conv,
                          max_iter);
  } else {
    dyson_kernel<<<b, threads, shared_bytes(n, DYSON_BLOCKS, on_chip), st>>>(
        a, bb, g, static_cast<int*>(counts), static_cast<double*>(metrics),
        sc, n, conv, relax, max_iter);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
