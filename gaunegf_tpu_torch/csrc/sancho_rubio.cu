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
// while loop.
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
// products, then a lane-wide max.  Where that chain runs depends only on
// n, chosen in the C entry point (gaunegf_sancho_rubio_variant):
//   n = 1        SCALAR: one thread a lane, 32 lanes a warp; the whole loop
//                in registers, no shared memory, no barrier.
//   2 <= n <= 16 COLUMN: n threads a lane, one column of each block a
//                thread, floor(32 / n) lanes a warp, one warp a CTA.  The
//                inverse is kernel A's register-resident Gauss-Jordan (the
//                owner of pivot column c finds the pivot row in its own
//                registers, one shuffle spreads it, each thread swaps two
//                of its registers, the pivot column comes by shuffles; the
//                row swaps undone as column swaps only rename the columns,
//                and each thread fetches its column of g by shuffles).  The
//                blocks every thread reads whole (al, be, al g, be g) and
//                the lane's eps, eps_s sit in the warp's shared memory
//                (6 n^2 complex128 a lane), the thread's own columns of al,
//                be in registers; two __syncwarp an iteration, no
//                __syncthreads.  The lane-wide maxima are shuffles within
//                the lane's n threads (a cyclic doubling: max is
//                idempotent, so n need not be a power of two).
//   17 <= n      CTA: the first design, one CTA a lane (up to 256
//                threads, one per entry of the block), the nine live blocks
//                (five of the Dyson map) in shared memory for n <= 32 and
//                in a global scratch the wrapper allocates beyond that --
//                the same code, other addresses.  Every pivot step and
//                product stage is separated by __syncthreads.
// ptxas -v (sm_90a): SCALAR 64 / 44 registers (Sancho / Dyson; 32 bytes of
// spill around the Sancho loop's library calls); COLUMN <9> 130 / 164
// registers, no spills, 7,776 / 3,888 bytes of shared memory a lane
// (Sancho / Dyson); <8> 184 / 168, no spills; <16> 255 with 136 / 4 bytes
// of spill (n = 10..16 is on no path); CTA 80 / 64.  Fused multiply-adds
// and a one-division reciprocal (kernel A's) were tried in the COLUMN
// layout: their other rounding moved an in-band k-space lane of phase 3b to
// 1.2e-10 of the plain version, past its bound, so it keeps this
// arithmetic.
// Lanes that share a warp stop at different iterations: the warp iterates
// while any of its lanes is live, a stopped lane (converged, at max_iter,
// or NaN at once) keeps computing on its frozen state to take part in the
// shuffles but commits nothing, so its state and count stay as the plain
// version freezes them, and its shuffles never leave its own threads.
// Every inverse is Gauss-Jordan with partial pivoting (|re| + |im| as
// LAPACK's izamax, the first row on ties); it differs from the plain
// version's getrf/getri only in rounding.  Magnitudes are compared
// squared where only a maximum is needed.  No host synchronisation and no
// launch per iteration.  Everything is complex128.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_SHARED_N = 32;
constexpr int MAX_COLUMN_N = 16;
constexpr int SANCHO_BLOCKS = 9;
constexpr int DYSON_BLOCKS = 5;
constexpr int COLUMN_SANCHO_BLOCKS = 6;   // eps_s, eps, al, be, al g, be g
constexpr int COLUMN_DYSON_BLOCKS = 3;    // A, B, B g
constexpr int SCALAR_THREADS = 128;
constexpr int MODE_SANCHO = 0, MODE_DYSON = 1;
constexpr int VARIANT_SCALAR = 0, VARIANT_COLUMN = 1, VARIANT_CTA = 2,
              VARIANT_CTA_GLOBAL = 3;
constexpr unsigned FULL = 0xffffffffu;
constexpr double TINY = 1.1754943508222875e-38;   // float32's tiny

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
// |a|^2, for maxima that take one root at the end
__device__ __forceinline__ double cnorm(double2 a) {
  return a.x * a.x + a.y * a.y;
}
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
__device__ __forceinline__ double2 shfl2(double2 v, int src) {
  return make_double2(__shfl_sync(FULL, v.x, src),
                      __shfl_sync(FULL, v.y, src));
}
// the power of two at or above a coupling's largest magnitude m (NaN kept)
__device__ __forceinline__ double balance(double m) {
  const double mm = m != m ? m : fmax(m, TINY);
  return exp2(ceil(log2(mm)));
}

// ---------------------------------------------------------------------------
// SCALAR: n = 1, one thread a lane
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(SCALAR_THREADS)
sancho_scalar_kernel(const double2* __restrict__ A,
                     const double2* __restrict__ B, double2* G, int* counts,
                     double* metrics, int b, double conv, int max_iter) {
  const int ln = blockIdx.x * blockDim.x + threadIdx.x;
  if (ln >= b) return;
  double2 eps_s = A[ln], eps = eps_s, al = B[ln];
  double2 be = make_double2(al.x, -al.y);
  double c = 0.0, diff = INFINITY;
  int it = 0;
  while (it < max_iter && diff > conv) {
    const double2 g = crecip(eps);
    const double2 x = cmul(al, g), y = cmul(be, g);
    const double scale = exp2(c);
    const double2 agb = cscale(cmul(x, be), scale);
    const double2 bga = cscale(cmul(y, al), scale);
    const double2 es_new = csub(eps_s, agb);
    const double2 xa = cmul(x, al), yb = cmul(y, be);
    eps = csub(csub(eps, agb), bga);
    const double d = cabs2(csub(es_new, eps_s)), s = cabs2(es_new);
    eps_s = es_new;
    const double sa = balance(cabs2(xa)), sb = balance(cabs2(yb));
    c = 2.0 * c + log2(sa) + log2(sb);
    al = make_double2(xa.x / sa, xa.y / sa);
    be = make_double2(yb.x / sb, yb.y / sb);
    diff = s != s ? NAN : d / fmax(s, 1e-30);
    ++it;
  }
  G[ln] = crecip(eps_s);
  counts[ln] = it;
  metrics[ln] = diff;
}

__global__ void __launch_bounds__(SCALAR_THREADS)
dyson_scalar_kernel(const double2* __restrict__ A,
                    const double2* __restrict__ B, double2* G, int* counts,
                    double* metrics, int b, double conv, double relax,
                    int max_iter) {
  const int ln = blockIdx.x * blockDim.x + threadIdx.x;
  if (ln >= b) return;
  const double2 a = A[ln], bb = B[ln];
  double2 g = crecip(a);
  double diff = INFINITY;
  int it = 0;
  while (it < max_iter && diff > conv) {
    const double2 gn = crecip(csub(a, cmulc(cmul(bb, g), bb)));
    diff = cabs2(csub(gn, g)) / fmax(cabs2(gn), 1e-12);
    g = cadd(cscale(gn, relax), cscale(g, 1.0 - relax));
    ++it;
  }
  G[ln] = g;
  counts[ln] = it;
  metrics[ln] = diff;
}

// ---------------------------------------------------------------------------
// COLUMN: 2 <= n <= 16, n threads a lane, one column a thread
// ---------------------------------------------------------------------------

// A thread's place: lane group `grp` of the warp (the threads beyond the
// last whole group form a dead group that computes and commits nothing),
// column j, the group's first warp lane `base`.
struct Group {
  int n, j, base, slot;
  size_t ln;
  bool live, spare;   // spare: the dead group beyond the last whole one
};

__device__ __forceinline__ Group group_of(int n, int b) {
  Group g;
  const int per = 32 / n, t = threadIdx.x;
  const int grp = t / n;
  g.n = n;
  g.base = grp * n;
  g.j = t - g.base;
  g.spare = grp >= per;
  g.slot = g.spare ? 0 : grp;           // the spare group reads slot 0
  g.ln = (size_t)blockIdx.x * per + grp;
  g.live = !g.spare && g.ln < (size_t)b;
  return g;
}

// The inverse of the group's n x n block, column j in w: kernel A's
// register-resident Gauss-Jordan for up to NM rows.  piv receives the
// pivot rows; the thread then holds column held_column(piv, ...) of it.
template <int NM>
__device__ __forceinline__ void group_inverse(double2 (&w)[NM], int (&piv)[NM],
                                              const Group& G) {
#pragma unroll
  for (int c = 0; c < NM; ++c) {
    if (c >= G.n) break;
    int p = c;
    double best = fabs(w[c].x) + fabs(w[c].y);
#pragma unroll
    for (int r = c + 1; r < NM; ++r) {
      if (r >= G.n) break;
      const double m = fabs(w[r].x) + fabs(w[r].y);
      if (m > best) {
        best = m;
        p = r;
      }
    }
    p = __shfl_sync(FULL, p, G.base + c);
    piv[c] = p;
    double2 vp = w[c];
#pragma unroll
    for (int r = c + 1; r < NM; ++r)
      if (r == p) vp = w[r];
#pragma unroll
    for (int r = c + 1; r < NM; ++r)
      if (r == p) w[r] = w[c];
    w[c] = vp;
    const double2 inv = crecip(shfl2(w[c], G.base + c));
    const bool own = G.j == c;
    const double2 wc = cmul(own ? make_double2(1.0, 0.0) : w[c], inv);
#pragma unroll
    for (int r = 0; r < NM; ++r) {
      if (r >= G.n) break;
      if (r == c) continue;
      const double2 f = shfl2(w[r], G.base + c);
      w[r] = csub(own ? make_double2(0.0, 0.0) : w[r], cmul(f, wc));
    }
    w[c] = wc;
  }
}

// The thread whose registers hold column j of the inverse: the column
// swaps (c, piv[c]), undone in reverse order, applied to j forwards.
template <int NM>
__device__ __forceinline__ int column_source(const int (&piv)[NM], int n,
                                             int j) {
  int q = j;
#pragma unroll
  for (int c = 0; c < NM; ++c) {
    if (c >= n) break;
    if (q == c) q = piv[c];
    else if (q == piv[c]) q = c;
  }
  return q;
}

// inv(M) for the group, M's column j in w; returns column j of the inverse
// in w (by shuffles from the thread that holds it).
template <int NM>
__device__ __forceinline__ void group_inverse_column(double2 (&w)[NM],
                                                     const Group& G) {
  int piv[NM];
  group_inverse<NM>(w, piv, G);
  const int src = G.base + column_source<NM>(piv, G.n, G.j);
#pragma unroll
  for (int r = 0; r < NM; ++r)          // each shuffle reads before it writes
    if (r < G.n) w[r] = shfl2(w[r], src);
}

// max over the group's n threads (every thread gets it): after the step
// with stride s each thread holds the max of the 2s columns from its own
// on, cyclically; max is idempotent, so the overlap does no harm.
__device__ __forceinline__ double group_max(double v, const Group& G) {
  for (int s = 1; s < G.n; s <<= 1) {
    int src = G.j + s;
    if (src >= G.n) src -= G.n;
    v = nanmax(v, __shfl_sync(FULL, v, G.base + src));
  }
  return v;
}

template <int NM>
__global__ void __launch_bounds__(32)
sancho_column_kernel(const double2* __restrict__ A,
                     const double2* __restrict__ B, double2* Gout,
                     int* counts, double* metrics, int b, int n_arg,
                     double conv, int max_iter) {
  extern __shared__ double2 smem[];
  const int n = NM == 9 ? 9 : n_arg;
  const Group G = group_of(n, b);
  const int nn = n * n, j = G.j;
  double2* eps_s = smem + (size_t)G.slot * COLUMN_SANCHO_BLOCKS * nn;
  double2* eps = eps_s + nn;
  double2* al = eps + nn;
  double2* be = al + nn;
  double2* X = be + nn;
  double2* Y = X + nn;
  if (G.live) {
    const double2* Al = A + G.ln * nn;
    const double2* Bl = B + G.ln * nn;
    for (int r = 0; r < n; ++r) {
      eps_s[r * n + j] = eps[r * n + j] = Al[r * n + j];
      al[r * n + j] = Bl[r * n + j];
      const double2 t = Bl[j * n + r];
      be[r * n + j] = make_double2(t.x, -t.y);
    }
  }
  __syncwarp();
  double c = 0.0, diff = INFINITY;
  int it = 0;
  for (;;) {
    const bool act = G.live && it < max_iter && diff > conv;
    if (!__any_sync(FULL, act)) break;
    double2 w[NM];
#pragma unroll
    for (int r = 0; r < NM; ++r)
      if (r < n) w[r] = eps[r * n + j];
    group_inverse_column<NM>(w, G);           // column j of g = inv(eps)
    // column j of al g and be g
    for (int i = 0; i < n; ++i) {
      double2 x = make_double2(0.0, 0.0), y = x;
#pragma unroll
      for (int l = 0; l < NM; ++l) {
        if (l >= n) break;
        x = cadd(x, cmul(al[i * n + l], w[l]));
        y = cadd(y, cmul(be[i * n + l], w[l]));
      }
      if (!G.spare) {
        X[i * n + j] = x;
        Y[i * n + j] = y;
      }
    }
    __syncwarp();
    double2 a[NM], bc[NM];                    // own columns of al, be
#pragma unroll
    for (int l = 0; l < NM; ++l)
      if (l < n) {
        a[l] = al[l * n + j];
        bc[l] = be[l * n + j];
      }
    const double scale = exp2(c);
    double v0 = 0.0, v1 = 0.0, v2 = 0.0, v3 = 0.0;
    for (int i = 0; i < n; ++i) {
      double2 xb = make_double2(0.0, 0.0), ya = xb, xa = xb, yb = xb;
#pragma unroll
      for (int l = 0; l < NM; ++l) {
        if (l >= n) break;
        const double2 x = X[i * n + l], y = Y[i * n + l];
        xb = cadd(xb, cmul(x, bc[l]));
        ya = cadd(ya, cmul(y, a[l]));
        xa = cadd(xa, cmul(x, a[l]));
        yb = cadd(yb, cmul(y, bc[l]));
      }
      const double2 agb = cscale(xb, scale), bga = cscale(ya, scale);
      const double2 es = eps_s[i * n + j];
      const double2 es_new = csub(es, agb);
      v0 = nanmax(v0, cnorm(csub(es_new, es)));
      v1 = nanmax(v1, cnorm(es_new));
      v2 = nanmax(v2, cnorm(xa));
      v3 = nanmax(v3, cnorm(yb));
      if (act) {
        eps[i * n + j] = csub(csub(eps[i * n + j], agb), bga);
        eps_s[i * n + j] = es_new;
        al[i * n + j] = xa;                   // own column: read above
        be[i * n + j] = yb;
      }
    }
    v0 = group_max(v0, G);
    v1 = group_max(v1, G);
    v2 = group_max(v2, G);
    v3 = group_max(v3, G);
    if (act) {
      const double sa = balance(sqrt(v2)), sb = balance(sqrt(v3));
      c = 2.0 * c + log2(sa) + log2(sb);
      for (int i = 0; i < n; ++i) {
        const double2 x = al[i * n + j], y = be[i * n + j];
        al[i * n + j] = make_double2(x.x / sa, x.y / sa);
        be[i * n + j] = make_double2(y.x / sb, y.y / sb);
      }
      const double s = sqrt(v1);
      diff = s != s ? NAN : sqrt(v0) / fmax(s, 1e-30);
      ++it;
    }
    __syncwarp();                             // al, be whole again
  }
  double2 w[NM];
#pragma unroll
  for (int r = 0; r < NM; ++r)
    if (r < n) w[r] = eps_s[r * n + j];
  group_inverse_column<NM>(w, G);
  if (G.live) {
#pragma unroll
    for (int r = 0; r < NM; ++r)
      if (r < n) Gout[G.ln * nn + r * n + j] = w[r];
    if (j == 0) {
      counts[G.ln] = it;
      metrics[G.ln] = diff;
    }
  }
}

template <int NM>
__global__ void __launch_bounds__(32)
dyson_column_kernel(const double2* __restrict__ A,
                    const double2* __restrict__ B, double2* Gout,
                    int* counts, double* metrics, int b, int n_arg,
                    double conv, double relax, int max_iter) {
  extern __shared__ double2 smem[];
  const int n = NM == 9 ? 9 : n_arg;
  const Group G = group_of(n, b);
  const int nn = n * n, j = G.j;
  double2* a = smem + (size_t)G.slot * COLUMN_DYSON_BLOCKS * nn;
  double2* bb = a + nn;
  double2* T = bb + nn;
  if (G.live) {
    for (int r = 0; r < n; ++r) {
      a[r * n + j] = A[G.ln * nn + r * n + j];
      bb[r * n + j] = B[G.ln * nn + r * n + j];
    }
  }
  __syncwarp();
  double2 g[NM];
#pragma unroll
  for (int r = 0; r < NM; ++r)
    if (r < n) g[r] = a[r * n + j];
  group_inverse_column<NM>(g, G);             // g0 = inv(A), column j
  double diff = INFINITY;
  int it = 0;
  for (;;) {
    const bool act = G.live && it < max_iter && diff > conv;
    if (!__any_sync(FULL, act)) break;
    for (int i = 0; i < n; ++i) {             // column j of B g
      double2 t = make_double2(0.0, 0.0);
#pragma unroll
      for (int l = 0; l < NM; ++l) {
        if (l >= n) break;
        t = cadd(t, cmul(bb[i * n + l], g[l]));
      }
      if (!G.spare) T[i * n + j] = t;
    }
    __syncwarp();
    double2 w[NM];                            // column j of A - (B g) B^+
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      if (i >= n) break;
      double2 t = make_double2(0.0, 0.0);
#pragma unroll
      for (int l = 0; l < NM; ++l) {
        if (l >= n) break;
        t = cadd(t, cmulc(T[i * n + l], bb[j * n + l]));
      }
      w[i] = csub(a[i * n + j], t);
    }
    __syncwarp();                             // T read before it is rewritten
    group_inverse_column<NM>(w, G);
    double v = 0.0;
#pragma unroll
    for (int r = 0; r < NM; ++r)
      if (r < n)
        v = nanmax(v, cnorm(csub(w[r], g[r])) / fmax(cnorm(w[r]), 1e-24));
    v = group_max(v, G);
    if (act) {
#pragma unroll
      for (int r = 0; r < NM; ++r)
        if (r < n)
          g[r] = cadd(cscale(w[r], relax), cscale(g[r], 1.0 - relax));
      diff = sqrt(v);
      ++it;
    }
  }
  if (G.live) {
#pragma unroll
    for (int r = 0; r < NM; ++r)
      if (r < n) Gout[G.ln * nn + r * n + j] = g[r];
    if (j == 0) {
      counts[G.ln] = it;
      metrics[G.ln] = diff;
    }
  }
}

// ---------------------------------------------------------------------------
// CTA: n >= 17, one CTA a lane (the first design)
// ---------------------------------------------------------------------------

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

// Which layout serves blocks of n x n: 0 SCALAR (n = 1), 1 COLUMN
// (2 <= n <= 16), 2 CTA with the blocks in shared memory (17 <= n <= 32),
// 3 CTA with the blocks in a global scratch (n > 32); -1 for n < 1.
int gaunegf_sancho_rubio_variant(int n) {
  if (n < 1) return -1;
  if (n == 1) return VARIANT_SCALAR;
  if (n <= MAX_COLUMN_N) return VARIANT_COLUMN;
  return n <= MAX_SHARED_N ? VARIANT_CTA : VARIANT_CTA_GLOBAL;
}

// One launch.  A, B (b, n, n) complex128 in, contiguous; G (b, n, n) out;
// counts (b,) int32 and metrics (b,) float64 receive each lane's
// iterations and last metric.  mode 0: Sancho-Rubio (max_iter iterations
// at most, relax unused); mode 1: the relaxed Dyson map.  scratch: a
// device buffer of b * (9 or 5) * n * n complex128 for variant 3 (n > 32),
// null otherwise.  Returns the CUDA error of the launch (0 on success).
int gaunegf_sancho_rubio_c128(const void* A, const void* B, void* G,
                              void* counts, void* metrics, void* scratch,
                              int b, int n, int mode, double conv,
                              double relax, int max_iter, void* stream) {
  const int variant = gaunegf_sancho_rubio_variant(n);
  if (b <= 0 || variant < 0 || (mode != MODE_SANCHO && mode != MODE_DYSON)
      || (scratch == nullptr) != (variant != VARIANT_CTA_GLOBAL))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double2* a = static_cast<const double2*>(A);
  const double2* bb = static_cast<const double2*>(B);
  double2* g = static_cast<double2*>(G);
  int* cnt = static_cast<int*>(counts);
  double* met = static_cast<double*>(metrics);
  const bool sancho = mode == MODE_SANCHO;
  if (variant == VARIANT_SCALAR) {
    const int ctas = (b + SCALAR_THREADS - 1) / SCALAR_THREADS;
    if (sancho)
      sancho_scalar_kernel<<<ctas, SCALAR_THREADS, 0, st>>>(
          a, bb, g, cnt, met, b, conv, max_iter);
    else
      dyson_scalar_kernel<<<ctas, SCALAR_THREADS, 0, st>>>(
          a, bb, g, cnt, met, b, conv, relax, max_iter);
    return (int)cudaGetLastError();
  }
  if (variant == VARIANT_COLUMN) {
    const int per = 32 / n, ctas = (b + per - 1) / per;
    const size_t smem = sizeof(double2) * per * n * n
        * (sancho ? COLUMN_SANCHO_BLOCKS : COLUMN_DYSON_BLOCKS);
    // register arrays of 8, 9 or 16 rows: n = 9 (the k-space lanes) has
    // its own copy with every loop bound known
    if (n <= 8) {
      if (sancho)
        sancho_column_kernel<8><<<ctas, 32, smem, st>>>(
            a, bb, g, cnt, met, b, n, conv, max_iter);
      else
        dyson_column_kernel<8><<<ctas, 32, smem, st>>>(
            a, bb, g, cnt, met, b, n, conv, relax, max_iter);
    } else if (n == 9) {
      if (sancho)
        sancho_column_kernel<9><<<ctas, 32, smem, st>>>(
            a, bb, g, cnt, met, b, n, conv, max_iter);
      else
        dyson_column_kernel<9><<<ctas, 32, smem, st>>>(
            a, bb, g, cnt, met, b, n, conv, relax, max_iter);
    } else {
      if (sancho)
        sancho_column_kernel<16><<<ctas, 32, smem, st>>>(
            a, bb, g, cnt, met, b, n, conv, max_iter);
      else
        dyson_column_kernel<16><<<ctas, 32, smem, st>>>(
            a, bb, g, cnt, met, b, n, conv, relax, max_iter);
    }
    return (int)cudaGetLastError();
  }
  const bool on_chip = variant == VARIANT_CTA;
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
  double2* sc = static_cast<double2*>(scratch);
  if (sancho) {
    sancho_kernel<<<b, threads, shared_bytes(n, SANCHO_BLOCKS, on_chip),
                    st>>>(a, bb, g, cnt, met, sc, n, conv, max_iter);
  } else {
    dyson_kernel<<<b, threads, shared_bytes(n, DYSON_BLOCKS, on_chip), st>>>(
        a, bb, g, cnt, met, sc, n, conv, relax, max_iter);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
