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
//                product stage is separated by __syncthreads.  Beyond 32
//                it serves the Dyson map, and the Sancho mode only past
//                MAX_CLUSTER_N.
//   Sancho, CLUSTER_N0 <= n <= MAX_CLUSTER_N
//                CLUSTER: one lane over a thread-block cluster of C CTAs
//                of 256 threads, one CTA an SM (C the widest <= 8 of which
//                the card holds all b lanes at once: cluster_width; an
//                H100 holds 132, 66, 39, 30, 22, 17, 15, 15 clusters of
//                1..8), its blocks padded to NP = n rounded up to
//                a multiple of 8 in a global scratch.  It replaces the
//                Sancho half of CTA at n > 32, whose one CTA a lane filled
//                at most 64 of 132 SMs at the chain leads' 64-lane
//                launches, read both operands of six products an element
//                at a time from global memory and swept the whole block
//                through global memory behind four barriers at each of n
//                pivot steps, all on the CUDA cores (n = 150: 1.54% of its
//                FP64 bound at 128 lanes, 407.5 ms; cuBLAS / cuSOLVER
//                batched 105.4 ms).
//                What bounds it: 7 x 8 n^3 FP64 operations an iteration
//                (the inverse and six products) and one more inverse a
//                lane: at n = 150, 64 lanes and 19-20 iterations 3.5 ms at
//                67 TFLOP/s; the nine NP x NP blocks a lane (3.3 MB) exceed
//                the 50 MB L2 at 16 lanes, and the products' operand
//                re-reads at 16 x 64 tiles (B once per 16 output rows) put
//                a floor of the same order, ~3 ms a 64-lane launch, on HBM.
//                What the design does about it: every product on the FP64
//                tensor cores (mma.sync m8n8k4, four real products a
//                complex one, no 3M trick), operands staged in shared
//                memory by cp.async in two stages of depth 8; the six
//                products as two, [X; Y] = [al; be] g and
//                [X; Y] [al | be], the second's epilogue fused with the
//                updates of eps_s and eps, the copy of eps for the next
//                inverse, the four maxima and the unscaled new al, be (the
//                next iteration applies the power-of-two rebalancing as
//                it loads them: the same values, exactly); each CTA owns
//                a slice of the output rows.  The inverse is blocked
//                Gauss-Jordan with the same pivot rule: panels of 16
//                columns (8 beyond NP = 160) factored in one CTA's shared
//                memory, each panel applied to every other column by its
//                owner as a tensor-core product in k-steps of 4; the owner
//                of the next panel updates and factors it while the others
//                update theirs, so one cluster barrier a panel.  The
//                lane-wide maxima cross the cluster through distributed
//                shared memory.  Measured at n = 150 (H100, 700 W): 31.1-
//                31.6 ms a 64-lane launch (11.0-11.1% of the bound; plain
//                68.1-77.5), 56.7-56.9 ms at 128 lanes (12.2%; plain 94.2-
//                121.3), 16.9-17.0 ms at 22, 14.9 ms for one lane; ahead of CTA from n = 33 on (2.03 against
//                2.12-2.20 ms at 37 lanes; 40: 1.97 / 3.0; 64: 3.7 /
//                11.1), hence CLUSTER_N0 = 33.  Two CTAs an SM (128
//                registers, 1,916 bytes of spill stores) with C the widest
//                with b C <= 132 took 38.3 ms at 64 lanes and 22.1 at 22.
//                ptxas -v: 245 registers, no spills, 72 bytes of stack;
//                106,432 bytes of dynamic shared memory at n = 150 (at
//                most 111,744).
// ptxas -v (sm_90a), the other layouts: SCALAR 64 / 44 registers (Sancho /
// Dyson; 32 bytes of spill around the Sancho loop's library calls); COLUMN
// <9> 130 / 164 registers, no spills, 7,776 / 3,888 bytes of shared memory
// a lane (Sancho / Dyson); <8> 184 / 168, no spills; <16> 255 with 136 / 4 bytes
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace cg = cooperative_groups;

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
              VARIANT_CTA_GLOBAL = 3, VARIANT_CLUSTER = 4;
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

// ---------------------------------------------------------------------------
// CLUSTER: the Sancho mode at n >= CLUSTER_N0, one lane over a cluster
// ---------------------------------------------------------------------------

constexpr int CL_THREADS = 256, CL_WARPS = 8;
constexpr int CLUSTER_N0 = 33;        // measured on the card: the top note
constexpr int MAX_CLUSTER_N = 256;    // the panels' shared memory
constexpr int MAX_CLUSTER = 8;        // the portable cluster size
constexpr int TI = 16, TJ = 64, TK = 8;   // product tile: rows, columns, depth
constexpr int KS = TK + 4;            // row stride of a staged fragment row
constexpr int STAGE_ELEMS = 2 * (2 * TI * KS + 2 * TJ * KS);
constexpr int MAX_TILES = 5;          // update tiles a warp holds at once
constexpr int MAX_PANEL = 16;

__host__ __device__ inline int padded(int n) { return (n + 7) & ~7; }
// columns of a panel of the inverse: the panel and the factored panel sit in
// shared memory, NP x (pw + 4) each
__host__ __device__ inline int panel_width(int np) {
  return np <= 160 ? 16 : 8;
}
__host__ __device__ inline int union_elems(int np) {
  const int pw = panel_width(np), st = pw + 4;
  const int inv = 2 * np * st + pw * st;
  return inv > STAGE_ELEMS ? inv : STAGE_ELEMS;
}
size_t cluster_smem_bytes(int np) {
  return sizeof(double2) * ((size_t)union_elems(np) + np)
         + sizeof(double) * (CL_WARPS * 4 + 8)
         + sizeof(int) * (2 * (size_t)np + MAX_PANEL);
}
// complex128 elements of a lane's scratch: nine NP x NP blocks and the
// pivot rows (NP int32)
__host__ __device__ inline size_t lane_elems(int np) {
  return 9 * (size_t)np * np + np / 4;
}

// --- the cluster layout's device primitives ---
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void lane_sync(int C) {
  if (C > 1) cg::this_cluster().sync();
  else __syncthreads();
}
__device__ __forceinline__ const double* rank_shared(const double* p, int r) {
  return cg::this_cluster().map_shared_rank(p, r);
}
// --- end of the device primitives ---

// re + i im (an 8 x 8 fragment each) += a b: four real products on the
// FP64 tensor cores, no 3M trick
__device__ __forceinline__ void zmma(double (&re)[2], double (&im)[2],
                                     double2 a, double2 b) {
  dmma(re, a.x, b.x);
  dmma(re, -a.y, b.y);
  dmma(im, a.x, b.y);
  dmma(im, a.y, b.x);
}

// A lane's blocks, NP x NP complex128 row-major, n x n in the top left: eps
// and eps_s (identity in the padding), W (the inverse in place), al and be
// in two copies each (read one, write the other; zero padding), and the
// stacked X = al g, Y = be g.
struct LaneState {
  double2 *es, *ep, *w, *al[2], *be[2], *xy;
  int* piv;
};

__device__ LaneState lane_state(double2* scratch, size_t ln, int np) {
  const size_t nn = (size_t)np * np;
  double2* base = scratch + ln * lane_elems(np);
  LaneState s;
  s.es = base;
  s.ep = base + nn;
  s.w = base + 2 * nn;
  s.al[0] = base + 3 * nn;
  s.al[1] = base + 4 * nn;
  s.be[0] = base + 5 * nn;
  s.be[1] = base + 6 * nn;
  s.xy = base + 7 * nn;
  s.piv = reinterpret_cast<int*>(base + 9 * nn);
  return s;
}

// A CTA's shared memory: the products' two stages, or (at other times) the
// inverse's panel, factored panel and permuted rows; then small arrays.
struct ClusterSmem {
  double2 *stage, *pn, *qs, *pwt, *f;
  double *red, *lanemax;
  int *rowmap, *src, *pivs;
};

__device__ ClusterSmem carve_cluster(void* at, int np) {
  const int st = panel_width(np) + 4;
  double2* d = static_cast<double2*>(at);
  ClusterSmem s;
  s.stage = d;
  s.pn = d;
  s.qs = d + (size_t)np * st;
  s.pwt = d + 2 * (size_t)np * st;
  s.f = d + union_elems(np);
  s.red = reinterpret_cast<double*>(s.f + np);
  s.lanemax = s.red + CL_WARPS * 4;
  s.rowmap = reinterpret_cast<int*>(s.lanemax + 8);
  s.src = s.rowmap + np;
  s.pivs = s.src + np;
  return s;
}

struct Ctx {
  int n, np, pw, C, rank, r0, r1, tid, warp, lane;
};

// Gauss-Jordan on the panel W[:, k .. k + w) in shared memory (one CTA):
// the pivot row by |re| + |im| among rows >= k + c (the first on ties), the
// swap, the pivot row scaled, every other row eliminated -- the unblocked
// inverse's steps restricted to the panel's columns.  Writes the factored
// panel back to W and its pivot rows to piv.
__device__ void factor_panel(const LaneState& L, const ClusterSmem& S,
                             const Ctx& x, int k, int w) {
  const int np = x.np, st = x.pw + 4;
  double2* P = S.pn;
  __syncthreads();                      // this CTA's writes to W[:, k ..)
  for (int e = x.tid; e < np * w; e += CL_THREADS) {
    const int r = e / w, j = e - r * w;
    P[r * st + j] = __ldcg(L.w + (size_t)r * np + k + j);
  }
  __syncthreads();
  for (int c = 0; c < w; ++c) {
    const int g = k + c;
    if (x.warp == 0) {
      double mag = -1.0;
      int row = np;
      for (int r = g + x.lane; r < np; r += 32) {
        const double2 v = P[r * st + c];
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
      if (x.lane == 0) S.pivs[c] = row < np ? row : g;
    }
    __syncthreads();
    const int p = S.pivs[c];
    if (p != g) {                       // CTA-uniform
      for (int j = x.tid; j < w; j += CL_THREADS) {
        const double2 t = P[g * st + j];
        P[g * st + j] = P[p * st + j];
        P[p * st + j] = t;
      }
      __syncthreads();
    }
    const double2 inv = crecip(P[g * st + c]);
    for (int r = x.tid; r < np; r += CL_THREADS) S.f[r] = P[r * st + c];
    __syncthreads();
    for (int j = x.tid; j < w; j += CL_THREADS)
      P[g * st + j] = cmul(j == c ? make_double2(1.0, 0.0) : P[g * st + j],
                           inv);
    __syncthreads();
    for (int e = x.tid; e < np * w; e += CL_THREADS) {
      const int r = e / w, j = e - r * w;
      if (r != g) {
        const double2 v = j == c ? make_double2(0.0, 0.0) : P[r * st + j];
        P[r * st + j] = csub(v, cmul(S.f[r], P[g * st + j]));
      }
    }
    __syncthreads();
  }
  for (int e = x.tid; e < np * w; e += CL_THREADS) {
    const int r = e / w, j = e - r * w;
    __stcg(L.w + (size_t)r * np + k + j, P[r * st + j]);
  }
  for (int c = x.tid; c < w; c += CL_THREADS) __stcg(L.piv + k + c, S.pivs[c]);
}

// The factored panel Q = W[:, kt .. kt + wt) (in S.qs, its row swaps in
// S.rowmap: row r of the swapped W is row rowmap[r]) applied to the columns
// [cs, cs + ws) of W: W[r, j] = (r in the panel ? 0 : W[rowmap[r], j])
// + sum_c Q[r, c] W[rowmap[kt + c], j], the sum on the tensor cores in
// k-steps of 4.  Every read of the block precedes every write.
__device__ void update_block(const LaneState& L, const ClusterSmem& S,
                             const Ctx& x, int kt, int wt, int cs, int ws) {
  const int np = x.np, st = x.pw + 4;
  for (int e = x.tid; e < ws * wt; e += CL_THREADS) {
    const int jj = e / wt, c = e - jj * wt;
    S.pwt[jj * st + c] =
        __ldcg(L.w + (size_t)S.rowmap[kt + c] * np + cs + jj);
  }
  __syncthreads();
  const int nj = ws >> 3, tiles = (np >> 3) * nj;
  const int qr = x.lane >> 2, qc = x.lane & 3;
  double2 out[MAX_TILES][2];
#pragma unroll
  for (int m = 0; m < MAX_TILES; ++m) {
    const int q = x.warp + CL_WARPS * m;
    if (q < tiles) {                    // warp-uniform
      const int ib = q / nj, jb = q - ib * nj;
      const int i = ib * 8 + qr, j = cs + jb * 8 + 2 * qc;
      const bool in_panel = i >= kt && i < kt + wt;
      double re[2], im[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const double2 b = in_panel ? make_double2(0.0, 0.0)
            : __ldcg(L.w + (size_t)S.rowmap[i] * np + j + h);
        re[h] = b.x;
        im[h] = b.y;
      }
      for (int k0 = 0; k0 < wt; k0 += 4)
        zmma(re, im, S.qs[(ib * 8 + qr) * st + k0 + qc],
             S.pwt[(jb * 8 + qr) * st + k0 + qc]);
      out[m][0] = make_double2(re[0], im[0]);
      out[m][1] = make_double2(re[1], im[1]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MAX_TILES; ++m) {
    const int q = x.warp + CL_WARPS * m;
    if (q < tiles) {
      const int ib = q / nj, jb = q - ib * nj;
      const int i = ib * 8 + qr, j = cs + jb * 8 + 2 * qc;
      __stcg(L.w + (size_t)i * np + j, out[m][0]);
      __stcg(L.w + (size_t)i * np + j + 1, out[m][1]);
    }
  }
}

// The blocked inverse of W in place over the cluster: panels of pw columns,
// panel t factored by CTA owner(t) = t C / T, which owns those columns and
// updates them; every CTA applies each factored panel to the columns it
// owns.  The owner of panel t + 1 updates it first and factors it while the
// others update theirs: one cluster barrier a panel.  W ends holding the
// inverse with its columns renamed by the pivots (column_source).
__device__ void cluster_inverse(const LaneState& L, const ClusterSmem& S,
                                const Ctx& x) {
  const int np = x.np, pw = x.pw, st = pw + 4;
  const int T = (np + pw - 1) / pw;
  auto owner = [&](int t) { return t * x.C / T; };
  auto width = [&](int t) { return min(pw, np - t * pw); };
  if (x.rank == owner(0)) factor_panel(L, S, x, 0, width(0));
  lane_sync(x.C);
  for (int t = 0; t < T; ++t) {
    const int kt = t * pw, wt = width(t);
    for (int e = x.tid; e < np * wt; e += CL_THREADS) {
      const int r = e / wt, c = e - r * wt;
      S.qs[r * st + c] = __ldcg(L.w + (size_t)r * np + kt + c);
    }
    for (int r = x.tid; r < np; r += CL_THREADS) S.rowmap[r] = r;
    __syncthreads();
    if (x.tid == 0) {
      for (int c = 0; c < wt; ++c) {
        const int p = __ldcg(L.piv + kt + c), a = S.rowmap[kt + c];
        S.rowmap[kt + c] = S.rowmap[p];
        S.rowmap[p] = a;
      }
    }
    __syncthreads();
    if (t + 1 < T && owner(t + 1) == x.rank) {
      update_block(L, S, x, kt, wt, kt + pw, width(t + 1));
      factor_panel(L, S, x, kt + pw, width(t + 1));
    }
    for (int s = 0; s < T; ++s)
      if (owner(s) == x.rank && s != t && s != t + 1)
        update_block(L, S, x, kt, wt, s * pw, width(s));
    lane_sync(x.C);
  }
}

// S.src[j]: the column of W that holds column j of the inverse (the column
// swaps (c, piv[c]) undone in reverse order, applied to j forwards)
__device__ void column_sources(const LaneState& L, const ClusterSmem& S,
                               const Ctx& x) {
  for (int c = x.tid; c < x.np; c += CL_THREADS)
    S.rowmap[c] = __ldcg(L.piv + c);
  __syncthreads();
  for (int j = x.tid; j < x.np; j += CL_THREADS) {
    int q = j;
    for (int c = 0; c < x.np; ++c) {
      const int p = S.rowmap[c];
      if (q == c) q = p;
      else if (q == p) q = c;
    }
    S.src[j] = q;
  }
  __syncthreads();
}

// The CTA's rows [r0, r1) of the two products of an iteration, tiles of TI
// rows x TJ columns, the depth staged TK at a time in two stages by
// cp.async, each warp eight columns of the tile and both of its row blocks:
//   first:  [X; Y] = [al; be] g           (g = W's columns by S.src)
//   second: [xa xb; ya yb] = [X; Y] [al | be], fused with the update of
//           eps_s and eps (scaled by 2^c), the copy of eps into W for the
//           next inverse, the new al, be (unscaled: the next iteration
//           scales them as it loads them) and the four maxima (squared).
// al and be are read scaled by ra = 1 / sa, rb = 1 / sb (powers of two).
template <bool SECOND>
__device__ void lane_products(const LaneState& L, const ClusterSmem& S,
                              const Ctx& x, int cur, double ra, double rb,
                              double scale, double (&v)[4]) {
  constexpr int NB = SECOND ? 2 : 1;
  constexpr int A_ELEMS = 2 * TI * KS, B_ELEMS = 2 * TJ * KS;
  const int np = x.np, n = x.n;
  const size_t nn = (size_t)np * np;
  const double2* A0 = SECOND ? L.xy : L.al[cur];
  const double2* A1 = SECOND ? L.xy + nn : L.be[cur];
  const double2* B0 = SECOND ? L.al[cur] : L.w;
  const double2* B1 = L.be[cur];
  const double sa0 = SECOND ? 1.0 : ra, sa1 = SECOND ? 1.0 : rb;
  const double sb0 = SECOND ? ra : 1.0, sb1 = rb;
  double2* sA = S.stage;
  double2* sB = S.stage + 2 * A_ELEMS;
  const int qr = x.lane >> 2, qc = x.lane & 3;
  const int nk = np / TK;
  for (int i0 = x.r0; i0 < x.r1; i0 += TI) {
    const int ti = min(TI, x.r1 - i0);
    for (int j0 = 0; j0 < np; j0 += TJ) {
      const int tj = min(TJ, np - j0);
      auto stage_load = [&](int kc, int buf) {
        const int k0 = kc * TK;
        for (int e = x.tid; e < 2 * ti * TK; e += CL_THREADS) {
          const int h = e / (ti * TK), rem = e - h * ti * TK;
          const int r = rem / TK, k = rem - r * TK;
          cp_async16(sA + buf * A_ELEMS + (h * TI + r) * KS + k,
                     (h ? A1 : A0) + (size_t)(i0 + r) * np + k0 + k);
        }
        for (int e = x.tid; e < NB * tj * TK; e += CL_THREADS) {
          const int h = e / (tj * TK), rem = e - h * tj * TK;
          const int k = rem / tj, j = rem - k * tj;
          const int col = SECOND ? j0 + j : S.src[j0 + j];
          cp_async16(sB + buf * B_ELEMS + (h * TJ + j) * KS + k,
                     (h ? B1 : B0) + (size_t)(k0 + k) * np + col);
        }
        cp_async_commit();
      };
      // [row block][A operand][B operand] -> re, im
      double acc[2][2][NB][2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int hb = 0; hb < NB; ++hb)
#pragma unroll
            for (int p = 0; p < 2; ++p)
              acc[a][h][hb][p][0] = acc[a][h][hb][p][1] = 0.0;
      const bool mine = x.warp * 8 < tj;          // warp-uniform
      stage_load(0, 0);
      for (int kc = 0; kc < nk; ++kc) {
        if (kc + 1 < nk) {
          stage_load(kc + 1, (kc + 1) & 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const double2* a_st = sA + (kc & 1) * A_ELEMS;
        const double2* b_st = sB + (kc & 1) * B_ELEMS;
        if (mine) {
#pragma unroll
          for (int ks = 0; ks < TK; ks += 4) {
            double2 bf[NB];
#pragma unroll
            for (int hb = 0; hb < NB; ++hb)
              bf[hb] = cscale(b_st[(hb * TJ + x.warp * 8 + qr) * KS + ks + qc],
                              hb ? sb1 : sb0);
#pragma unroll
            for (int ib = 0; ib < 2; ++ib) {
              if (ib * 8 < ti) {                  // warp-uniform
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const double2 af = cscale(
                      a_st[(h * TI + ib * 8 + qr) * KS + ks + qc],
                      h ? sa1 : sa0);
#pragma unroll
                  for (int hb = 0; hb < NB; ++hb)
                    zmma(acc[ib][h][hb][0], acc[ib][h][hb][1], af, bf[hb]);
                }
              }
            }
          }
        }
        __syncthreads();
      }
      if (!mine) continue;
#pragma unroll
      for (int ib = 0; ib < 2; ++ib) {
        if (ib * 8 >= ti) continue;
        const int i = i0 + ib * 8 + qr;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = j0 + x.warp * 8 + 2 * qc + hh;
          const size_t e = (size_t)i * np + j;
          if (!SECOND) {
            __stcg(L.xy + e, make_double2(acc[ib][0][0][0][hh],
                                          acc[ib][0][0][1][hh]));
            __stcg(L.xy + nn + e, make_double2(acc[ib][1][0][0][hh],
                                               acc[ib][1][0][1][hh]));
            continue;
          }
          const int hb1 = NB - 1;               // be (the second B operand)
          const double2 xa = make_double2(acc[ib][0][0][0][hh],
                                          acc[ib][0][0][1][hh]);
          const double2 xb = make_double2(acc[ib][0][hb1][0][hh],
                                          acc[ib][0][hb1][1][hh]);
          const double2 ya = make_double2(acc[ib][1][0][0][hh],
                                          acc[ib][1][0][1][hh]);
          const double2 yb = make_double2(acc[ib][1][hb1][0][hh],
                                          acc[ib][1][hb1][1][hh]);
          const double2 agb = cscale(xb, scale), bga = cscale(ya, scale);
          const double2 es = L.es[e];
          const double2 es_new = csub(es, agb);
          const double2 ep = csub(csub(L.ep[e], agb), bga);
          L.es[e] = es_new;
          L.ep[e] = ep;
          __stcg(L.w + e, ep);
          __stcg(L.al[cur ^ 1] + e, xa);
          __stcg(L.be[cur ^ 1] + e, yb);
          if (i < n && j < n) {
            v[0] = nanmax(v[0], cnorm(csub(es_new, es)));
            v[1] = nanmax(v[1], cnorm(es_new));
            v[2] = nanmax(v[2], cnorm(xa));
            v[3] = nanmax(v[3], cnorm(yb));
          }
        }
      }
    }
  }
}

// The lane's four maxima: warps, the CTA, then every CTA of the cluster
// reads each CTA's (by distributed shared memory) in rank order.
__device__ void cluster_max(const ClusterSmem& S, const Ctx& x,
                            double (&v)[4], int par) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[q] = nanmax(v[q], __shfl_xor_sync(FULL, v[q], off));
    if (x.lane == 0) S.red[x.warp * 4 + q] = v[q];
  }
  __syncthreads();
  if (x.tid < 4) {
    double m = 0.0;
    for (int w = 0; w < CL_WARPS; ++w) m = nanmax(m, S.red[w * 4 + x.tid]);
    S.lanemax[par * 4 + x.tid] = m;
  }
  lane_sync(x.C);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    double m = 0.0;
    for (int r = 0; r < x.C; ++r)
      m = nanmax(m, (x.C > 1 ? rank_shared(S.lanemax, r)
                             : S.lanemax)[par * 4 + q]);
    v[q] = m;
  }
}

__global__ void __launch_bounds__(CL_THREADS, 1)
sancho_kernel_cluster(const double2* __restrict__ A,
                      const double2* __restrict__ B, double2* G, int* counts,
                      double* metrics, double2* scratch, int n, int C,
                      double conv, int max_iter) {
  extern __shared__ double2 smem[];
  Ctx x;
  x.n = n;
  x.np = padded(n);
  x.pw = panel_width(x.np);
  x.C = C;
  x.rank = blockIdx.x % C;              // the block's rank in its cluster
  const int np = x.np, rb8 = np / 8;
  x.r0 = 8 * (x.rank * rb8 / C);
  x.r1 = 8 * ((x.rank + 1) * rb8 / C);
  x.tid = threadIdx.x;
  x.warp = x.tid >> 5;
  x.lane = x.tid & 31;
  const size_t ln = blockIdx.x / C;
  const LaneState L = lane_state(scratch, ln, np);
  const ClusterSmem S = carve_cluster(smem, np);
  const size_t nn = (size_t)n * n;
  const double2* Al = A + ln * nn;
  const double2* Bl = B + ln * nn;
  for (int e = x.tid; e < (x.r1 - x.r0) * np; e += CL_THREADS) {
    const int i = x.r0 + e / np, j = e % np;
    double2 a = make_double2(i == j ? 1.0 : 0.0, 0.0);
    double2 al = make_double2(0.0, 0.0), be = al;
    if (i < n && j < n) {
      a = Al[i * n + j];
      al = Bl[i * n + j];
      const double2 t = Bl[j * n + i];
      be = make_double2(t.x, -t.y);
    }
    const size_t o = (size_t)i * np + j;
    L.es[o] = a;
    L.ep[o] = a;
    __stcg(L.w + o, a);
    __stcg(L.al[0] + o, al);
    __stcg(L.be[0] + o, be);
  }
  lane_sync(C);
  double c = 0.0, diff = INFINITY, ra = 1.0, rb = 1.0;
  int it = 0, cur = 0;
  while (it < max_iter && diff > conv) {
    cluster_inverse(L, S, x);                    // g = inv(eps)
    column_sources(L, S, x);
    double v[4] = {0.0, 0.0, 0.0, 0.0};
    lane_products<false>(L, S, x, cur, ra, rb, 0.0, v);
    // every CTA has read all of g (W) before any writes eps into W
    lane_sync(C);
    lane_products<true>(L, S, x, cur, ra, rb, exp2(c), v);
    cluster_max(S, x, v, it & 1);
    const double sa = balance(sqrt(v[2])), sb = balance(sqrt(v[3]));
    c = 2.0 * c + log2(sa) + log2(sb);
    ra = 1.0 / sa;
    rb = 1.0 / sb;
    const double s = sqrt(v[1]);
    diff = s != s ? NAN : sqrt(v[0]) / fmax(s, 1e-30);
    ++it;
    cur ^= 1;
  }
  for (int e = x.tid; e < (x.r1 - x.r0) * np; e += CL_THREADS) {
    const size_t o = (size_t)x.r0 * np + e;
    __stcg(L.w + o, L.es[o]);
  }
  lane_sync(C);
  cluster_inverse(L, S, x);                      // inv(eps_s)
  column_sources(L, S, x);
  for (int e = x.tid; e < (x.r1 - x.r0) * np; e += CL_THREADS) {
    const int i = x.r0 + e / np, j = e % np;
    if (i < n && j < n)
      G[ln * nn + (size_t)i * n + j] = __ldcg(L.w + (size_t)i * np + S.src[j]);
  }
  if (x.rank == 0 && x.tid == 0) {
    counts[ln] = it;
    metrics[ln] = diff;
  }
  lane_sync(C);     // no CTA leaves while another may read its shared memory
}

// the most dynamic shared memory a launch asks for (the panel width drops
// from 16 to 8 columns past NP = 160)
size_t most_cluster_smem() {
  return std::max(cluster_smem_bytes(160), cluster_smem_bytes(MAX_CLUSTER_N));
}

int set_cluster_smem() {
  static bool configured = false;
  if (configured) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      sancho_kernel_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)most_cluster_smem());
  if (e != cudaSuccess) return (int)e;
  configured = true;
  return 0;
}

// Clusters of c CTAs the current device holds at once (the GPCs bound
// them: a cluster lives in one GPC, and the kernel takes one CTA an SM);
// 0 where CUDA cannot say.  Asked once a device and width.
int cluster_capacity(int c) {
  constexpr int MAX_DEVICES = 64;
  static int cap[MAX_DEVICES][MAX_CLUSTER + 1] = {};
  int dev = 0;
  if (c < 1 || c > MAX_CLUSTER || cudaGetDevice(&dev) != cudaSuccess ||
      dev >= MAX_DEVICES || set_cluster_smem() != 0)
    return 0;
  if (cap[dev][c] == 0) {
    cudaLaunchConfig_t lc = {};
    lc.gridDim = dim3(c);
    lc.blockDim = dim3(CL_THREADS);
    lc.dynamicSmemBytes = most_cluster_smem();
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    lc.attrs = attr;
    lc.numAttrs = 1;
    int num = 0;
    if (cudaOccupancyMaxActiveClusters(&num, (void*)sancho_kernel_cluster,
                                       &lc) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    cap[dev][c] = num;
  }
  return cap[dev][c];
}

// CTAs a lane: the widest cluster (up to 8) of which the device holds all
// b lanes at once, so that a launch is one wave; 1 beyond that
int cluster_width(int b) {
  for (int c = MAX_CLUSTER; c > 1; --c)
    if (b <= cluster_capacity(c)) return c;
  return 1;
}

bool takes_cluster(int n, int mode) {
  return mode == MODE_SANCHO && n >= CLUSTER_N0 && n <= MAX_CLUSTER_N;
}

int launch_cluster(const double2* a, const double2* bb, double2* g, int* cnt,
                   double* met, double2* sc, int b, int n, double conv,
                   int max_iter, cudaStream_t st) {
  const int set = set_cluster_smem();
  if (set != 0) return set;
  const int C = cluster_width(b);
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3((unsigned)b * C);
  lc.blockDim = dim3(CL_THREADS);
  lc.dynamicSmemBytes = cluster_smem_bytes(padded(n));
  lc.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.attrs = attr;
  lc.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&lc, sancho_kernel_cluster, a, bb,
                                           g, cnt, met, sc, n, C, conv,
                                           max_iter);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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
// 3 CTA with the blocks in a global scratch (n > 32); -1 for n < 1.  The
// Sancho mode takes 4 CLUSTER instead where
// gaunegf_sancho_rubio_cluster_width says so.
int gaunegf_sancho_rubio_variant(int n) {
  if (n < 1) return -1;
  if (n == 1) return VARIANT_SCALAR;
  if (n <= MAX_COLUMN_N) return VARIANT_COLUMN;
  return n <= MAX_SHARED_N ? VARIANT_CTA : VARIANT_CTA_GLOBAL;
}

// CTAs a lane of the CLUSTER layout for b lanes of n x n blocks in this
// mode on the current device; 0 where another layout serves them.
int gaunegf_sancho_rubio_cluster_width(int n, int b, int mode) {
  if (b < 1 || !takes_cluster(n, mode)) return 0;
  return cluster_width(b);
}

// Clusters of c CTAs of the CLUSTER layout the current device holds at
// once (1 <= c <= 8); 0 where CUDA cannot say.
int gaunegf_sancho_rubio_cluster_capacity(int c) {
  return cluster_capacity(c);
}

// One launch.  A, B (b, n, n) complex128 in, contiguous; G (b, n, n) out;
// counts (b,) int32 and metrics (b,) float64 receive each lane's
// iterations and last metric.  mode 0: Sancho-Rubio (max_iter iterations
// at most, relax unused); mode 1: the relaxed Dyson map.  scratch: a
// device buffer of b * (9 or 5) * n * n complex128 for variant 3 (n > 32),
// of b * (9 NP^2 + NP / 4) complex128 (NP = n rounded up to a multiple of
// 8) for variant 4, null otherwise.  Returns the CUDA error of the launch
// (0 on success).
int gaunegf_sancho_rubio_c128(const void* A, const void* B, void* G,
                              void* counts, void* metrics, void* scratch,
                              int b, int n, int mode, double conv,
                              double relax, int max_iter, void* stream) {
  const int variant = takes_cluster(n, mode)
      ? VARIANT_CLUSTER : gaunegf_sancho_rubio_variant(n);
  if (b <= 0 || variant < 0 || (mode != MODE_SANCHO && mode != MODE_DYSON)
      || (scratch == nullptr) != (variant < VARIANT_CTA_GLOBAL))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double2* a = static_cast<const double2*>(A);
  const double2* bb = static_cast<const double2*>(B);
  double2* g = static_cast<double2*>(G);
  int* cnt = static_cast<int*>(counts);
  double* met = static_cast<double*>(metrics);
  const bool sancho = mode == MODE_SANCHO;
  if (variant == VARIANT_CLUSTER)
    return launch_cluster(a, bb, g, cnt, met, static_cast<double2*>(scratch),
                          b, n, conv, max_iter, st);
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
