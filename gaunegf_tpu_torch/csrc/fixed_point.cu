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
// while loop, so the iteration never leaves the device.
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
// What bounds it on this card: not bytes (a lane reads 17 KB once), and not
// the card's FP64 rate (~2.3e5 operations a bulk sweep, microseconds for a
// whole batch), but one lane's dependent chain on the SM that holds it:
// nine pivot steps of a 9x9 inverse, two 9x9 products and a lane-wide max
// a sweep, issued as FP64 instructions that take four cycles a warp on an
// SMSP.  A batch of b <= 132 lanes holds one lane an SM, so each SMSP runs
// one warp of that chain (tools/phase_timers.py --kernels fixed_point: at
// 64 lanes 7.6 us a sweep, 42% the inverse, 25% the sums, 25% the
// products; NVIDIA H100 80GB HBM3, 700 W).  The layout keeps the chain
// short and its FP64 work small:
//   * a TEAM of nine threads holds one 9x9 block, one column a thread, in
//     registers; three teams share a warp and a lane's twelve directions
//     take four warps (128 threads).  The five spare threads of a warp
//     shadow the first columns of the warp's last team and write nothing.
//   * the inverse is Gauss-Jordan with partial pivoting (|re| + |im| as
//     LAPACK's izamax, the first row on ties) inside the team: at pivot c
//     the owner of column c has the argmax of its own registers, one
//     shuffle hands everyone the pivot row, each thread swaps two of its
//     registers by selects, and the pivot column arrives by shuffles --
//     no shared memory, no __syncwarp and no reduction inside the chain.
//     The row swaps are undone as column swaps, which only renames which
//     thread holds which column of the inverse: nothing moves.
//   * the team stages its inverse in shared memory once (each thread its
//     column, at its renamed place), then computes its column of
//     U = g B_k^+ and of B_k U from the staged g and B_k.
//   * every team inverts: with one shared inverse (the surface loop, bulk
//     without exclusion) all twelve compute the same g side by side, so no
//     warp waits on another.
//   * the state sits in shared memory twice (ping-pong by sweep parity), so
//     a Jacobi sweep needs one barrier of the lane's 128 threads (a named
//     barrier, not the CTA's) and a Seidel sweep one per round; the
//     lane-wide max is a warp shuffle reduction and one small shared
//     stage read after that barrier.  Magnitudes are compared squared,
//     and each team takes the old state's max over its own slot only.
//   * complex multiply-adds are two fused multiply-adds a component, and a
//     reciprocal is one division (the pivot scaled by an exact power of
//     two first): 31% less time a sweep than the same layout without.
//   * up to three lanes share a CTA, each on its own barrier, so a lane
//     that has converged (or turned NaN) leaves its loop without waiting
//     for its neighbours.  Lanes per CTA = ceil(b / SMs) up to 3, so a
//     batch no larger than the SM count gets an SM per lane.
// Shared memory per lane: 63,632 bytes (A, the 12 B_k, two copies of the
// state, twelve staged inverses, the max stage); three lanes fill 191 KB.
// ptxas -v (sm_90a): 140 registers a thread, no spills, so 128 threads a
// lane take 17,920 registers.  The results differ from the plain
// version's getrf/getri only in rounding.  Everything is complex128.

#include <cuda_runtime.h>
#include <math.h>

// Phase timers (tools/phase_timers.py --kernels fixed_point builds this
// file with -DGAUNEGF_PHASE_CLOCKS): thread 0 of every lane adds the clock
// cycles since its previous mark to phase k; without the define the marks
// vanish.
#ifdef GAUNEGF_PHASE_CLOCKS
__device__ unsigned long long g_phase_clk[8];
struct PhaseClock {
  unsigned long long t, acc[8];
  bool on;
};
#define PHASE_START(on) PhaseClock phase_ = {clock64(), {}, (on)};
#define PHASE_PARAM , PhaseClock& phase_
#define PHASE_PASS , phase_
#define PHASE(k)                                   \
  if (phase_.on) {                                 \
    const unsigned long long t_ = clock64();       \
    phase_.acc[k] += t_ - phase_.t;                \
    phase_.t = t_;                                 \
  }
#define PHASE_END                                                   \
  if (phase_.on)                                                    \
    for (int k_ = 0; k_ < 8; ++k_) atomicAdd(&g_phase_clk[k_], phase_.acc[k_]);
#else
#define PHASE_START(on)
#define PHASE_PARAM
#define PHASE_PASS
#define PHASE(k)
#define PHASE_END
#endif

namespace {

constexpr int D = 9;              // orbitals of an spd atom
constexpr int DD = D * D;
constexpr int NN = 12;            // nearest-neighbour directions (fcc)
constexpr int NS = 9;             // surface slots (the 3 upward ones dropped)
constexpr int NP = 6;             // in-plane slots
constexpr int TEAMS_PER_WARP = 3;
constexpr int LANE_WARPS = NN / TEAMS_PER_WARP;      // 4
constexpr int LANE_THREADS = 32 * LANE_WARPS;        // 128
constexpr int MAX_LANES = 3;      // lanes per CTA (shared memory)
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
// s + a b, s + a conj(b), s - a b: two fused multiply-adds a component
// (written out, since the contraction of s + (a.x b.x - a.y b.y) takes
// three FP64 instructions a component, and FP64 issue bounds a sweep)
__device__ __forceinline__ double2 cmac(double2 s, double2 a, double2 b) {
  return make_double2(fma(-a.y, b.y, fma(a.x, b.x, s.x)),
                      fma(a.y, b.x, fma(a.x, b.y, s.y)));
}
__device__ __forceinline__ double2 cmacc(double2 s, double2 a, double2 b) {
  return make_double2(fma(a.y, b.y, fma(a.x, b.x, s.x)),
                      fma(-a.x, b.y, fma(a.y, b.x, s.y)));
}
__device__ __forceinline__ double2 cmsub(double2 s, double2 a, double2 b) {
  return make_double2(fma(a.y, b.y, fma(-a.x, b.x, s.x)),
                      fma(-a.y, b.x, fma(-a.x, b.y, s.y)));
}
// |a|^2: the maxima compare squares and take one root at the end
__device__ __forceinline__ double cnorm(double2 a) {
  return fma(a.x, a.x, a.y * a.y);
}
// 1 / a = s conj(a') / |a'|^2 with a' = s a, s the power of two that brings
// max(|re|, |im|) into [1, 2) (built from its exponent bits, so exact): one
// division, and |a'|^2 neither overflows nor underflows
__device__ __forceinline__ double2 crecip(double2 a) {
  const int hi = __double2hiint(fmax(fabs(a.x), fabs(a.y))) & 0x7ff00000;
  const double s = __hiloint2double(0x7fe00000 - hi, 0);
  const double x = a.x * s, y = a.y * s;
  const double q = s / fma(x, x, y * y);
  return make_double2(x * q, -y * q);
}
// max that keeps a NaN, as torch's amax does
__device__ __forceinline__ double nanmax(double a, double b) {
  return (a != a || b != b) ? NAN : fmax(a, b);
}
__device__ __forceinline__ double2 shfl2(double2 v, int src) {
  return make_double2(__shfl_sync(FULL, v.x, src),
                      __shfl_sync(FULL, v.y, src));
}

// Inverse of the team's 9x9 block, the thread holding column j in w (the
// team's column 0 at warp lane `base`).  Gauss-Jordan in place with partial
// pivoting, as gj_inverse in tests/test_torch_fixed_point.py.  Returns the
// column of the inverse that w holds afterwards: undoing the row swaps as
// column swaps in reverse order only renames the columns.
__device__ __forceinline__ int team_inverse9(double2 (&w)[D], int j,
                                             int base) {
  int piv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    int p = c;
    double best = fabs(w[c].x) + fabs(w[c].y);
#pragma unroll
    for (int r = c + 1; r < D; ++r) {
      const double m = fabs(w[r].x) + fabs(w[r].y);
      if (m > best) {
        best = m;
        p = r;
      }
    }
    p = __shfl_sync(FULL, p, base + c);       // the owner's pivot row
    piv[c] = p;
    double2 vp = w[c];
#pragma unroll
    for (int r = c + 1; r < D; ++r)
      if (r == p) vp = w[r];
#pragma unroll
    for (int r = c + 1; r < D; ++r)
      if (r == p) w[r] = w[c];
    w[c] = vp;
    const double2 inv = crecip(shfl2(w[c], base + c));
    const bool own = j == c;
    const double2 wc = cmul(own ? make_double2(1.0, 0.0) : w[c], inv);
#pragma unroll
    for (int r = 0; r < D; ++r) {
      if (r == c) continue;
      const double2 f = shfl2(w[r], base + c);   // the pivot column
      w[r] = cmsub(own ? make_double2(0.0, 0.0) : w[r], f, wc);
    }
    w[c] = wc;
  }
  int pos = j;
#pragma unroll
  for (int c = D - 1; c >= 0; --c) {
    if (pos == c) pos = piv[c];
    else if (pos == piv[c]) pos = c;
  }
  return pos;
}

struct Lane {                    // one lane's shared memory
  double2 A[DD];
  double2 B[NN * DD];
  double2 sig[2][NN * DD];       // the state; sweep `it` reads [it & 1]
  double2 G[NN][DD];             // each team's staged inverse
  double red[2][LANE_WARPS][2];  // per warp: max |d sigma|^2, max |sigma|^2
};

struct Place {                   // a thread's place in its lane
  int warp;                      // 0..3 within the lane
  int team;                      // 0..11
  int j;                         // the column it holds
  int base;                      // warp lane of the team's column 0
  bool ghost;                    // a spare thread: computes, writes nothing
  int barrier;                   // the lane's named barrier
};

__device__ __forceinline__ void lane_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(LANE_THREADS) : "memory");
}

// Column j of the new sigma_k = mix * B_k g B_k^+ + (1 - mix) * old from
// the staged g: U = g B_k^+ (column j: g times row j of B_k, conjugated),
// then B_k U.  Writes it to out (unless a ghost); returns max |new - old|^2.
__device__ __forceinline__ double update_column(const Lane& L, int k, const double2* G,
                                const double2* old, double2* out,
                                const Place& P, double mix) {
  const double2* Bk = L.B + k * DD;
  double2 brow[D], u[D];
#pragma unroll
  for (int l = 0; l < D; ++l) brow[l] = Bk[P.j * D + l];
#pragma unroll
  for (int r = 0; r < D; ++r) {
    double2 s = make_double2(0.0, 0.0);
#pragma unroll
    for (int l = 0; l < D; ++l) s = cmacc(s, G[r * D + l], brow[l]);
    u[r] = s;
  }
  double d2 = 0.0;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    double2 s = make_double2(0.0, 0.0);
#pragma unroll
    for (int l = 0; l < D; ++l) s = cmac(s, Bk[i * D + l], u[l]);
    const double2 o = old[i * D + P.j];
    const double2 nw = make_double2(fma(mix, s.x, (1.0 - mix) * o.x),
                                    fma(mix, s.y, (1.0 - mix) * o.y));
    d2 = nanmax(d2, cnorm(csub(nw, o)));
    if (!P.ghost) out[i * D + P.j] = nw;
  }
  return d2;
}

// Invert the team's block w, stage it in the team's G, update slot k.
__device__ __forceinline__ double invert_and_update(Lane& L, double2 (&w)[D], int k,
                                    const double2* old, double2* out,
                                    const Place& P, double mix PHASE_PARAM) {
  const int pos = team_inverse9(w, P.j, P.base);
  PHASE(2)
  double2* G = L.G[P.team];
  if (!P.ghost) {
#pragma unroll
    for (int r = 0; r < D; ++r) G[r * D + pos] = w[r];
  }
  __syncwarp();
  const double d2 = update_column(L, k, G, old, out, P, mix);
  PHASE(3)
  return d2;
}

// One fixed-point loop on the lane's state, starting from L.sig[0] (and,
// for slots no sweep updates, L.sig[1]); returns the sweeps run, the
// result in L.sig[sweeps & 1], and the last metric in *metric.  Every
// branch is taken by whole warps, and the loop's condition is the same in
// all of the lane's threads.
__device__ int run_loop(Lane& L, const Place& P, bool bulk, bool seidel,
                        bool exclusion, double conv, double mix,
                        int max_iter, double* metric PHASE_PARAM) {
  const int nslots = bulk ? NN : NS;
  const int slot = bulk ? P.team : (P.team < NP ? kPlane[P.team] : -1);
  const int lane = threadIdx.x & 31;
  double diff = INFINITY;
  int it = 0;
  while (it < max_iter && diff > conv) {
    const int p = it & 1;
    const double2* cur = L.sig[p];
    double2* nxt = L.sig[1 - p];
    // column j of A - sum_k sigma_k and of max |sigma_old|^2
    double2 w[D];
    double o2 = 0.0;
#pragma unroll
    for (int r = 0; r < D; ++r) w[r] = make_double2(0.0, 0.0);
    for (int k = 0; k < nslots; ++k) {
#pragma unroll
      for (int r = 0; r < D; ++r) w[r] = cadd(w[r], cur[k * DD + r * D + P.j]);
    }
    if (P.team < nslots) {    // max |sigma_old|^2: team t reads slot t
      const double2* m = cur + P.team * DD;
#pragma unroll
      for (int r = 0; r < D; ++r) o2 = nanmax(o2, cnorm(m[r * D + P.j]));
    }
#pragma unroll
    for (int r = 0; r < D; ++r) w[r] = csub(L.A[r * D + P.j], w[r]);
    double d2 = 0.0;
    PHASE(1)
    if (seidel) {
      // round 0: directions 0..5 against their old opposite slots
      if (P.team < NP) {
        const double2* sp = cur + kPair[P.team] * DD;
#pragma unroll
        for (int r = 0; r < D; ++r) w[r] = cadd(w[r], sp[r * D + P.j]);
        d2 = invert_and_update(L, w, P.team, cur + P.team * DD,
                               nxt + P.team * DD, P, mix PHASE_PASS);
      }
      lane_sync(P.barrier);
      PHASE(4)
      // round 1: directions 6..11 against the refreshed 0..5
      if (P.team >= NP) {
        const double2* sp = nxt + kPair[P.team] * DD;
#pragma unroll
        for (int r = 0; r < D; ++r) w[r] = cadd(w[r], sp[r * D + P.j]);
        d2 = invert_and_update(L, w, P.team, cur + P.team * DD,
                               nxt + P.team * DD, P, mix PHASE_PASS);
      }
    } else if (slot >= 0) {
      if (bulk && exclusion) {
        const double2* sp = cur + kPair[slot] * DD;
#pragma unroll
        for (int r = 0; r < D; ++r) w[r] = cadd(w[r], sp[r * D + P.j]);
      }
      d2 = invert_and_update(L, w, slot, cur + slot * DD, nxt + slot * DD,
                             P, mix PHASE_PASS);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      d2 = nanmax(d2, __shfl_xor_sync(FULL, d2, off));
      o2 = nanmax(o2, __shfl_xor_sync(FULL, o2, off));
    }
    if (lane == 0) {
      L.red[p][P.warp][0] = d2;
      L.red[p][P.warp][1] = o2;
    }
    lane_sync(P.barrier);
    double d = 0.0, o = 0.0;
#pragma unroll
    for (int i = 0; i < LANE_WARPS; ++i) {
      d = nanmax(d, L.red[p][i][0]);
      o = nanmax(o, L.red[p][i][1]);
    }
    diff = sqrt(d) / fmax(sqrt(o), 1e-30);
    if (o != o) diff = NAN;
    ++it;
    PHASE(4)
  }
  *metric = diff;
  return it;
}

__global__ void __launch_bounds__(MAX_LANES * LANE_THREADS)
fixed_point_kernel(const double2* __restrict__ A,
                   const double2* __restrict__ B,
                   const double2* __restrict__ seed, double2* sig_bulk,
                   double2* sig_surf, int* counts, double* metrics, int b,
                   int lanes_per_cta, int bulk_mode, int exclusion,
                   int surface, double conv, double mix, int max_iter) {
  extern __shared__ double2 smem[];
  const int slot = threadIdx.x / LANE_THREADS;
  const size_t ln = (size_t)blockIdx.x * lanes_per_cta + slot;
  if (ln >= (size_t)b) return;          // the whole lane: no CTA barrier
  Lane& L = reinterpret_cast<Lane*>(smem)[slot];
  const int tid = threadIdx.x - slot * LANE_THREADS;
  const int lane = tid & 31;
  Place P;
  P.warp = tid >> 5;
  P.ghost = lane >= TEAMS_PER_WARP * D;
  const int tw = P.ghost ? TEAMS_PER_WARP - 1 : lane / D;
  P.team = P.warp * TEAMS_PER_WARP + tw;
  P.base = tw * D;
  P.j = P.ghost ? lane - TEAMS_PER_WARP * D : lane - P.base;
  P.barrier = 1 + slot;

  PHASE_START(tid == 0)
  const bool bulk = bulk_mode != BULK_NONE;
  const int nin = bulk ? NN : NS;
  for (int i = tid; i < DD; i += LANE_THREADS) L.A[i] = A[ln * DD + i];
  for (int i = tid; i < NN * DD; i += LANE_THREADS)
    L.B[i] = B[ln * NN * DD + i];
  for (int i = tid; i < nin * DD; i += LANE_THREADS) {
    const double2 v = seed[ln * nin * DD + i];
    L.sig[0][i] = v;
    L.sig[1][i] = v;                    // slots that no sweep updates
  }
  lane_sync(P.barrier);
  PHASE(0)
  double metric = INFINITY;
  int n = 0;
  if (bulk) {
    n = run_loop(L, P, true, bulk_mode == BULK_SEIDEL && exclusion,
                 exclusion != 0, conv, mix, max_iter, &metric PHASE_PASS);
    const double2* res = L.sig[n & 1];
    for (int i = tid; i < NN * DD; i += LANE_THREADS)
      sig_bulk[ln * NN * DD + i] = res[i];
    if (surface) {                      // the surface loop's seed
      double2* other = L.sig[(n & 1) ^ 1];
      for (int i = tid; i < NS * DD; i += LANE_THREADS) other[i] = res[i];
      lane_sync(P.barrier);
    }
    PHASE(5)
  }
  if (tid == 0) {
    counts[2 * ln] = n;
    metrics[2 * ln] = metric;
  }
  n = 0;
  metric = INFINITY;
  if (surface) {
    n = run_loop(L, P, false, false, false, conv, mix, max_iter,
                 &metric PHASE_PASS);
    const double2* res = L.sig[n & 1];
    for (int i = tid; i < NS * DD; i += LANE_THREADS)
      sig_surf[ln * NS * DD + i] = res[i];
  }
  if (tid == 0) {
    counts[2 * ln + 1] = n;
    metrics[2 * ln + 1] = metric;
  }
  PHASE(5)
  PHASE_END
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess || sms <= 0)
    return 1;
  return sms;
}

}  // namespace

extern "C" {

// Lanes per CTA for a batch of b lanes: ceil(b / SMs), at most 3 (shared
// memory), so a batch that the SMs can hold gets an SM per lane.
int gaunegf_fixed_point_lanes_per_cta(int b) {
  const int sms = sm_count();
  const int want = (b + sms - 1) / sms;
  return want < 1 ? 1 : (want > MAX_LANES ? MAX_LANES : want);
}

// One launch.  A (b, 9, 9), B (b, 12, 9, 9) complex128, contiguous; seed
// (b, 12, 9, 9) when bulk_mode is 1 (Jacobi) or 2 (Seidel), else (b, 9, 9,
// 9) for the surface loop alone; read only.  The bulk result goes to
// sig_bulk (b, 12, 9, 9) and, with surface != 0, the in-plane loop's (from
// the bulk result when a bulk loop ran, else from the seed) to sig_surf
// (b, 9, 9, 9).  counts (b, 2) int32 and metrics (b, 2) float64 receive
// each loop's sweeps and last relative change (0 and inf for a loop that
// did not run).  Returns the CUDA error of the launch (0 on success).
int gaunegf_fixed_point_c128(const void* A, const void* B, const void* seed,
                             void* sig_bulk, void* sig_surf, void* counts,
                             void* metrics, int b, int bulk_mode,
                             int exclusion, int surface, double conv,
                             double mix, int max_iter, void* stream) {
  if (b <= 0 || bulk_mode < BULK_NONE || bulk_mode > BULK_SEIDEL
      || (bulk_mode == BULK_NONE && !surface))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        fixed_point_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(MAX_LANES * sizeof(Lane)));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int per = gaunegf_fixed_point_lanes_per_cta(b);
  const int ctas = (b + per - 1) / per;
  fixed_point_kernel<<<ctas, per * LANE_THREADS, per * sizeof(Lane),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(A), static_cast<const double2*>(B),
      static_cast<const double2*>(seed), static_cast<double2*>(sig_bulk),
      static_cast<double2*>(sig_surf), static_cast<int*>(counts),
      static_cast<double*>(metrics), b, per, bulk_mode, exclusion, surface,
      conv, mix, max_iter);
  return (int)cudaGetLastError();
}

#ifdef GAUNEGF_PHASE_CLOCKS
// The phase timers' cycle sums (8 values) into out, then zeroed.
int gaunegf_fixed_point_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_clk, sizeof(g_phase_clk));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_clk, zero, sizeof(zero)));
}
#endif

}  // extern "C"
