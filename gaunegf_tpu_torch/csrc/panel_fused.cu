// Fused panel factorization of the blocked complex LU, for Hopper (sm_90a).
//
// Replaces the TPU kernel gaunegf_tpu/ops/pallas/panel_fused.py
// (factor_panel_fused, body _make_kernel): the whole virtually pivoted
// (m, bs) complex64 panel in one program.  Lanes are panel rows, strip rows
// are panel columns.  For each strip of S = min(32, bs) columns:
//   * S eliminations (column j of the strip): pivot p = the first available
//     lane of largest |c| (jnp.hypot's formula); reciprocal
//     (pr, -pi) / (pr^2 + pi^2), a zero denominator reading as 1;
//     multipliers l = c / p at the available lanes other than p; rank-1
//     update of the strip columns right of j with u[r] = strip[r][p];
//     piv = p, and lane p leaves the available set;
//   * the deferred update of the later columns: G[j][k] = strip[j][piv_k]
//     (its strict upper part is L11^T), W = U (L11^T)^-1 for each later
//     column's values U at the pivot lanes (forward substitution), then
//     rest[r][l] -= sum_k W[r][k] * strip[k][l] over the still-available
//     lanes l, and W written into the pivot lanes.
// Every product, sum and quotient is rounded as its own operation (the
// __f*_rn intrinsics forbid fused multiply-adds) and every sum over k runs
// one term at a time in ascending k, so the kernel returns bit for bit
// what the plain PyTorch version computes
// (gaunegf_tpu_torch/ops/kernels/panel_fused.py::factor_panel_fused_plain).
//
// Bound on the card at B = 64 panels of (1024, 256): the deferred updates
// carry the work, sum_j (m-j-1)(bs-j-1) complex updates of 8 operations,
// 15.7 G operations: 0.236 ms at the 67 TFLOP/s FP32 peak, operations-bound
// (the panel's bytes once take 0.16 ms).  Bit-identity forbids fused
// multiply-adds, so the floor is the separately rounded rate, 33.5 T ops/s:
// ~0.47 ms.  The eliminations are bound by latency, not throughput: 256
// dependent cluster-wide steps (argmax, pivot broadcast, rank-1 update),
// ~0.9 ms at the ~3.5 us a step of the strip kernel (csrc/strip_elim.cu).
//
// Design: one thread-block cluster per panel; its ncta CTAs of 512 threads
// each own a contiguous range of lanes (ncta = SMs / batch, 1 to 8, doubled
// until the strip fits: 2 CTAs of 512 lanes at (64, 1024, 256), one wave
// of 128 CTAs; 8 at m = 4096).  The panel is read and factored in its stored (B, m, bs)
// layout, in place: a lane's S strip values are 8 S contiguous bytes.  What
// the first version (one 256-thread block per panel, everything in device
// memory) lost, and what this one does instead:
//   1. Half the card idle, 8 warps a panel -> a cluster of 16-warp CTAs per
//      panel, sized from the batch so that a chunk fills the SMs once.
//   2. Eliminations in device memory, four block barriers a step -> the
//      current strip of every owned lane lives in shared memory (256 B a
//      lane) from its look-ahead update to its store, with the avail mask
//      and the pivots for the whole panel; each step is the strip kernel's:
//      a warp-shuffle argmax in each CTA, each CTA's candidate (partial,
//      the lane's strip column, its reciprocal) published in buffers that
//      alternate by step parity, one cluster barrier, every CTA combining
//      the candidates through distributed shared memory (first lane on
//      ties), then the rank-1 update of its own lanes.  The winner's
//      column is G's column j, so G needs no further reads.
//   3. A serial trailing update, one dependent chain a thread -> each
//      thread takes two lanes and 8 later columns at a time (16 independent
//      accumulators), the two halves of the CTA alternate column groups; W
//      is read as shared-memory broadcasts (16-byte loads, W stored
//      k-major), each value feeding both lanes, L from shared memory; each
//      element still takes its 32 terms in ascending k.  (With one lane a
//      thread the W broadcasts alone kept shared memory as busy as the FP32
//      pipes, ~58% of their rate.)
//   4. Uncoalesced W gathers -> U (the later columns at the pivot lanes) is
//      read once per strip, contiguous along the columns; every CTA solves
//      W for all later columns itself in registers, two threads a column
//      (~0.9 M operations a strip against ~29 M for its trailing update);
//      one cluster barrier
//      then orders those reads before the owners write W into their pivot
//      lanes.
//   5. Two full copies in the wrapper (a transposed clone, then a gathered
//      transpose) -> the wrapper makes one contiguous copy that the kernel
//      factors in place, and packs the rows with one gather.
// Look-ahead: the next strip's columns take their update with the others,
// in place, and are loaded into shared memory right after (from L2; L is
// read until every thread is done), where they stay for its eliminations;
// every later column is read and written once per strip, each lane's
// contiguous.
// Where the strip of a CTA's lanes does not fit shared memory beside W (m
// beyond ~4800 at bs = 256 on 8 CTAs), the CTA keeps its first lanes on
// chip and factors the rest in place in device memory.
// What bounds it now (tools/phase_timers.py, H100 80GB HBM3 at 700 W,
// (64, 1024, 256), 1.81 ms a launch against 8.83 for the first version):
// the 256 dependent elimination steps, ~46% of a CTA's cycles at ~3 us a
// step (scan, publish and cluster barrier 23%, combine 7%, lane updates
// 16%), as in the strip kernel; the trailing update ~45% (its paired FP32
// update runs at ~70% of the separately rounded rate; the strip stores, W
// writes and the look-ahead reload are the rest); the W solves 8%,
// latency-bound with 14 of 16 warps.
//
// C interface (ctypes): returns the CUDA error code of the launch.

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
constexpr int kStrip = 32;
constexpr int kMaxBs = 512;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kChunk = 8;          // strip columns per batch of loads in a lane step
constexpr int kGroup = 8;          // later columns per pass of the trailing update
constexpr size_t kSmemBudget = 212 * 1024;   // dynamic; static uses ~9.5 KB

// lane states in s_av: used by an earlier strip, available, or pivot of
// step k of the current strip (kPivot + k)
constexpr unsigned char kUsed = 0, kAvail = 1, kPivot = 2;

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

// 1 / p = (pr, -pi) / (pr^2 + pi^2), a zero denominator read as 1
__device__ __forceinline__ float2 reciprocal(float2 p) {
  float den = __fadd_rn(__fmul_rn(p.x, p.x), __fmul_rn(p.y, p.y));
  if (den == 0.f) den = 1.f;
  return make_float2(__fdiv_rn(p.x, den), __fdiv_rn(-p.y, den));
}

// a - w * b, complex, each operation rounded: (a.x - (w.x b.x - w.y b.y),
// a.y - (w.x b.y + w.y b.x))
__device__ __forceinline__ float2 sub_mul(float2 a, float2 w, float2 b) {
  a.x = __fsub_rn(a.x, __fsub_rn(__fmul_rn(w.x, b.x), __fmul_rn(w.y, b.y)));
  a.y = __fsub_rn(a.y, __fadd_rn(__fmul_rn(w.x, b.y), __fmul_rn(w.y, b.x)));
  return a;
}

// Step j at one available lane whose strip columns lie at col[r * stride]:
// the multiplier l = col[j] * inv replaces col[j], and columns r > j take
// col[r] -= u[r] * l.  kChunk columns at a time: all loads, then the
// arithmetic, then the stores.
__device__ __forceinline__ void lane_step(float2* col, int stride,
                                          const float2* u, int j, int S,
                                          float2 inv) {
  const float2 c = col[j * stride];
  const float lr = __fsub_rn(__fmul_rn(c.x, inv.x), __fmul_rn(c.y, inv.y));
  const float li = __fadd_rn(__fmul_rn(c.x, inv.y), __fmul_rn(c.y, inv.x));
  const float2 l = make_float2(lr, li);
  col[j * stride] = l;
  for (int r0 = j + 1; r0 < S; r0 += kChunk) {
    float2 v[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (r0 + q < S) v[q] = col[(r0 + q) * stride];
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) v[q] = sub_mul(v[q], u[min(r0 + q, S - 1)], l);
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (r0 + q < S) col[(r0 + q) * stride] = v[q];
    }
  }
}

// x[r] -= sum_k W[r][k] l[k] for one column group x[0..kGroup) of a lane:
// the 32 terms in ascending k, W k-major in shared memory (row stride ldw,
// 16-byte broadcast loads).  Two lanes at a time (x0 / l0, x1 / l1), so
// each W value loaded feeds both; L[k] of a lane at L[k * Ls].
__device__ __forceinline__ void trail_group(float2* x0, float2* x1,
                                            const float2* L0, const float2* L1,
                                            int Ls, const float2* w, int ldw,
                                            bool st0, bool st1) {
  float2 a[kGroup], c[kGroup];
  const float4* src0 = reinterpret_cast<const float4*>(x0);
  const float4* src1 = reinterpret_cast<const float4*>(x1);
#pragma unroll
  for (int q = 0; q < kGroup / 2; ++q) {
    const float4 u = src0[q], v = src1[q];
    a[2 * q] = make_float2(u.x, u.y);
    a[2 * q + 1] = make_float2(u.z, u.w);
    c[2 * q] = make_float2(v.x, v.y);
    c[2 * q + 1] = make_float2(v.z, v.w);
  }
#pragma unroll 4
  for (int k = 0; k < kStrip; ++k) {
    const float2 l0 = L0[k * Ls], l1 = L1[k * Ls];
    const float4* wk = reinterpret_cast<const float4*>(w + k * ldw);
#pragma unroll
    for (int q = 0; q < kGroup / 2; ++q) {
      const float4 v = wk[q];
      const float2 w0 = make_float2(v.x, v.y), w1 = make_float2(v.z, v.w);
      a[2 * q] = sub_mul(a[2 * q], w0, l0);
      a[2 * q + 1] = sub_mul(a[2 * q + 1], w1, l0);
      c[2 * q] = sub_mul(c[2 * q], w0, l1);
      c[2 * q + 1] = sub_mul(c[2 * q + 1], w1, l1);
    }
  }
  float4* d0 = reinterpret_cast<float4*>(x0);
  float4* d1 = reinterpret_cast<float4*>(x1);
#pragma unroll
  for (int q = 0; q < kGroup / 2; ++q) {
    if (st0) d0[q] = make_float4(a[2 * q].x, a[2 * q].y, a[2 * q + 1].x, a[2 * q + 1].y);
    if (st1) d1[q] = make_float4(c[2 * q].x, c[2 * q].y, c[2 * q + 1].x, c[2 * q + 1].y);
  }
}

// One cluster per panel.  CTA `rank` owns lanes [rank * W, rank * W + nl);
// its first wc lanes hold the current strip in s_strip (S x wc, column r of
// lane l at r * wc + l), the rest stay in place in device memory.  In the
// eliminations each lane is read and written by one thread only (lanes tid,
// tid + 512, ...); the trailing update reads the strip and writes device
// memory, by lane pairs and column groups, and barriers order the rest.
__global__ void __launch_bounds__(kThreads, 1)
panel_fused_kernel(float2* __restrict__ panel, unsigned char* __restrict__ avail,
                   int* __restrict__ piv, int m, int bs, int S, int W, int wc) {
  PHASE_START
  cg::cluster_group cluster = cg::this_cluster();
  const int ncta = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / ncta;
  float2* pb = panel + b * m * bs;
  unsigned char* av = avail + b * m;
  int* pv = piv + b * bs;
  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const int warp = tid >> 5;
  const int L0 = rank * W;
  const int nl = max(0, min(W, m - L0));
  const int nc = min(nl, wc);
  const int ldw = bs - S;              // later columns of the first strip
  // a one-CTA cluster needs only the CTA barrier
  auto sync_all = [&]() {
    if (ncta > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };
  // lane l's row of the panel (l counted from L0)
  auto row = [&](int l) { return pb + static_cast<size_t>(L0 + l) * bs; };

  extern __shared__ __align__(16) unsigned char smem[];
  float2* s_W = reinterpret_cast<float2*>(smem);            // S x ldw, k-major
  float2* s_strip = s_W + static_cast<size_t>(S) * ldw;     // S x wc
  unsigned char* s_av = reinterpret_cast<unsigned char*>(
      s_strip + static_cast<size_t>(S) * wc);               // W lane states
  __shared__ float2 s_G[kStrip][kStrip + 1];  // G[r][k] = strip[r][piv_k]
  __shared__ float s_wmag[kWarps];
  __shared__ int s_widx[kWarps];
  // this CTA's candidate, read by the cluster, by step parity
  __shared__ float s_cmag[2];
  __shared__ int s_cidx[2];
  __shared__ float2 s_cinv[2];
  __shared__ float2 s_cand[2][kStrip];        // the candidate lane's columns
  __shared__ float2 s_u[kStrip];              // the pivot lane's columns
  __shared__ float2 s_inv;
  __shared__ int s_p;
  __shared__ int s_piv[kStrip];

  for (int l = tid; l < nc; l += kThreads) {
    const float2* g = row(l);
    for (int r = 0; r < S; ++r) s_strip[r * wc + l] = g[r];
  }
  for (int l = tid; l < nl; l += kThreads) s_av[l] = kAvail;
  __syncthreads();
  PHASE(0)

  for (int s0 = 0; s0 < bs; s0 += S) {
    for (int j = 0; j < S; ++j) {
      const int par = j & 1;
      // masked argmax; lanes are visited in ascending order, so a strict
      // comparison keeps the first of equal magnitudes
      float best = -INFINITY;
      int bidx = INT_MAX;
      for (int l = tid; l < nl; l += kThreads) {
        const float2 c = l < wc ? s_strip[j * wc + l] : row(l)[s0 + j];
        const float mag = s_av[l] == kAvail ? hypot_ref(c.x, c.y) : -1.f;
        if (mag > best) {
          best = mag;
          bidx = L0 + l;
        }
      }
      warp_argmax(best, bidx);
      if (wl == 0) {
        s_wmag[warp] = best;
        s_widx[warp] = bidx;
      }
      __syncthreads();
      // publish this CTA's candidate: its partial, its lane's strip
      // columns and their reciprocal at column j
      if (warp == 0) {
        best = wl < kWarps ? s_wmag[wl] : -INFINITY;
        bidx = wl < kWarps ? s_widx[wl] : INT_MAX;
        warp_argmax(best, bidx);
        bidx = __shfl_sync(0xffffffffu, bidx, 0);
        if (bidx != INT_MAX) {
          const int l = bidx - L0;
          if (wl < S) {
            s_cand[par][wl] = l < wc ? s_strip[wl * wc + l] : row(l)[s0 + wl];
          }
          if (wl == 0) {
            s_cinv[par] = reciprocal(l < wc ? s_strip[j * wc + l]
                                            : row(l)[s0 + j]);
          }
        }
        if (wl == 0) {
          s_cmag[par] = best;
          s_cidx[par] = bidx;
        }
      }
      sync_all();                  // every CTA's candidate of step j is out
      PHASE(1)
      // combine the candidates; the winner's columns are the pivot column
      // (rows below j) and G's column j (the pivot lane changes no more)
      if (warp == 0) {
        float2 inv_k = make_float2(0.f, 0.f);
        best = -INFINITY;
        bidx = INT_MAX;
        if (wl < ncta) {
          best = cluster.map_shared_rank(s_cmag, wl)[par];
          bidx = cluster.map_shared_rank(s_cidx, wl)[par];
          inv_k = cluster.map_shared_rank(s_cinv, wl)[par];
        }
        float2 col_k[kMaxCluster];
#pragma unroll
        for (int k = 0; k < kMaxCluster; ++k) {
          if (k < ncta && wl < S) {
            col_k[k] = cluster.map_shared_rank(s_cand[par], k)[wl];
          }
        }
        warp_argmax(best, bidx);
        int p = __shfl_sync(0xffffffffu, bidx, 0);
        if (p == INT_MAX) p = 0;                // no candidate (NaN lanes)
        const int o = p / W;
        const float2 inv = make_float2(__shfl_sync(0xffffffffu, inv_k.x, o),
                                       __shfl_sync(0xffffffffu, inv_k.y, o));
        if (wl < S) {
          float2 u = col_k[0];
#pragma unroll
          for (int k = 1; k < kMaxCluster; ++k) {
            if (k == o) u = col_k[k];
          }
          s_u[wl] = u;
          s_G[wl][j] = u;
        }
        if (wl == 0) {
          s_inv = inv;
          s_p = p;
          s_piv[j] = p;
          if (rank == 0) pv[s0 + j] = p;
        }
      }
      __syncthreads();
      PHASE(2)
      // no barrier closes the step: each thread's lanes are its own, and
      // s_u, s_inv, s_p change only after the next cluster barrier
      const int p = s_p;
      const float2 inv = s_inv;
      for (int l = tid; l < nl; l += kThreads) {
        if (L0 + l == p) {
          s_av[l] = kPivot + j;
          continue;
        }
        if (s_av[l] != kAvail) continue;
        if (l < wc) {
          lane_step(s_strip + l, wc, s_u, j, S, inv);
        } else {
          lane_step(row(l) + s0, 1, s_u, j, S, inv);
        }
      }
      PHASE(3)
    }

    const int s1 = s0 + S;
    const int rest = bs - s1;
    if (rest == 0) {
      // the last strip's columns, and which lanes stay available
      for (int l = tid; l < nl; l += kThreads) {
        const unsigned char st = s_av[l];
        if (l < wc && st != kUsed) {
          float2* g = row(l) + s0;
          for (int r = 0; r < S; ++r) g[r] = s_strip[r * wc + l];
        }
        av[L0 + l] = st == kAvail;
      }
      break;
    }

    // ---- W = U (L11^T)^-1: U[r][k] = later column r at lane piv_k; every
    // CTA solves all later columns, one a thread, in registers (s_G and
    // s_piv were complete at the last step's CTA barrier) ----
    // two threads (adjacent lanes of a warp) a later column r: thread h
    // holds w[2q + h], q < 16; rest is a multiple of 32, so whole warps
    // take part in the shuffles
    for (int t = tid; t < 2 * rest; t += kThreads) {
      const int r = t >> 1, h = t & 1;
      float2 w[kStrip / 2];
#pragma unroll
      for (int q = 0; q < kStrip / 2; ++q) {
        w[q] = pb[static_cast<size_t>(s_piv[2 * q + h]) * bs + s1 + r];
      }
      // columns i = 2p (from thread 0 of the pair) and 2p + 1 (thread 1),
      // then the updates k > i; after the pair p both threads' w[0] is
      // final and the arrays shift down one, so the column always sits in
      // w[0] (the p loop stays rolled: fully unrolled, the compiler hoists
      // every G load and spills; an index by p would put w in local memory)
#pragma unroll 1
      for (int p = 0; p < kStrip / 2; ++p) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * p + e;
          if (i == kStrip - 1) break;
          float2 wi;
          wi.x = __shfl_sync(0xffffffffu, w[0].x, (wl & ~1) | e);
          wi.y = __shfl_sync(0xffffffffu, w[0].y, (wl & ~1) | e);
#pragma unroll
          for (int q = 0; q < kStrip / 2; ++q) {
            const int k = 2 * (p + q) + h;         // w[q] is column k
            if (k > i && k < kStrip) w[q] = sub_mul(w[q], wi, s_G[i][k]);
          }
        }
        s_W[(2 * p + h) * ldw + r] = w[0];
#pragma unroll
        for (int q = 0; q + 1 < kStrip / 2; ++q) w[q] = w[q + 1];
      }
    }
    sync_all();                    // every CTA has read U: W may replace it
    PHASE(4)

    // ---- the trailing update.  Each owned on-chip lane stores the
    // strip's columns (16-byte stores: S = 32 here), and the pivot lanes
    // take W into their later columns (the CTA writes each owned pivot
    // lane's row of W, coalesced) ----
    for (int l = tid; l < nc; l += kThreads) {
      if (s_av[l] == kUsed) continue;
      float4* g = reinterpret_cast<float4*>(row(l) + s0);
#pragma unroll
      for (int r = 0; r < kStrip; r += 2) {
        const float2 a = s_strip[r * wc + l], b = s_strip[(r + 1) * wc + l];
        g[r / 2] = make_float4(a.x, a.y, b.x, b.y);
      }
    }
    for (int e = tid; e < S * rest; e += kThreads) {
      const int k = e / rest, r = e - k * rest;
      const int lk = s_piv[k] - L0;
      if (lk >= 0 && lk < nl) row(lk)[s1 + r] = s_W[k * ldw + r];
    }
    // the available lanes: on-chip lanes in pairs (2l, 2l + 1), the two
    // halves of the CTA taking alternate column groups; lanes in device
    // memory one a thread.  Every later column, the next strip's too, is
    // written back in place (the update reads only L and W in shared
    // memory, and L may be overwritten only after every thread is done)
    const int npair = (nc + 1) & ~1;            // threads of the pairs
    for (int t = tid; t < npair + 2 * (nl - nc); t += kThreads) {
      const int half = t & 1;
      int l0, l1, Ls;
      const float2 *L0p, *L1p;
      if (t < npair) {                          // an on-chip pair
        l0 = t & ~1;
        l1 = min(l0 + 1, nc - 1);
        L0p = s_strip + l0;
        L1p = s_strip + l1;
        Ls = wc;
      } else {                                  // a lane in device memory
        l0 = l1 = nc + ((t - npair) >> 1);
        L0p = L1p = row(l0) + s0;
        Ls = 1;
      }
      const bool st0 = s_av[l0] == kAvail;
      const bool st1 = l1 != l0 && s_av[l1] == kAvail;
      if (!st0 && !st1) continue;
      float2* x0 = row(l0) + s1;
      float2* x1 = row(l1) + s1;
      for (int r0 = half * kGroup; r0 < rest; r0 += 2 * kGroup) {
        trail_group(x0 + r0, x1 + r0, L0p, L1p, Ls, s_W + r0, ldw, st0, st1);
      }
    }
    __syncthreads();
    // the next strip's columns into shared memory (the look-ahead); the
    // pivot lanes leave for good
    for (int l = tid; l < nl; l += kThreads) {
      const unsigned char st = s_av[l];
      if (st == kAvail && l < wc) {
        const float2* g = row(l) + s1;
        for (int r = 0; r < S; ++r) s_strip[r * wc + l] = g[r];
      } else if (st != kAvail) {
        s_av[l] = kUsed;
      }
    }
    PHASE(5)
  }
  cluster.sync();                  // no CTA leaves while another reads it
  PHASE(6)
  PHASE_END
}

struct Config {
  int ncta, W, wc;
  size_t smem;
};

// The cluster size aims at one wave of CTAs, one per SM: sms / batch CTAs
// per panel (1 to 8), doubled (up to 8) until each CTA's strip fits shared
// memory beside W; at 8 CTAs the lanes that do not fit stay in device
// memory.  (Clusters of 8 tile the card's GPCs better than 5 to 7: at
// (64, 4096, 256) 7 CTAs a panel took 5.8x the m = 1024 time.)
bool pick_config(int m, int bs, int batch, int sms, Config* cfg) {
  const int S = std::min(bs, kStrip);
  const size_t wbytes = static_cast<size_t>(S) * (bs - S) * sizeof(float2);
  const size_t lane = static_cast<size_t>(S) * sizeof(float2);
  const int want = std::min(kMaxCluster, std::max(1, sms / std::max(batch, 1)));
  for (int ncta = want; ncta <= kMaxCluster;
       ncta = ncta == kMaxCluster ? ncta + 1 : std::min(2 * ncta, kMaxCluster)) {
    const int W = (m + ncta - 1) / ncta;
    if (wbytes + W > kSmemBudget) continue;
    const size_t fit = (kSmemBudget - wbytes - W) / lane;
    const int wc = fit < static_cast<size_t>(W) ? static_cast<int>(fit) : W;
    if (wc == W || ncta == kMaxCluster) {
      *cfg = {ncta, W, wc, wbytes + wc * lane + W};
      return true;
    }
  }
  return false;
}

bool takes(int m, int bs) {
  const int S = std::min(bs, kStrip);
  return bs >= 1 && bs <= kMaxBs && m >= bs && bs % S == 0;
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

}  // namespace

// panel: (batch, m, bs) complex64 (float2), row-major, factored in place.
// avail: (batch, m) bool (one byte per lane), written: the lanes that are
//        no pivot.
// piv:   (batch, bs) int32, written: the pivot lanes in elimination order.
extern "C" int gaunegf_panel_fused_c64(void* panel, void* avail, void* piv,
                                       int batch, int m, int bs,
                                       void* stream) {
  if (batch < 0 || !takes(m, bs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaGetLastError());
  Config cfg;
  if (!pick_config(m, bs, batch, sms, &cfg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      panel_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  err = cudaLaunchKernelEx(&lc, panel_fused_kernel, static_cast<float2*>(panel),
                           static_cast<unsigned char*>(avail),
                           static_cast<int*>(piv), m, bs, std::min(bs, kStrip),
                           cfg.W, cfg.wc);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// CTAs per cluster, lanes per CTA and lanes held on chip per CTA for a
// batch of (m, bs) panels on the current device: written to out[0..2];
// returns 0, or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int gaunegf_panel_fused_config(int m, int bs, int batch, int* out) {
  Config cfg;
  const int sms = sm_count();
  if (batch < 1 || sms == 0 || !takes(m, bs) ||
      !pick_config(m, bs, batch, sms, &cfg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = cfg.ncta;
  out[1] = cfg.W;
  out[2] = cfg.wc;
  return 0;
}

#ifdef GAUNEGF_PHASE_CLOCKS
// The phase timers' cycle sums (8 values) into out, then zeroed.
extern "C" int gaunegf_panel_fused_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_clk, sizeof(g_phase_clk));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_clk, zero, sizeof(zero)));
}
#endif
