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
// Bound on the card: the roofline of a (64, 32, 1024) call is 0.010 ms
// (33.7 MB read and written once; its ~0.3 G operations take less), but
// what bounds the kernel is the latency of ROWS dependent steps, each a
// cluster-wide argmax, a broadcast of the pivot column and a rank-1 update
// (~3 us a step on the H100).
// Design: one thread-block cluster per strip.  The ncta = ceil(m / 512)
// CTAs (at most 8) of 512 threads each own a contiguous range of W lanes,
// one lane per thread, and hold their rows in shared memory (256 B per
// lane; 128 KB per CTA at m = 1024): the strip and its avail mask are
// loaded once (coalesced: a strip row is contiguous along the lanes),
// eliminated on chip for all ROWS steps, and stored once with piv.  Each
// step: a warp-shuffle argmax inside each CTA; each CTA publishes its
// candidate (partial, the lane's rows, and its reciprocal from the scan's
// |p|) in buffers that alternate by step parity; after one cluster
// barrier every CTA reads all candidates in one round of distributed
// shared-memory loads and keeps the winner's (first lane on ties); then
// each thread updates its own lane, loads before stores, in batches.
// Where W lanes of ROWS values exceed shared memory (m beyond ~7000 at 32
// rows), a CTA keeps its first lanes on chip and updates the rest in
// place in device memory.
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
constexpr int kMaxRows = 32;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kLanesPerCta = 512;
constexpr int kChunk = 8;          // rows per batch of loads in a lane step
constexpr size_t kSmemBudget = 220 * 1024;   // dynamic; static is < 1 KB

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

// 1 / p by two divisions by pm = |p| (|p| = 0 reads as 1)
__device__ __forceinline__ float2 reciprocal(float2 p, float pm) {
  if (pm == 0.f) pm = 1.f;
  return make_float2(__fdiv_rn(__fdiv_rn(p.x, pm), pm),
                     -__fdiv_rn(__fdiv_rn(p.y, pm), pm));
}

// Step j at one available lane whose rows lie at col[r * stride]: the
// multiplier l = col[j] * inv replaces col[j], and rows r > j take
// col[r] -= u[r] * l.  kChunk rows at a time: all loads, then the
// arithmetic, then the stores (register arrays indexed by unrolled
// constants only).
__device__ __forceinline__ void lane_step(float2* col, int stride,
                                          const float2* u, int j, int rows,
                                          float2 inv) {
  const float2 c = col[j * stride];
  const float lr = __fsub_rn(__fmul_rn(c.x, inv.x), __fmul_rn(c.y, inv.y));
  const float li = __fadd_rn(__fmul_rn(c.x, inv.y), __fmul_rn(c.y, inv.x));
  col[j * stride] = make_float2(lr, li);
  for (int r0 = j + 1; r0 < rows; r0 += kChunk) {
    float2 v[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (r0 + q < rows) v[q] = col[(r0 + q) * stride];
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const float2 w = u[min(r0 + q, rows - 1)];
      v[q].x = __fsub_rn(v[q].x, __fsub_rn(__fmul_rn(w.x, lr), __fmul_rn(w.y, li)));
      v[q].y = __fsub_rn(v[q].y, __fadd_rn(__fmul_rn(w.x, li), __fmul_rn(w.y, lr)));
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (r0 + q < rows) col[(r0 + q) * stride] = v[q];
    }
  }
}

// CTA `rank` of a strip's cluster owns lanes [rank * W, rank * W + nl);
// its first wc lanes live in s_strip (rows x wc), the rest stay in place
// in device memory.  Each lane is read and written by one thread only.
__global__ void __launch_bounds__(kThreads)
strip_elim_kernel(float2* __restrict__ strip, unsigned char* __restrict__ avail,
                  int* __restrict__ piv, int rows, int m, int W, int wc) {
  PHASE_START
  cg::cluster_group cluster = cg::this_cluster();
  const int ncta = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / ncta;
  float2* sb = strip + b * rows * m;
  unsigned char* av = avail + b * m;
  int* pv = piv + b * rows;
  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const int warp = tid >> 5;
  const int L0 = rank * W;
  const int nl = max(0, min(W, m - L0));
  const int nc = min(nl, wc);
  // a one-CTA cluster needs only the CTA barrier
  auto sync_all = [&]() {
    if (ncta > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };

  extern __shared__ __align__(16) unsigned char smem[];
  float2* s_strip = reinterpret_cast<float2*>(smem);
  unsigned char* s_av = smem + static_cast<size_t>(rows) * wc * sizeof(float2);
  __shared__ float s_wmag[kWarps];
  __shared__ int s_widx[kWarps];
  // this CTA's candidate, read by the cluster, by step parity
  __shared__ float s_cmag[2];
  __shared__ int s_cidx[2];
  __shared__ float2 s_cinv[2];
  __shared__ float2 s_cand[2][kMaxRows];      // the candidate lane's rows
  __shared__ float2 s_u[kMaxRows];            // the pivot column
  __shared__ float2 s_inv;
  __shared__ int s_p;
  __shared__ int s_piv[kMaxRows];

  for (int e = tid; e < rows * nc; e += kThreads) {
    const int r = e / nc, l = e % nc;
    s_strip[r * wc + l] = sb[static_cast<size_t>(r) * m + L0 + l];
  }
  for (int l = tid; l < nl; l += kThreads) s_av[l] = av[L0 + l];
  __syncthreads();
  PHASE(0)

  for (int j = 0; j < rows; ++j) {
    const int par = j & 1;
    // masked argmax; lanes are visited in ascending order, so a strict
    // comparison keeps the first of equal magnitudes
    float best = -INFINITY;
    int bidx = INT_MAX;
    for (int l = tid; l < nl; l += kThreads) {
      const float2 c = l < wc ? s_strip[j * wc + l]
                              : sb[static_cast<size_t>(j) * m + L0 + l];
      const float mag = s_av[l] ? hypot_ref(c.x, c.y) : -1.f;
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
    PHASE(1)
    // publish this CTA's candidate: its partial, its lane's rows and the
    // reciprocal (|p| is the scan's hypot of an available lane)
    if (warp == 0) {
      best = wl < kWarps ? s_wmag[wl] : -INFINITY;
      bidx = wl < kWarps ? s_widx[wl] : INT_MAX;
      warp_argmax(best, bidx);
      bidx = __shfl_sync(0xffffffffu, bidx, 0);
      if (bidx != INT_MAX) {
        const int l = bidx - L0;
        if (wl < rows) {
          s_cand[par][wl] = l < wc ? s_strip[wl * wc + l]
                                   : sb[static_cast<size_t>(wl) * m + bidx];
        }
        if (wl == 0) {
          const float2 v = l < wc ? s_strip[j * wc + l]
                                  : sb[static_cast<size_t>(j) * m + bidx];
          s_cinv[par] = reciprocal(v, best >= 0.f ? best : hypot_ref(v.x, v.y));
        }
      }
      if (wl == 0) {
        s_cmag[par] = best;
        s_cidx[par] = bidx;
      }
    }
    sync_all();                    // every CTA's candidate of step j is out
    PHASE(2)
    // combine the candidates; every CTA's rows and reciprocal are read
    // with its partial, and the winner's kept
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
        if (k < ncta && wl < rows) {
          col_k[k] = cluster.map_shared_rank(s_cand[par], k)[wl];
        }
      }
      warp_argmax(best, bidx);
      const int p = __shfl_sync(0xffffffffu, bidx, 0);
      const int o = p / W;
      const float2 inv = make_float2(__shfl_sync(0xffffffffu, inv_k.x, o),
                                     __shfl_sync(0xffffffffu, inv_k.y, o));
      if (wl < rows) {
        float2 u = col_k[0];
#pragma unroll
        for (int k = 1; k < kMaxCluster; ++k) {
          if (k == o) u = col_k[k];
        }
        s_u[wl] = u;
      }
      if (wl == 0) {
        s_inv = inv;
        s_p = p;
        s_piv[j] = p;
      }
    }
    __syncthreads();
    PHASE(3)
    // no barrier closes the step: each thread's lanes are its own, and
    // s_u, s_inv, s_p change only after the next cluster barrier
    const int p = s_p;
    const float2 inv = s_inv;
    for (int l = tid; l < nl; l += kThreads) {
      if (L0 + l == p) {
        s_av[l] = 0;
        continue;
      }
      if (!s_av[l]) continue;
      if (l < wc) {
        lane_step(s_strip + l, wc, s_u, j, rows, inv);
      } else {
        lane_step(sb + L0 + l, m, s_u, j, rows, inv);
      }
    }
    PHASE(4)
  }
  __syncthreads();

  for (int e = tid; e < rows * nc; e += kThreads) {
    const int r = e / nc, l = e % nc;
    sb[static_cast<size_t>(r) * m + L0 + l] = s_strip[r * wc + l];
  }
  for (int l = tid; l < nl; l += kThreads) av[L0 + l] = s_av[l];
  if (rank == 0 && tid < rows) pv[tid] = s_piv[tid];
  cluster.sync();                  // no CTA leaves while another reads it
  PHASE(5)
  PHASE_END
}

struct Config {
  int ncta, W, wc;
  size_t smem;
};

Config pick_config(int rows, int m) {
  Config cfg;
  cfg.ncta =
      std::min(kMaxCluster, std::max(1, (m + kLanesPerCta - 1) / kLanesPerCta));
  cfg.W = (m + cfg.ncta - 1) / cfg.ncta;
  const size_t lane = static_cast<size_t>(rows) * sizeof(float2);
  const size_t W = static_cast<size_t>(cfg.W);
  const size_t fit = W < kSmemBudget ? (kSmemBudget - W) / lane : 0;
  cfg.wc = static_cast<int>(fit < static_cast<size_t>(cfg.W) ? fit : cfg.W);
  cfg.smem = cfg.wc * lane + cfg.W;
  return cfg;
}

}  // namespace

// A strip's avail mask stays on chip: up to kSmemBudget lanes per CTA.
bool takes(int rows, int m) {
  return rows >= 1 && rows <= kMaxRows && m >= rows &&
         static_cast<size_t>(pick_config(rows, m).W) <= kSmemBudget;
}

// strip: (batch, rows, m) complex64 (float2), factored in place.
// avail: (batch, m) bool (one byte per lane), updated in place.
// piv:   (batch, rows) int32, written.
extern "C" int gaunegf_strip_elim_c64(void* strip, void* avail, void* piv,
                                      int batch, int rows, int m,
                                      void* stream) {
  if (batch < 0 || !takes(rows, m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const Config cfg = pick_config(rows, m);
  cudaError_t err = cudaFuncSetAttribute(
      strip_elim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  err = cudaLaunchKernelEx(&lc, strip_elim_kernel, static_cast<float2*>(strip),
                           static_cast<unsigned char*>(avail),
                           static_cast<int*>(piv), rows, m, cfg.W, cfg.wc);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// CTAs per cluster, lanes per CTA and lanes held on chip per CTA for a
// strip of (rows, m): written to out[0..2]; returns 0, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int gaunegf_strip_elim_config(int rows, int m, int* out) {
  if (!takes(rows, m)) return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = pick_config(rows, m);
  out[0] = cfg.ncta;
  out[1] = cfg.W;
  out[2] = cfg.wc;
  return 0;
}

#ifdef GAUNEGF_PHASE_CLOCKS
// The phase timers' cycle sums (8 values) into out, then zeroed.
extern "C" int gaunegf_strip_elim_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_clk, sizeof(g_phase_clk));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_clk, zero, sizeof(zero)));
}
#endif
