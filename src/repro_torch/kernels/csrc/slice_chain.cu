// A whole GPHP slice-sampling chain in one launch: every log-density
// evaluation, its gram, Cholesky factor and solve, and every stepping-out
// and shrink decision of the chain, on a cluster of W blocks that evaluate
// the chain's predetermined points side by side.
//
// Replaces the TPU route src/repro/core/gp/fit.py::mcmc_gphps with
// backend="pallas": src/repro/kernels/matern52/kernel.py::matern52_gram_pallas
// called inside the jitted lax.fori_loop chain of
// src/repro/core/gp/slice_sampler.py (one gram, Cholesky and cho_solve per
// evaluation, the branches decided on the device).
//
// What bounds it: the chain's decisions are serial, and each evaluation's
// factor is m dependent pivot steps (the main path's m ≤ 64), each a rank-1
// update of the trailing block that the next pivot waits for: latency, not
// bytes or operations. The card-wide bound (all SMs, HBM) is far below what
// one chain can reach.
//
// What the design does about it. The chain's points are not serial, only
// its decisions: g decides where each sequence stops, never which points it
// holds. Stepping out visits lo₀ − k·w and hi₀ + k·w; once the bracket is
// fixed, the shrink proposals t₁…t₃₂ are fixed too (a rejected t moves lo
// when t < 0 and hi otherwise, whatever g was), from the host-made draws.
// So each round evaluates up to W of these points at once, one a block of a
// thread-block cluster (W ≤ 16, one block an SM, each with its factor in
// its own shared memory): the next kDepth stepping-out points of each side
// still open, and the shrink proposals of every bracket those points can
// end on (or of the known bracket), dealt out one a bracket in turn. Thread
// 0 of every block plans the round and decides it from the same values, so
// the blocks stay in step; the values go to every block's shared memory
// through distributed shared memory, one cluster barrier a round. Stepping
// out stops on each side at its first g ≤ log_y, the shrink takes the first
// t with g > log_y (or stays put after max_shrink), exactly as the chain
// does one point at a time. g(0) is carried: it is the value at the point
// the last update accepted (the same bits: z and that point are both
// z + t·dir, rounded alike), or at the same z after an exhausted shrink; it
// is evaluated only at update 0. The counts and the trace are the
// sequential chain's own — its logical evaluations, g(0) included, in its
// order; the points a round evaluated and threw away, and the rounds, are
// counted apart (after the four counts).
//
// One evaluation, in its block of 256 threads: the warped rows (type T), the
// live block of the masked gram and its f64 factor in shared memory (up to
// 128 rows; beyond that in a global workspace of the block's own, which
// stays in L2), so nothing but the draw table is read from device memory
// and nothing but the kept samples is written. Masked rows are identity
// rows of the masked gram and are left out of the factor (exactly: they
// decouple). y rides along as an extra row of the factor, so the forward
// solve L⁻¹y falls out of the factorization with no serial triangular
// solve. The factor goes kPanel pivots at a time, two barriers a panel: a
// panel reads its kPanel columns from buffers the previous panel filled as
// it updated them; every thread factors the panel's small top block itself
// (no barrier for it); each row's panel values go to shared memory, one row
// a thread; then the rank-kPanel update (a_ij −= Σ a_iu·a_ju / a_uu, L never
// stored) fills the other buffers with the next panel's columns. The gram
// and the update run on a 16 × 16 thread grid. The pivots and y's entries
// are recorded as they pass; the logs and the quadratic form are summed on
// warp 0 at the end.
//
// The draws come from the host (repro_torch.core.gp.slice_sampler
// .chain_draws): none depends on the chain's state. The host arithmetic the
// chain repeats (z + t·direction, max(lo, u·(hi − lo) + lo), t ± w, −w·r) is
// written with __dmul_rn / __dadd_rn, which nvcc does not contract into FMAs,
// so the kernel rounds as numpy does and visits the host chain's points.
//
// Gram type T: float for fit_backend="kernel" (the arithmetic and order of
// matern52.cu's gram kernel, through repro::gram_entry, on parameters
// packed as kernels/matern52/ops.py packs them: the same gram bits); double
// for fit_backend="torch" (the difference form of core/gp/kernels.py
// ::matern52_ard, rounded in its own order). The masked matrix, its factor
// and the log density are f64 (core/gp/gp.py::log_marginal_likelihood). A
// non-positive pivot gives a NaN log density, as a failed Cholesky does
// (gp.py::cholesky); NaN compares false, so the chain reads it as outside
// the slice.
//
// Table (f64, built by kernels/slice_chain/plain.py::pack_table):
//   lower, upper, center, prior_std (4 × D) | z0 (D) | directions (T × D) |
//   levels (T) | offsets (T) | shrink unit draws (T × max_shrink)
// with D = 3d + 2. Output (f64): the kept samples (kept × D), then the
// counts [evaluations, NaN log densities, exhausted shrinks, evaluations in
// the box] of the sequential chain, then [evaluations made, rounds]. With a
// trace pointer, (update, g) for every evaluation of the sequential chain.
// Every entry point returns cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <math.h>

#include "matern52_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 16;  // the factor's update runs on a kGrid × kGrid thread grid
static_assert(kGrid * kGrid == kThreads, "one thread per grid cell");
constexpr int kPanel = 4;  // pivots per barrier of the factor
constexpr double kLog2Pi = 1.8378770664093453;
constexpr double kJitter = 1e-8;
constexpr int kMaxWidth = 16;  // blocks a cluster: evaluations a round
constexpr int kDepth = 2;      // stepping-out points a round takes from each open side
constexpr int kMaxCand = kDepth * kDepth;  // brackets a round's shrink slots may assume

struct Chain {
  const double* x;             // (n, d) inputs, bucket-padded
  const double* y;             // (n,) standardized targets
  const unsigned char* mask;   // (n,) live rows
  const double* table;         // the draw table (see the note above)
  double* out;                 // kept × D samples, then the counts
  double* trace;               // (evaluations, 2) or null
  double* ws;                  // W factors and rows in device memory, or null
  int n, d, T, burn_in, thin, kept, max_stepout, max_shrink;
  double step;
};

// A round's slots: what each block evaluates, and what the value decides.
enum SlotKind : int { kG0 = 0, kLeft = 1, kRight = 2, kShrink = 3 };  // kShrink + bracket

struct Plan {
  double t[kMaxWidth];  // the point z + t·direction
  int kind[kMaxWidth];
  int count;            // slots used this round (≤ W)
  int done;             // the update is decided
  double t_fin;         // its step along the direction
};

// The chain's state, kept by thread 0 of every block alike.
struct Sched {
  double g0, log_y;
  double pt[2];           // each side's next stepping-out point (its bracket end once stopped)
  int k[2];               // points each side has stepped past
  int open[2];            // the side may step out further
  int nside[2], nshr;     // logged values of each side and of the shrink
  int real;               // the bracket is known: lo, hi, j are the shrink's own
  double lo, hi;
  int j;
  int cand_k[kMaxCand][2];  // the stops each bracket of this round's shrink slots assumes (−1: none)
  int g0_known;
  double evals, nans, exhausted, boxed, made, rounds;
  long long e;            // trace rows written
};

__host__ __device__ inline size_t round8(size_t bytes) { return (bytes + 7) & ~size_t(7); }
__host__ __device__ inline int lda_of(int n) { return n | 1; }  // odd: no bank conflicts

// The small arrays, in bytes: the schedule (Plan, Sched, two rounds of W
// values, each side's and the shrink's logged values), box (4D), z, dir, p
// (D each), y of the live rows (n), two sets of kPanel raw column buffers
// and the panel's values and scaled values (kPanel × (n + 1) each), the
// pivots and y's entries as the factor passes them (n each), the update's
// shrink draws, level and offset (max_shrink + 2), four result slots, the
// packed gram parameters
// (4d + 1 of T), the live-row list (n + 1).
__host__ __device__ inline size_t sched_bytes(int max_stepout, int max_shrink) {
  return round8(sizeof(Plan)) + round8(sizeof(Sched))
         + 8 * (size_t)(2 * kMaxWidth + 2 * max_stepout + max_shrink);
}

__host__ __device__ inline size_t small_bytes(int n, int d, int max_stepout, int max_shrink,
                                              int tsize) {
  const int D = 3 * d + 2;
  return sched_bytes(max_stepout, max_shrink)
         + 8 * (size_t)(7 * D + 3 * n + 4 * kPanel * (n + 1) + max_shrink + 6)
         + round8((size_t)(4 * d + 1) * tsize) + round8(4 * (size_t)(n + 1));
}

// The factor ((n + 1) × lda f64: n rows and y) and the warped rows (n × ldr T).
__host__ __device__ inline size_t big_bytes(int n, int d, int tsize) {
  return 8 * (size_t)(n + 1) * lda_of(n) + round8((size_t)n * repro::odd_stride(d) * tsize);
}

template <typename T>
struct Smem {
  Plan* plan;
  Sched* sc;
  double *gv, *gside, *gshr;
  double *box, *z, *dir, *p, *yl, *pan[2], *pv, *pb, *piv, *wy, *shrink, *red;  // shrink: + level, offset
  T* par;
  int* live;
  double* A;
  T* rows;
  int lda, ldr;
};

template <typename T>
__device__ Smem<T> carve(unsigned char* smem, double* ws, int n, int d, int max_stepout,
                         int max_shrink) {
  const int D = 3 * d + 2;
  Smem<T> s;
  s.plan = reinterpret_cast<Plan*>(smem);
  s.sc = reinterpret_cast<Sched*>(smem + round8(sizeof(Plan)));
  double* f = reinterpret_cast<double*>(smem + round8(sizeof(Plan)) + round8(sizeof(Sched)));
  s.gv = f;                        // [2][kMaxWidth]: a round's values, by round parity
  s.gside = s.gv + 2 * kMaxWidth;  // [2][max_stepout]
  s.gshr = s.gside + 2 * max_stepout;
  s.box = s.gshr + max_shrink;
  s.z = s.box + 4 * D;
  s.dir = s.z + D;
  s.p = s.dir + D;
  s.yl = s.p + D;
  s.pan[0] = s.yl + n;
  s.pan[1] = s.pan[0] + kPanel * (n + 1);
  s.pv = s.pan[1] + kPanel * (n + 1);
  s.pb = s.pv + kPanel * (n + 1);
  s.piv = s.pb + kPanel * (n + 1);
  s.wy = s.piv + n;
  s.shrink = s.wy + n;
  s.red = s.shrink + max_shrink + 2;
  unsigned char* b = reinterpret_cast<unsigned char*>(s.red + 4);
  s.par = reinterpret_cast<T*>(b);
  b += round8((size_t)(4 * d + 1) * sizeof(T));
  s.live = reinterpret_cast<int*>(b);
  b += round8(4 * (size_t)(n + 1));
  s.lda = lda_of(n);
  s.ldr = repro::odd_stride(d);
  s.A = ws != nullptr ? ws : reinterpret_cast<double*>(b);
  s.rows = reinterpret_cast<T*>(s.A + (size_t)(n + 1) * s.lda);
  return s;
}

// A panel of bb ≤ kPanel pivots k..k+bb−1 of the factor, held without L:
// for a row x, its panel values a'_x,u = P[u][x] − Σ_{s<u} a'_x,s·m[u][s]
// (the entries of columns k..k+bb−1 after the panel's earlier pivots), with
// multipliers m[u][s] = a'_{k+u},s / piv_s and piv_u = a'_{k+u},u. Every
// thread factors the panel's top bb × bb block itself (the same operations,
// so the same values), so the top block costs no barrier.
struct Panel {
  double r[kPanel];           // 1 / piv_u
  double m[kPanel][kPanel];   // m[u][s], s < u
};

__device__ __forceinline__ void panel_row(const double* __restrict__ P, int ld, int x,
                                          int bb, const Panel& t, double a[kPanel]) {
#pragma unroll
  for (int u = 0; u < kPanel; ++u) {
    if (u < bb) {
      double v = P[u * ld + x];
#pragma unroll
      for (int q = 0; q < u; ++q) v -= a[q] * t.m[u][q];
      a[u] = v;
    }
  }
}

// Factor the panel's top block into t; false if a pivot is not positive.
__device__ __forceinline__ bool panel_top(const double* __restrict__ P, int ld, int k,
                                          int bb, Panel& t, double piv[kPanel]) {
#pragma unroll
  for (int u = 0; u < kPanel; ++u) {
    if (u < bb) {
      double a[kPanel];
#pragma unroll
      for (int q = 0; q < u; ++q) {
        double v = P[q * ld + k + u];
#pragma unroll
        for (int w = 0; w < q; ++w) v -= a[w] * t.m[q][w];
        a[q] = v;
        t.m[u][q] = v * t.r[q];
      }
      double v = P[u * ld + k + u];
#pragma unroll
      for (int q = 0; q < u; ++q) v -= a[q] * t.m[u][q];
      if (!(v > 0.0)) return false;  // not positive definite
      piv[u] = v;
      t.r[u] = __drcp_rn(v);
    }
  }
  return true;
}

// Phase 1 of a panel: each row x ≥ k's panel values a'_x,u into pv and
// a'_x,u / piv_u into pb (row x at [u * ld + x]), one row a thread; y's
// (row m) also into wy[k + u].
__device__ __forceinline__ void panel_values(const double* __restrict__ P,
                                             double* __restrict__ pv,
                                             double* __restrict__ pb,
                                             double* __restrict__ wy, int ld, int k,
                                             int bb, int m, const Panel& t) {
  for (int x = k + threadIdx.x; x <= m; x += kThreads) {
    double a[kPanel];
    panel_row(P, ld, x, bb, t, a);
#pragma unroll
    for (int u = 0; u < kPanel; ++u) {
      if (u < bb) {
        pv[u * ld + x] = a[u];
        pb[u * ld + x] = a[u] * t.r[u];
        if (x == m) wy[k + u] = a[u];
      }
    }
  }
}

// Phase 2: the panel's rank-bb update of the trailing block, a_ij −=
// Σ_u a'_i,u·a'_j,u / piv_u for k + bb ≤ j ≤ i (j < m on y's row m).
// Thread (ty, tx) of the grid takes columns tx, tx + 16, … and rows ty,
// ty + 16, … of the block, and writes the next panel's columns (raw,
// through this panel) to `next`.
__device__ __forceinline__ void panel_update(double* __restrict__ A, int lda,
                                             const double* __restrict__ pv,
                                             const double* __restrict__ pb,
                                             double* __restrict__ next, int ld, int k,
                                             int bb, int m) {
  const int ty = threadIdx.x / kGrid;
  const int tx = threadIdx.x % kGrid;
  const int k1 = k + bb;
  for (int j = k1 + tx; j < m; j += kGrid) {
    double bj[kPanel];
#pragma unroll
    for (int u = 0; u < kPanel; ++u) bj[u] = u < bb ? pb[u * ld + j] : 0.0;
    int i = k1 + ty;
    if (i < j) i += (j - i + kGrid - 1) / kGrid * kGrid;
#pragma unroll 4  // independent entries in flight: shorter latency, the same bits
    for (; i <= m; i += kGrid) {
      double* a = A + (size_t)i * lda + j;
      double v = *a;
#pragma unroll
      for (int u = 0; u < kPanel; ++u) {
        if (u < bb) v -= pv[u * ld + i] * bj[u];
      }
      *a = v;
      if (j < k1 + kPanel) next[(j - k1) * ld + i] = v;
    }
  }
}

// The log posterior density at the point s.p, as fit.py's host target
// computes it: −inf outside the box; else the Gaussian prior plus the log
// marginal likelihood of the live rows. Called by every thread of a block;
// returns the same value in every thread.
template <typename T>
__device__ double log_density(const Chain& c, const Smem<T>& s, int m) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = c.d;
  const int D = 3 * d + 2;

  // the box test and the prior's sum on warp 0 (red[1] = 1 inside, red[2] =
  // Σ ((p − center) / prior_std)²), while the others pack the parameters
  if (warp == 0) {
    bool inside = true;
    double q = 0.0;
    for (int k = lane; k < D; k += 32) {
      const double v = s.p[k];
      inside = inside && v >= s.box[k] && v <= s.box[D + k];
      const double u = (v - s.box[2 * D + k]) / s.box[3 * D + k];
      q += u * u;
    }
    inside = __all_sync(0xffffffffu, inside);
    for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    if (lane == 0) {
      s.red[1] = inside ? 1.0 : 0.0;
      s.red[2] = q;
    }
  }
  const double noise = exp(2.0 * s.p[d + 1]) + kJitter;

  // the gram's parameters, packed as kernels/matern52/ops.py packs them
  for (int k = tid; k < d; k += kThreads) {
    const double la = s.p[d + 2 + k];
    const double lb = s.p[2 * d + 2 + k];
    s.par[k] = repro::f_exp(-T(s.p[k]));
    s.par[d + k] = repro::f_exp(T(la));
    s.par[2 * d + k] = repro::f_exp(T(lb));
    s.par[3 * d + k] = (fabs(la) < 1e-7 && fabs(lb) < 1e-7) ? T(0) : T(1);
  }
  if (tid == 0) s.par[4 * d] = repro::f_exp(T(2) * T(s.p[d]));
  __syncthreads();
  if (s.red[1] == 0.0) return -INFINITY;  // outside the box: no gram

  // warped, scaled live rows
  for (int e = tid; e < m * d; e += kThreads) {
    const int r = e / d;
    const int k = e - r * d;
    s.rows[r * s.ldr + k] = repro::warp_scale(
        T(c.x[(size_t)s.live[r] * d + k]), s.par[d + k], s.par[2 * d + k],
        s.par[3 * d + k], s.par[k]);
  }
  __syncthreads();

  // lower triangle of the live block of the masked gram (noise on the
  // diagonal), and y below it as row m, on the 16 × 16 thread grid (rows
  // ty, ty + 16, …; columns tx, tx + 16, … up to the diagonal)
  const T amp2 = s.par[4 * d];
  for (int i = tid / kGrid; i <= m; i += kGrid) {
    double* Ai = s.A + (size_t)i * s.lda;
    const T* ri = s.rows + (size_t)i * s.ldr;
    const int jmax = i < m ? i : m - 1;
    for (int j = tid % kGrid; j <= jmax; j += kGrid) {
      double a;
      if (i == m) {
        a = s.yl[j];
      } else {
        const double kv = (double)repro::gram_entry(ri, s.rows + (size_t)j * s.ldr, d, amp2);
        a = j == i ? kv + noise : kv;
      }
      Ai[j] = a;
      if (j < kPanel) s.pan[0][j * (c.n + 1) + i] = a;
    }
  }
  __syncthreads();

  // right-looking Cholesky of the (m + 1)-row block in panels of kPanel
  // pivots: rows 0..m−1 give L, row m gives w = L⁻¹y. Pivot k is L_kk², and
  // y's entry at pivot k is w_k·L_kk; thread 0 records both as they pass.
  const int ld = c.n + 1;
  for (int k = 0, p = 0; k < m; k += kPanel, p ^= 1) {
    const int bb = min(kPanel, m - k);
    Panel t;
    double piv[kPanel];
    if (!panel_top(s.pan[p], ld, k, bb, t, piv)) return NAN;  // XLA's NaN factor
    if (tid == 0) {
#pragma unroll
      for (int u = 0; u < kPanel; ++u) {
        if (u < bb) s.piv[k + u] = piv[u];
      }
    }
    panel_values(s.pan[p], s.pv, s.pb, s.wy, ld, k, bb, m, t);
    __syncthreads();
    panel_update(s.A, s.lda, s.pv, s.pb, s.pan[p ^ 1], ld, k, bb, m);
    __syncthreads();
  }

  // logdet = Σ log L_kk² and quad = ‖w‖² = Σ wy_k² / L_kk², on warp 0
  if (warp == 0) {
    double logdet = 0.0;
    double quad = 0.0;
    for (int k = lane; k < m; k += 32) {
      logdet += log(s.piv[k]);
      quad += s.wy[k] * s.wy[k] / s.piv[k];
    }
    for (int o = 16; o > 0; o >>= 1) {
      logdet += __shfl_xor_sync(0xffffffffu, logdet, o);
      quad += __shfl_xor_sync(0xffffffffu, quad, o);
    }
    if (lane == 0) {
      s.red[0] = -0.5 * (quad + logdet + (double)m * kLog2Pi) - 0.5 * s.red[2];
    }
  }
  __syncthreads();
  return s.red[0];
}

// ---------------------------------------------------------------- schedule
// Thread 0 of every block runs these on the same values, so every block
// holds the same plan and state. The arithmetic is the sequential chain's
// (slice_sampler.py::_one_direction_update), one rounding an operation. The
// state lives in shared memory between rounds; each function reads what it
// needs into registers and writes back what changed.

// The next point a side would step to from t: t − w on the left, t + w on
// the right.
__device__ __forceinline__ double step_from(double t, int side, double w) {
  return __dadd_rn(t, side ? w : -w);
}

// np.maximum(lo, u·(hi − lo) + lo): the shrink's proposal of unit draw u.
__device__ __forceinline__ double shrink_point(double u, double lo, double hi) {
  const double x = __dadd_rn(__dmul_rn(u, __dsub_rn(hi, lo)), lo);
  return lo >= x ? lo : x;
}

// Start update `it`: the bracket's first points, both sides open (unless
// stepping out is off), no shrink state.
__device__ __noinline__ void begin_update(Sched* __restrict__ sc, const Chain& c,
                                          double level, double offset) {
  const double lo = __dmul_rn(-c.step, offset);
  sc->pt[0] = lo;
  sc->pt[1] = __dadd_rn(lo, c.step);
  if (sc->g0_known) sc->log_y = __dsub_rn(sc->g0, level);
  const int open = c.max_stepout > 0;
  sc->k[0] = sc->k[1] = 0;
  sc->open[0] = sc->open[1] = open;
  sc->nside[0] = sc->nside[1] = 0;
  sc->nshr = 0;
  sc->real = 0;
  sc->j = 0;
}

// Plan a round of up to W slots: g(0) if unknown; the next kDepth points of
// each open side; then the shrink proposals of each bracket those points
// can end on (or of the known bracket), one a bracket in turn. Bracket q =
// a·kDepth + b ends on the left side's a-th point of the round and the right
// side's b-th (a side already stopped has only its stop, a = 0).
__device__ __noinline__ void plan_round(Sched* __restrict__ sc, Plan* __restrict__ pl,
                                        const double* __restrict__ us, int max_stepout,
                                        int max_shrink, double w, int W) {
  int n = 0;
  if (!sc->g0_known) {
    pl->t[0] = 0.0;
    pl->kind[0] = kG0;
    n = 1;
  }
  double stop_t[2][kDepth];
  int stop_k[2][kDepth];
  int stops[2];
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const double pt = sc->pt[side];
    const int k = sc->k[side];
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      stop_t[side][i] = pt;
      stop_k[side][i] = k;
    }
    if (!sc->open[side]) {
      stops[side] = 1;
      continue;
    }
    const int a = min(min(kDepth, max_stepout - k), W - n);
    double t = pt;
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      if (i < a) {
        pl->t[n + i] = t;
        pl->kind[n + i] = kLeft + side;
        stop_t[side][i] = t;
        stop_k[side][i] = k + i;
        t = step_from(t, side, w);
      }
    }
    n += a;
    stops[side] = a;
  }
  double lo[kMaxCand], hi[kMaxCand];
  int j[kMaxCand];
  bool valid[kMaxCand];
  const bool real = sc->real;
#pragma unroll
  for (int q = 0; q < kMaxCand; ++q) {
    const int a = q / kDepth, b = q % kDepth;
    valid[q] = real ? q == 0 : (a < stops[0] && b < stops[1]);
    lo[q] = real ? sc->lo : stop_t[0][a];
    hi[q] = real ? sc->hi : stop_t[1][b];
    j[q] = real ? sc->j : 0;
    sc->cand_k[q][0] = valid[q] ? stop_k[0][a] : -1;
    sc->cand_k[q][1] = valid[q] ? stop_k[1][b] : -1;
  }
  for (bool any = true; any && n < W;) {
    any = false;
#pragma unroll
    for (int q = 0; q < kMaxCand; ++q) {
      if (valid[q] && n < W && j[q] < max_shrink) {
        // a rejected proposal moves lo or hi by its sign, whatever g was
        const double t = shrink_point(us[j[q]], lo[q], hi[q]);
        pl->t[n] = t;
        pl->kind[n] = kShrink + q;
        ++n;
        if (t < 0.0) {
          lo[q] = t;
        } else {
          hi[q] = t;
        }
        ++j[q];
        any = true;
      }
    }
  }
  pl->count = n;
}

// One side's stepping-out value: past its stop it is thrown away; else it
// is logged, and the side steps past it (g > log_y) or stops at it.
__device__ __forceinline__ void side_value(double v, double log_y, int side, double w,
                                           int max_stepout, int& k, int& open, int& nside,
                                           double& pt, double* __restrict__ logged) {
  if (!open) return;
  logged[nside++] = v;
  if (v > log_y) {
    ++k;
    pt = step_from(pt, side, w);
    open = k < max_stepout;
  } else {
    open = 0;
  }
}

// Read a round's values in the sequential chain's order; true once the
// update is decided (pl->t_fin set, its logical evaluations counted and, on
// rank 0, traced).
__device__ __noinline__ bool decide_round(Sched* __restrict__ sc, Plan* __restrict__ pl,
                                          const double* __restrict__ gv,
                                          double* __restrict__ gside,
                                          double* __restrict__ gshr, const Chain& c, int it,
                                          double level, bool writer) {
  const int count = pl->count;
  const int ms = c.max_stepout;
  double g0 = sc->g0, log_y = sc->log_y;
  int k0 = sc->k[0], k1 = sc->k[1], open0 = sc->open[0], open1 = sc->open[1];
  int ns0 = sc->nside[0], ns1 = sc->nside[1];
  double pt0 = sc->pt[0], pt1 = sc->pt[1];
  for (int r = 0; r < count; ++r) {
    const int kind = pl->kind[r];
    const double v = gv[r];
    if (kind == kG0) {
      g0 = v;
      log_y = __dsub_rn(v, level);
    } else if (kind == kLeft) {
      side_value(v, log_y, 0, c.step, ms, k0, open0, ns0, pt0, gside);
    } else if (kind == kRight) {
      side_value(v, log_y, 1, c.step, ms, k1, open1, ns1, pt1, gside + ms);
    }
  }
  sc->g0 = g0;
  sc->log_y = log_y;
  sc->g0_known = 1;
  sc->k[0] = k0;
  sc->k[1] = k1;
  sc->open[0] = open0;
  sc->open[1] = open1;
  sc->nside[0] = ns0;
  sc->nside[1] = ns1;
  sc->pt[0] = pt0;
  sc->pt[1] = pt1;
  sc->made += count;
  sc->rounds += 1.0;
  if (open0 || open1) return false;

  // both sides stopped: the bracket is (pt0, pt1); the shrink slots that
  // assumed it hold, the others are thrown away
  double lo = pt0, hi = pt1;
  int j = 0, want = -1;
  if (sc->real) {
    lo = sc->lo;
    hi = sc->hi;
    j = sc->j;
    want = 0;
  } else {
#pragma unroll
    for (int q = 0; q < kMaxCand; ++q) {
      if (sc->cand_k[q][0] == k0 && sc->cand_k[q][1] == k1) want = q;
    }
  }
  int nshr = sc->nshr;
  bool accepted = false;
  double t_acc = 0.0;
  for (int r = 0; r < count && j < c.max_shrink && want >= 0; ++r) {
    if (pl->kind[r] != kShrink + want) continue;
    const double t = pl->t[r];
    const double v = gv[r];
    gshr[nshr++] = v;
    ++j;
    if (v > log_y) {
      accepted = true;
      t_acc = t;
      break;
    }
    if (t < 0.0) {
      lo = t;
    } else {
      hi = t;
    }
  }
  sc->real = 1;
  sc->lo = lo;
  sc->hi = hi;
  sc->j = j;
  sc->nshr = nshr;
  if (!accepted && j < c.max_shrink) return false;

  // decided: the update's logical evaluations, in the chain's order
  double evals = sc->evals, nans = sc->nans, boxed = sc->boxed;
  long long e = sc->e;
  auto logical = [&](double v) {
    evals += 1.0;
    nans += v != v ? 1.0 : 0.0;
    boxed += v != -INFINITY ? 1.0 : 0.0;
    if (writer && c.trace != nullptr) {
      c.trace[2 * e] = (double)it;
      c.trace[2 * e + 1] = v;
    }
    ++e;
  };
  logical(g0);
  for (int i = 0; i < ns0; ++i) logical(gside[i]);
  for (int i = 0; i < ns1; ++i) logical(gside[ms + i]);
  for (int i = 0; i < nshr; ++i) logical(gshr[i]);
  sc->evals = evals;
  sc->nans = nans;
  sc->boxed = boxed;
  sc->e = e;
  if (accepted) {
    sc->g0 = gshr[nshr - 1];  // g(0) of the next update: the same point's value
  } else {
    sc->exhausted += 1.0;  // stay put: g(0) stays
  }
  pl->t_fin = accepted ? t_acc : 0.0;
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) chain_kernel(Chain c) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int W = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool writer = rank == 0;
  const int tid = threadIdx.x;
  const int D = 3 * c.d + 2;
  double* ws = c.ws == nullptr ? nullptr
                               : c.ws + (size_t)rank * (big_bytes(c.n, c.d, sizeof(T)) / 8);
  const Smem<T> s = carve<T>(smem, ws, c.n, c.d, c.max_stepout, c.max_shrink);
  Sched& sc = *s.sc;
  Plan& pl = *s.plan;

  const double* z0 = c.table + 4 * D;
  const double* dirs = z0 + D;
  const double* levels = dirs + (size_t)c.T * D;
  const double* offsets = levels + c.T;
  const double* shrink = offsets + c.T;

  for (int k = tid; k < 4 * D; k += kThreads) s.box[k] = c.table[k];
  for (int k = tid; k < D; k += kThreads) s.z[k] = z0[k];
  if (tid == 0) {
    int m = 0;
    for (int i = 0; i < c.n; ++i) {
      if (c.mask[i]) s.live[m++] = i;
    }
    s.live[c.n] = m;
    sc.g0_known = 0;
    sc.evals = sc.nans = sc.exhausted = sc.boxed = sc.made = sc.rounds = 0.0;
    sc.e = 0;
  }
  __syncthreads();
  const int m = s.live[c.n];
  for (int i = tid; i < m; i += kThreads) s.yl[i] = c.y[s.live[i]];

  int par = 0;  // which half of gv this round's values go to
  for (int it = 0; it < c.T; ++it) {
    for (int k = tid; k < D; k += kThreads) s.dir[k] = dirs[(size_t)it * D + k];
    for (int j = tid; j < c.max_shrink; j += kThreads) {
      s.shrink[j] = shrink[(size_t)it * c.max_shrink + j];
    }
    if (tid == 0) {
      s.shrink[c.max_shrink] = levels[it];
      s.shrink[c.max_shrink + 1] = offsets[it];
    }
    __syncthreads();
    const double level = s.shrink[c.max_shrink];
    if (tid == 0) {
      begin_update(&sc, c, level, s.shrink[c.max_shrink + 1]);
      plan_round(&sc, &pl, s.shrink, c.max_stepout, c.max_shrink, c.step, W);
    }
    __syncthreads();
    for (;;) {
      double v = 0.0;
      if (rank < pl.count) {
        const double t = pl.t[rank];
        for (int k = tid; k < D; k += kThreads) {
          s.p[k] = __dadd_rn(s.z[k], __dmul_rn(t, s.dir[k]));
        }
        __syncthreads();
        v = log_density<T>(c, s, m);
        // every block's copy of this slot's value
        if (tid < W) *cluster.map_shared_rank(s.gv + par * kMaxWidth + rank, tid) = v;
      }
      cluster.sync();
      if (tid == 0) {
        pl.done = decide_round(&sc, &pl, s.gv + par * kMaxWidth, s.gside, s.gshr, c, it,
                               level, writer);
        if (!pl.done) plan_round(&sc, &pl, s.shrink, c.max_stepout, c.max_shrink, c.step, W);
      }
      par ^= 1;
      __syncthreads();
      if (pl.done) break;
    }
    const double t_fin = pl.t_fin;
    for (int k = tid; k < D; k += kThreads) {
      const double zk = __dadd_rn(s.z[k], __dmul_rn(t_fin, s.dir[k]));
      s.z[k] = zk;
      if (writer) {
        for (int q = 0; q < c.kept; ++q) {
          if (min(c.burn_in + c.thin * q, c.T - 1) == it) c.out[(size_t)q * D + k] = zk;
        }
      }
    }
  }
  if (writer && tid == 0) {
    double* counts = c.out + (size_t)c.kept * D;
    counts[0] = sc.evals;
    counts[1] = sc.nans;
    counts[2] = sc.exhausted;
    counts[3] = sc.boxed;
    counts[4] = sc.made;
    counts[5] = sc.rounds;
  }
  cluster.sync();  // no block leaves while another may still write to it
}

template <typename T>
cudaError_t configure(size_t smem, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int W,
                      void* stream) {
  cudaError_t err = cudaFuncSetAttribute(chain_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(chain_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(W, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = W;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

size_t launch_smem(int n, int d, int max_stepout, int max_shrink, int tsize, bool in_smem) {
  return small_bytes(n, d, max_stepout, max_shrink, tsize) + (in_smem ? big_bytes(n, d, tsize) : 0);
}

// The widest cluster the card can place for this launch, at most kMaxWidth.
template <typename T>
int width(int n, int d, int max_stepout, int max_shrink, bool in_smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const size_t smem = launch_smem(n, d, max_stepout, max_shrink, sizeof(T), in_smem);
  if (configure<T>(smem, cfg, attr, kMaxWidth, nullptr) != cudaSuccess) return -1;
  int size = 0;
  if (cudaOccupancyMaxPotentialClusterSize(&size, chain_kernel<T>, &cfg) != cudaSuccess) return -1;
  return min(size, kMaxWidth);
}

template <typename T>
int launch(const void* x, const void* y, const void* mask, const void* table,
           void* out, void* trace, void* ws, int n, int d, int T_, int burn_in,
           int thin, int kept, int max_stepout, int max_shrink, double step,
           int W, void* stream) {
  Chain c{static_cast<const double*>(x), static_cast<const double*>(y),
          static_cast<const unsigned char*>(mask), static_cast<const double*>(table),
          static_cast<double*>(out), static_cast<double*>(trace),
          static_cast<double*>(ws), n, d, T_, burn_in, thin, kept, max_stepout,
          max_shrink, step};
  if (W < 1 || W > kMaxWidth) return (int)cudaErrorInvalidValue;
  const size_t smem = launch_smem(n, d, max_stepout, max_shrink, sizeof(T), ws == nullptr);
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = configure<T>(smem, cfg, attr, W, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, chain_kernel<T>, c);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slice_chain_f32(const void* x, const void* y, const void* mask, const void* table,
                    void* out, void* trace, void* ws, int n, int d, int T, int burn_in,
                    int thin, int kept, int max_stepout, int max_shrink, double step,
                    int width, void* stream) {
  return launch<float>(x, y, mask, table, out, trace, ws, n, d, T, burn_in, thin, kept,
                       max_stepout, max_shrink, step, width, stream);
}

int slice_chain_f64(const void* x, const void* y, const void* mask, const void* table,
                    void* out, void* trace, void* ws, int n, int d, int T, int burn_in,
                    int thin, int kept, int max_stepout, int max_shrink, double step,
                    int width, void* stream) {
  return launch<double>(x, y, mask, table, out, trace, ws, n, d, T, burn_in, thin, kept,
                        max_stepout, max_shrink, step, width, stream);
}

// Dynamic shared memory of a block: with the factor in shared memory
// (in_smem = 1) or in a workspace of slice_chain_ws_bytes a block.
long long slice_chain_smem_bytes(int n, int d, int max_stepout, int max_shrink, int tsize,
                                 int in_smem) {
  return (long long)launch_smem(n, d, max_stepout, max_shrink, tsize, in_smem != 0);
}

long long slice_chain_ws_bytes(int n, int d, int tsize) {
  return (long long)big_bytes(n, d, tsize);
}

long long slice_chain_smem_limit(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) {
    return -1;
  }
  return optin;
}

// The cluster width a launch of these sizes takes on the current card: the
// widest the card can place, at most 16; −1 if the card cannot say.
int slice_chain_width(int n, int d, int max_stepout, int max_shrink, int tsize, int in_smem) {
  return tsize == 4 ? width<float>(n, d, max_stepout, max_shrink, in_smem != 0)
                    : width<double>(n, d, max_stepout, max_shrink, in_smem != 0);
}

}  // extern "C"
