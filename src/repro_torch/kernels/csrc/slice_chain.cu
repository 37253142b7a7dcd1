// A whole GPHP slice-sampling chain in one launch: every log-density
// evaluation, its gram, Cholesky factor and solve, and every stepping-out
// and shrink decision of the chain, in one block.
//
// Replaces the TPU route src/repro/core/gp/fit.py::mcmc_gphps with
// backend="pallas": src/repro/kernels/matern52/kernel.py::matern52_gram_pallas
// called inside the jitted lax.fori_loop chain of
// src/repro/core/gp/slice_sampler.py (one gram, Cholesky and cho_solve per
// evaluation, the branches decided on the device). The port ran that loop on
// the host, one gram launch, cuSOLVER factor and read-back per evaluation.
//
// What bounds it: the chain is serial — each evaluation's point depends on
// the branch the last one took — so only one SM can work on it, at one SM's
// f64 rate, and each evaluation's factor is n dependent pivot steps (the
// main path's n ≤ 64), each a rank-1 update of the trailing block that the
// next pivot waits for. The card-wide bound (all SMs, HBM) is far below
// what one chain can reach.
//
// What the design does about it: one block of 256 threads keeps the whole
// evaluation on chip — the warped rows (type T), the live block of the masked
// gram and its f64 factor in shared memory (up to 128 rows; beyond that in a
// global workspace, which stays in L2), so nothing but the draw table is read
// from device memory and nothing but the kept samples is written. Masked
// rows are identity rows of the masked gram and are left out of the factor
// (exactly: they decouple). y rides along as an extra row of the factor, so
// the forward solve L⁻¹y falls out of the factorization with no serial
// triangular solve. The factor goes kPanel pivots at a time, two barriers
// a panel: a panel reads its kPanel columns from buffers the previous panel
// filled as it updated them; every thread factors the panel's small top
// block itself (no barrier for it); each row's panel values go to shared
// memory, one row a thread; then the rank-kPanel update (a_ij −= Σ
// a_iu·a_ju / a_uu, L never stored) fills the other buffers with the next
// panel's columns. The gram and the update run on a 16 × 16 thread grid,
// a handful of independent entries a thread. The pivots and y's entries
// are recorded as they pass; the logs and the quadratic form are summed on
// warp 0 at the end, off the pivots' serial path. A scratch comparison
// found other panel widths no faster (6 and 8 spill registers). The
// chain's control flow is uniform across the block: every thread computes
// the same scalars, so no branch needs a broadcast.
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
// the box]. With a trace pointer, (update, g) for every evaluation.
// Every entry point returns cudaGetLastError() after its launch.

#include <math.h>

#include "matern52_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGrid = 16;  // the factor's update runs on a kGrid × kGrid thread grid
static_assert(kGrid * kGrid == kThreads, "one thread per grid cell");
constexpr int kPanel = 4;  // pivots per barrier of the factor
constexpr double kLog2Pi = 1.8378770664093453;
constexpr double kJitter = 1e-8;

struct Chain {
  const double* x;             // (n, d) inputs, bucket-padded
  const double* y;             // (n,) standardized targets
  const unsigned char* mask;   // (n,) live rows
  const double* table;         // the draw table (see the note above)
  double* out;                 // kept × D samples, then the counts
  double* trace;               // (evaluations, 2) or null
  double* ws;                  // factor and rows in device memory, or null
  int n, d, T, burn_in, thin, kept, max_stepout, max_shrink;
  double step;
};

__host__ __device__ inline size_t round8(size_t bytes) { return (bytes + 7) & ~size_t(7); }
__host__ __device__ inline int lda_of(int n) { return n | 1; }  // odd: no bank conflicts

// The small arrays, in bytes: box (4D), z, dir, p (D each), y of the live
// rows (n), two sets of kPanel raw column buffers and the panel's values
// and scaled values (kPanel × (n + 1) each), the pivots and y's entries as
// the factor passes them (n each), the update's shrink draws (max_shrink),
// four result slots, the packed gram parameters (4d + 1 of T), the
// live-row list (n + 1).
__host__ __device__ inline size_t small_bytes(int n, int d, int max_shrink, int tsize) {
  const int D = 3 * d + 2;
  return 8 * (size_t)(7 * D + 3 * n + 4 * kPanel * (n + 1) + max_shrink + 4)
         + round8((size_t)(4 * d + 1) * tsize) + round8(4 * (size_t)(n + 1));
}

// The factor ((n + 1) × lda f64: n rows and y) and the warped rows (n × ldr T).
__host__ __device__ inline size_t big_bytes(int n, int d, int tsize) {
  return 8 * (size_t)(n + 1) * lda_of(n) + round8((size_t)n * repro::odd_stride(d) * tsize);
}

template <typename T>
struct Smem {
  double *box, *z, *dir, *p, *yl, *pan[2], *pv, *pb, *piv, *wy, *shrink, *red;
  T* par;
  int* live;
  double* A;
  T* rows;
  int lda, ldr;
};

template <typename T>
__device__ Smem<T> carve(unsigned char* smem, double* ws, int n, int d, int max_shrink) {
  const int D = 3 * d + 2;
  Smem<T> s;
  double* f = reinterpret_cast<double*>(smem);
  s.box = f;
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
  s.red = s.shrink + max_shrink;
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
// marginal likelihood of the live rows. Called by every thread; returns the
// same value in every thread.
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

template <typename T>
__global__ void __launch_bounds__(kThreads) chain_kernel(Chain c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int D = 3 * c.d + 2;
  const Smem<T> s = carve<T>(smem, c.ws, c.n, c.d, c.max_shrink);

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
  }
  __syncthreads();
  const int m = s.live[c.n];
  for (int i = tid; i < m; i += kThreads) s.yl[i] = c.y[s.live[i]];

  double evals = 0.0, nans = 0.0, exhausted = 0.0, boxed = 0.0;
  long long e = 0;
  for (int it = 0; it < c.T; ++it) {
    for (int k = tid; k < D; k += kThreads) s.dir[k] = dirs[(size_t)it * D + k];
    // the update's shrink draws, read after g(0)'s barriers
    for (int j = tid; j < c.max_shrink; j += kThreads) {
      s.shrink[j] = shrink[(size_t)it * c.max_shrink + j];
    }

    // g(t) = log density at z + t·direction. Thread k owns entry k of z,
    // dir and the point, so only the point's readers need the barriers.
    auto g = [&](double t) -> double {
      __syncthreads();
      for (int k = tid; k < D; k += kThreads) {
        s.p[k] = __dadd_rn(s.z[k], __dmul_rn(t, s.dir[k]));
      }
      __syncthreads();
      const double v = log_density<T>(c, s, m);
      evals += 1.0;
      nans += v != v ? 1.0 : 0.0;
      boxed += v != -INFINITY ? 1.0 : 0.0;
      if (c.trace != nullptr && tid == 0) {
        c.trace[2 * e] = (double)it;
        c.trace[2 * e + 1] = v;
      }
      ++e;
      return v;
    };

    // slice level, stepping out, shrinkage (slice_sampler.py
    // ::_one_direction_update)
    const double log_y = __dsub_rn(g(0.0), levels[it]);
    double lo = __dmul_rn(-c.step, offsets[it]);
    double hi = __dadd_rn(lo, c.step);
    for (int i = 0; i < c.max_stepout && g(lo) > log_y; ++i) lo = __dadd_rn(lo, -c.step);
    for (int i = 0; i < c.max_stepout && g(hi) > log_y; ++i) hi = __dadd_rn(hi, c.step);
    double t_new = 0.0;
    bool accepted = false;
    for (int j = 0; j < c.max_shrink; ++j) {
      const double u = s.shrink[j];
      const double x = __dadd_rn(__dmul_rn(u, __dsub_rn(hi, lo)), lo);
      t_new = lo >= x ? lo : x;  // np.maximum(lo, x)
      accepted = g(t_new) > log_y;
      if (accepted) break;
      if (t_new < 0.0) {
        lo = t_new;
      } else {
        hi = t_new;
      }
    }
    exhausted += accepted ? 0.0 : 1.0;
    const double t_fin = accepted ? t_new : 0.0;  // exhausted: stay put
    for (int k = tid; k < D; k += kThreads) {
      const double zk = __dadd_rn(s.z[k], __dmul_rn(t_fin, s.dir[k]));
      s.z[k] = zk;
      for (int q = 0; q < c.kept; ++q) {
        if (min(c.burn_in + c.thin * q, c.T - 1) == it) c.out[(size_t)q * D + k] = zk;
      }
    }
  }
  if (tid == 0) {
    double* counts = c.out + (size_t)c.kept * D;
    counts[0] = evals;
    counts[1] = nans;
    counts[2] = exhausted;
    counts[3] = boxed;
  }
}

template <typename T>
int launch(const void* x, const void* y, const void* mask, const void* table,
           void* out, void* trace, void* ws, int n, int d, int T_, int burn_in,
           int thin, int kept, int max_stepout, int max_shrink, double step,
           void* stream) {
  Chain c{static_cast<const double*>(x), static_cast<const double*>(y),
          static_cast<const unsigned char*>(mask), static_cast<const double*>(table),
          static_cast<double*>(out), static_cast<double*>(trace),
          static_cast<double*>(ws), n, d, T_, burn_in, thin, kept, max_stepout,
          max_shrink, step};
  const size_t smem = small_bytes(n, d, max_shrink, sizeof(T))
                      + (ws == nullptr ? big_bytes(n, d, sizeof(T)) : 0);
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  chain_kernel<T><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slice_chain_f32(const void* x, const void* y, const void* mask, const void* table,
                    void* out, void* trace, void* ws, int n, int d, int T, int burn_in,
                    int thin, int kept, int max_stepout, int max_shrink, double step,
                    void* stream) {
  return launch<float>(x, y, mask, table, out, trace, ws, n, d, T, burn_in, thin, kept,
                       max_stepout, max_shrink, step, stream);
}

int slice_chain_f64(const void* x, const void* y, const void* mask, const void* table,
                    void* out, void* trace, void* ws, int n, int d, int T, int burn_in,
                    int thin, int kept, int max_stepout, int max_shrink, double step,
                    void* stream) {
  return launch<double>(x, y, mask, table, out, trace, ws, n, d, T, burn_in, thin, kept,
                        max_stepout, max_shrink, step, stream);
}

// Dynamic shared memory of a launch: with the factor in shared memory
// (in_smem = 1) or in a workspace of slice_chain_ws_bytes.
long long slice_chain_smem_bytes(int n, int d, int max_shrink, int tsize, int in_smem) {
  return (long long)(small_bytes(n, d, max_shrink, tsize) + (in_smem ? big_bytes(n, d, tsize) : 0));
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

}  // extern "C"
