// The anchor-scoring walk shared by acq_score.cu and acq_score_multi.cu.
//
// The TPU kernels (src/repro/kernels/acq_score/kernel.py) share their warp,
// cross-gram and EI helpers between the single- and multi-head bodies; this
// header is that shared core for the two CUDA kernels. A block of
// 32·WARPS threads owns TA anchors of one GPHP sample (one anchor per lane).
// It walks L⁻¹ in row blocks I of BI rows and, for each I, the column chunks
// J ≤ I of BJ train rows (L⁻¹ is lower triangular: half the work). For each
// chunk it recomputes K*[J] from warped inputs in shared memory and adds
// L⁻¹[I, J]·K*[J]ᵀ into registers; ‖v_I‖² goes into the thread's share of
// ‖L⁻¹K*ᵀ‖². The first time chunk J is seen (J = the first chunk of row
// block I with j0 ≥ i0) the caller's `heads` policy folds K*[J] into the
// means: `heads.stage(j0)` runs while the chunk loads (all threads, before
// the barrier) and `heads.add(j, gj, kv)` for each K* entry a thread
// computes. Shared memory stays bounded independently of n, and K* never
// reaches device memory.
#pragma once

#include "matern52_common.cuh"

namespace repro {
namespace walk {

constexpr int TA = 32;    // anchors per block (one per lane)
constexpr int BI = 64;    // rows of L⁻¹ per row block
constexpr int BJ = 32;    // train rows per column chunk
constexpr int WARPS = 8;  // threads per block = 32 · WARPS
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS_PER_THREAD = BI / WARPS;
constexpr int J_PER_THREAD = BJ / WARPS;

// Shared-memory elements of the walk for d features: warped anchors, warped
// chunk rows, the K* chunk and the L⁻¹ block. Callers put their own arrays
// after these.
__host__ __device__ __forceinline__ size_t smem_elems(int d) {
  const int ld = odd_stride(d);
  return (size_t)TA * ld + (size_t)BJ * ld + (size_t)BJ * TA + (size_t)BI * BJ;
}

// EI = σ·(γΦ(γ) + φ(γ)), γ = (y* − μ)/σ, clamped at 0.
template <typename T>
__device__ __forceinline__ T ei_closed_form(T mu, T sigma, T incumbent) {
  const T gamma = (incumbent - mu) / sigma;
  const T cdf = T(0.5) * (T(1) + f_erf(gamma / T(1.4142135623730951)));
  const T pdf = T(0.3989422804014327) * f_exp(T(-0.5) * gamma * gamma);
  const T ei = sigma * (gamma * cdf + pdf);
  return ei < T(0) ? T(0) : ei;
}

// Φ(z).
template <typename T>
__device__ __forceinline__ T norm_cdf(T z) {
  return T(0.5) * (T(1) + f_erf(z / T(1.4142135623730951)));
}

// Returns this thread's partial Σ over its rows of (L⁻¹K*ᵀ)², for the
// anchor of its lane. `L` is sample s's (n, n) L⁻¹; the parameter rows are
// sample s's. Every thread of the block must call it.
template <typename T, typename Heads>
__device__ __forceinline__ T variance_walk(const T* __restrict__ anchors,  // (m, d)
                           const T* __restrict__ xt,       // (n, d)
                           const T* __restrict__ L,        // (n, n)
                           const T* __restrict__ mask,     // (n,)
                           const T* __restrict__ ie,       // (d,) 1/ℓ
                           const T* __restrict__ pa,       // (d,) warp a
                           const T* __restrict__ pb,       // (d,) warp b
                           const T* __restrict__ po,       // (d,) warp on
                           T a2, int m, int n, int d, int a0, T* smem,
                           Heads& heads) {
  const int ld = odd_stride(d);
  T* As = smem;            // TA × ld warped anchors
  T* Xs = As + TA * ld;    // BJ × ld warped train rows
  T* Ks = Xs + BJ * ld;    // BJ × TA K* chunk, [j][a]
  T* Ls = Ks + BJ * TA;    // BI × BJ block of L⁻¹
  const int tid = threadIdx.x;
  const int lane = tid & 31;  // anchor within the tile
  const int g = tid >> 5;     // warp: row / chunk-entry group

  for (int e = tid; e < TA * d; e += THREADS) {
    const int r = e / d;
    const int k = e - r * d;
    const int ga = a0 + r;
    As[r * ld + k] = ga < m ? warp_scale(anchors[(size_t)ga * d + k], pa[k], pb[k], po[k], ie[k]) : T(0);
  }

  T ss_part = T(0);
  const T* my_anchor = As + lane * ld;

  for (int i0 = 0; i0 < n; i0 += BI) {
    T acc[ROWS_PER_THREAD];
#pragma unroll
    for (int q = 0; q < ROWS_PER_THREAD; ++q) acc[q] = T(0);
    const int j_end = min(i0 + BI, n);
    for (int j0 = 0; j0 < j_end; j0 += BJ) {
      __syncthreads();  // previous chunk's Xs/Ks/Ls (and staged heads) consumed
      for (int e = tid; e < BJ * d; e += THREADS) {
        const int r = e / d;
        const int k = e - r * d;
        const int gj = j0 + r;
        Xs[r * ld + k] = gj < n ? warp_scale(xt[(size_t)gj * d + k], pa[k], pb[k], po[k], ie[k]) : T(0);
      }
      for (int e = tid; e < BI * BJ; e += THREADS) {
        const int r = e / BJ;
        const int c = e - r * BJ;
        const int gi = i0 + r;
        const int gj = j0 + c;
        Ls[e] = (gi < n && gj < n) ? L[(size_t)gi * n + gj] : T(0);
      }
      const bool first_visit = j0 >= i0;  // chunk J seen for the first time
      if (first_visit) heads.stage(j0);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < J_PER_THREAD; ++q) {
        const int j = g + WARPS * q;
        const int gj = j0 + j;
        T kv = T(0);
        if (gj < n) {
          const T* xr = Xs + j * ld;
          T r2 = T(0);
          for (int k = 0; k < d; ++k) {
            const T diff = my_anchor[k] - xr[k];
            r2 += diff * diff;
          }
          kv = matern52(r2, a2) * mask[gj];
          if (first_visit) heads.add(j, gj, kv);
        }
        Ks[j * TA + lane] = kv;
      }
      __syncthreads();
      for (int j = 0; j < BJ; ++j) {
        const T kv = Ks[j * TA + lane];
#pragma unroll
        for (int q = 0; q < ROWS_PER_THREAD; ++q) {
          acc[q] += Ls[(g + WARPS * q) * BJ + j] * kv;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < ROWS_PER_THREAD; ++q) ss_part += acc[q] * acc[q];
  }
  return ss_part;
}

}  // namespace walk
}  // namespace repro
