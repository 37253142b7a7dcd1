// Fused multi-head predict + acquisition over the anchor grid:
// acq_score_multi.
//
// Replaces src/repro/kernels/acq_score/kernel.py:254 acq_score_multi_pallas
// (body _acq_multi_kernel). For GPHP sample s and anchor a, with M metric
// heads sharing one factor (objectives first, the C constraints last):
//
//   K*[a, j] = mask_j · k_s(ω(x_a), ω(x_j))           (Matérn-5/2 ARD, warped)
//   μ_h = Σ_j α_h[j] K*[a, j]                          for every head h < M
//   σ² = max(amp² − ‖L⁻¹K*ᵀ‖², 1e-12)                  (shared by all heads)
//   feas = Π_c Φ((t_c − μ_{M−C+c}) / σ)
//   out[s, a] = constrained: EI(μ₀, σ; y*)·feas if a feasible incumbent
//                            exists, else feas
//               pareto:      mean_w EI(w·μ_{:K}, σ‖w‖; y*_w) · feas
//               rungs:       Σ_h w_h EI(μ_h, σ; y*_h)
//               cost:        EI(μ₀, σ; y*)·exp(−η μ₁)
//
// Design. The walk is acq_score's (acq_walk.cuh): [L⁻¹; αᵀ]·K*ᵀ on the
// FP64 tensor cores, the M ≤ 16 head rows of α one 16-row tile of the same
// product, so every head's mean comes out with ‖v‖². The epilogue is
// spread over the block: four lanes per anchor share its W scalarization
// draws (pareto), its M heads (rungs) and its C constraint factors, then
// sum (or multiply) them by two shuffles in a fixed order, so every warp
// of the block works. With more than one block along the rows the same
// epilogue runs in combine_kernel, four lanes per anchor, after the
// blocks' partials are summed in order. Weights, incumbents and thresholds
// are read from device memory (a few hundred bytes, cached).
//
// What bounds it: the same L⁻¹K*ᵀ triangle as acq_score, S·m·n(n+1)
// FLOPs, on the FP64 tensor cores; the M head rows add one 16-row tile
// (2·16·n FLOPs per anchor), and the epilogue O(W·K) per anchor. At the
// main path's n ≤ 64 a launch is a few microseconds of work behind its
// launch floor, as for acq_score.
//
// Instantiated for double (the engine's dtype) and float: single walks of
// 32 or 8 anchors a block, paired walks of 64 or 8.

#include "acq_walk.cuh"

namespace {

using namespace repro::walk;

template <typename T>
struct Heads {
  const T* tcon;     // (tc,) thresholds
  const T* weights;  // (wr, wc)
  const T* ybw;      // (yr,) incumbents
  T y_best;
  T has_feasible;
  int C, wr, wc, mode;
};

// Sum / product over the four lanes of a group, the same bits on each.
template <typename T>
__device__ __forceinline__ T group_sum(T x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T>
__device__ __forceinline__ T group_prod(T x) {
  x *= __shfl_xor_sync(0xffffffffu, x, 1);
  return x * __shfl_xor_sync(0xffffffffu, x, 2);
}

// The mode's value at one (sample, anchor), computed by the four lanes of
// a group (sub = 0..3); head h's mean at mu[h·stride]. Every lane of the
// warp must call it (shuffles).
template <typename T>
__device__ __forceinline__ T multi_value(const Heads<T>& q, int M, T a2, T ss, const T* mu,
                                         int stride, int sub) {
  const T sigma = sigma_of(a2, ss);
  T feas = T(1);
  for (int c = sub; c < q.C; c += 4) {
    feas *= norm_cdf((q.tcon[c] - mu[(M - q.C + c) * stride]) / sigma);
  }
  feas = group_prod(feas);
  if (q.mode == 0) {  // constrained
    const T e0 = ei_closed_form(mu[0], sigma, q.y_best);
    return q.has_feasible > T(0.5) ? e0 * feas : feas;
  }
  if (q.mode == 1) {  // pareto
    T acc = T(0);
    for (int v = sub; v < q.wr; v += 4) {
      T ms = T(0);
      T wn2 = T(0);
      for (int k = 0; k < q.wc; ++k) {
        const T wk = q.weights[v * q.wc + k];
        ms += wk * mu[k * stride];
        wn2 += wk * wk;
      }
      acc += ei_closed_form(ms, sigma * repro::f_sqrt(wn2), q.ybw[v]);
    }
    return group_sum(acc) / T(q.wr) * feas;
  }
  if (q.mode == 2) {  // rungs
    T acc = T(0);
    for (int h = sub; h < M; h += 4) {
      acc += q.weights[h] * ei_closed_form(mu[h * stride], sigma, q.ybw[h]);
    }
    return group_sum(acc);
  }
  // cost
  return ei_closed_form(mu[0], sigma, q.y_best) * repro::f_exp(-q.weights[0] * mu[stride]);
}

template <typename T, int NT, bool SINGLE, int G>
__global__ void __launch_bounds__(NTHREADS, SINGLE ? 3 : 1)
acq_score_multi_kernel(Walk<T> w, Heads<T> q, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TA = 8 * NT;
  const Result<T> r = walk_block<T, NT, SINGLE, G>(w, reinterpret_cast<T*>(smem_raw), true);
  if (w.pairs > 1) return;
  const int s = blockIdx.z;
  const int a0 = blockIdx.x * TA;
  const T a2 = w.amp2[s];
  // 4·TA is a multiple of 32 and so is blockDim.x: whole warps per pass
  for (int idx = threadIdx.x; idx < 4 * TA; idx += blockDim.x) {
    const int a = idx >> 2;
    const int sub = idx & 3;
    const T val = multi_value(q, w.M, a2, r.ss[a], r.mu + a, TA, sub);
    if (sub == 0 && a0 + a < w.m) out[(size_t)s * w.m + a0 + a] = val;
  }
}

// P > 1: four lanes per (sample, anchor).
template <typename T>
__global__ void combine_kernel(Walk<T> w, Heads<T> q, T* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  const int a = idx >> 2;
  const int ac = a < w.m ? a : w.m - 1;  // lanes past m still shuffle
  const T ss = combined_ss(w, s, ac);
  const T val = multi_value(q, w.M, w.amp2[s], ss, combined_mu(w, s, ac), w.m, idx & 3);
  if ((idx & 3) == 0 && a < w.m) out[(size_t)s * w.m + a] = val;
}

template <typename T, int NT, bool SINGLE, int G = 1>
int launch_nt(const Walk<T>& w, const Heads<T>& q, T* out, long long smem, cudaStream_t stream) {
  const int err = launch_walk<T, NT, SINGLE>(acq_score_multi_kernel<T, NT, SINGLE, G>, w, smem,
                                             stream, q, out);
  if (err != 0 || w.pairs == 1) return err;
  combine_kernel<T><<<dim3((4 * w.m + 255) / 256, w.S), 256, 0, stream>>>(w, q, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* anchors, const void* xt, const void* linv, const void* alphas,
           const void* mask, const void* inv_ell, const void* wa, const void* wb,
           const void* won, const void* amp2, const void* tcon, const void* weights,
           const void* ybw, double y_best, double has_feasible, void* out, void* ws, int S,
           int m, int n, int d, int M, int C, int wr, int wc, int mode, int ta, int bm,
           long long smem, void* stream) {
  const int pairs = pairs_of(n, bm);
  if (!plan_ok<T>(ta, bm, d, n, M, smem) || (ws == nullptr && !is_single(n, bm))) {
    return (int)cudaErrorInvalidValue;
  }
  const Walk<T> w{static_cast<const T*>(anchors), static_cast<const T*>(xt),
                  static_cast<const T*>(linv),    static_cast<const T*>(alphas),
                  static_cast<const T*>(mask),    static_cast<const T*>(inv_ell),
                  static_cast<const T*>(wa),      static_cast<const T*>(wb),
                  static_cast<const T*>(won),     static_cast<const T*>(amp2),
                  static_cast<T*>(ws),            S, m, n, d, M, ta, bm, pairs};
  const Heads<T> q{static_cast<const T*>(tcon), static_cast<const T*>(weights),
                   static_cast<const T*>(ybw), (T)y_best, (T)has_feasible, C, wr, wc, mode};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  T* o = static_cast<T*>(out);
  if (is_single(n, bm)) {
    // the tiles' anchors over the warps a single walk leaves idle
    if (ta == 8) return launch_nt<T, 1, true>(w, q, o, smem, st);
    return bm == 16   ? launch_nt<T, 4, true, 4>(w, q, o, smem, st)
           : bm == 32 ? launch_nt<T, 4, true, 2>(w, q, o, smem, st)
                      : launch_nt<T, 4, true, 1>(w, q, o, smem, st);
  }
  return ta == 8 ? launch_nt<T, 1, false>(w, q, o, smem, st)
                 : launch_nt<T, 8, false>(w, q, o, smem, st);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (elem: 4 or 8).
long long acq_score_multi_smem_bytes(int ta, int bm, int n, int d, int elem) {
  const repro::walk::Layout ly(ta, bm, n, d, repro::walk::is_single(n, bm), elem);
  return (long long)(ly.total * (size_t)elem);
}

// The most dynamic shared memory a block may opt in to on `device`, or -1.
long long acq_score_multi_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) {
    return -1;
  }
  return v;
}

// ws: the plan's workspace (acq_walk.cuh Workspace; kernel.py sizes it), or
// null for a single walk.
int acq_score_multi_f64(const void* anchors, const void* xt, const void* linv,
                        const void* alphas, const void* mask, const void* inv_ell,
                        const void* wa, const void* wb, const void* won, const void* amp2,
                        const void* tcon, const void* weights, const void* ybw, double y_best,
                        double has_feasible, void* out, void* ws, int S, int m, int n, int d,
                        int M, int C, int wr, int wc, int mode, int ta, int bm, long long smem,
                        void* stream) {
  return launch<double>(anchors, xt, linv, alphas, mask, inv_ell, wa, wb, won, amp2, tcon,
                        weights, ybw, y_best, has_feasible, out, ws, S, m, n, d, M, C, wr, wc,
                        mode, ta, bm, smem, stream);
}

int acq_score_multi_f32(const void* anchors, const void* xt, const void* linv,
                        const void* alphas, const void* mask, const void* inv_ell,
                        const void* wa, const void* wb, const void* won, const void* amp2,
                        const void* tcon, const void* weights, const void* ybw, double y_best,
                        double has_feasible, void* out, void* ws, int S, int m, int n, int d,
                        int M, int C, int wr, int wc, int mode, int ta, int bm, long long smem,
                        void* stream) {
  return launch<float>(anchors, xt, linv, alphas, mask, inv_ell, wa, wb, won, amp2, tcon,
                       weights, ybw, y_best, has_feasible, out, ws, S, m, n, d, M, C, wr, wc,
                       mode, ta, bm, smem, stream);
}

}  // extern "C"
