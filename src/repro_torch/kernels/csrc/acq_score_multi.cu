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
// Design. The walk over L⁻¹ (row blocks × lower-triangular column chunks,
// K* recomputed in shared memory and never written to device memory) is
// acq_score's, from acq_walk.cuh. The extra heads ride it: when a chunk is
// first seen, its (M × BJ) α values are staged in shared memory, and each
// thread adds α_h·K* for its own (head, warp, anchor) slot of an
// (M × WARPS × TA) shared array — only that thread ever touches the slot, so
// no atomics and no extra barriers. The (W × K) weights, the incumbents and
// the thresholds are loaded into shared memory at block start. After the
// walk, warp 0 reduces the partial means and ‖v‖² over the warps and applies
// the mode's epilogue for its 32 anchors. M, W and K are runtime sizes; the
// shared memory grows as 8·(288·M + W·K + W + C) bytes on top of the walk's
// ~30 KB at d = 8 (double), and the wrapper raises, naming the limit, when
// a launch would need more than the card allows.
//
// What bounds it: the same L⁻¹K*ᵀ triangle as acq_score, S·m·n(n+1)
// FLOPs, which the FP64 tensor cores could run at twice this kernel's FP64
// FMA rate; the M − 1 extra heads add 2(M − 1) FLOPs per K* entry, and the
// epilogue O(W·K) per anchor. At the main path's n = 64 the launch is a few
// microseconds of work and launch latency dominates, as for acq_score.
//
// Instantiated for double (the engine's dtype) and float.

#include "acq_walk.cuh"

namespace {

using namespace repro::walk;

// M heads: the chunk's α staged in shared memory, each thread's partial
// means in its own shared-memory slots, added on a chunk's first visit.
template <typename T>
struct HeadBlock {
  const T* al;  // (M, n) α of this sample
  T* Al;        // M × BJ staged chunk
  T* mus;       // M × WARPS × TA partial means
  int M;
  int n;
  __device__ void stage(int j0) {
    for (int e = threadIdx.x; e < M * BJ; e += THREADS) {
      const int h = e / BJ;
      const int gj = j0 + (e - h * BJ);
      Al[e] = gj < n ? al[(size_t)h * n + gj] : T(0);
    }
  }
  __device__ void add(int j, int, T kv) {
    const int lane = threadIdx.x & 31;
    const int g = threadIdx.x >> 5;
    for (int h = 0; h < M; ++h) mus[(h * WARPS + g) * TA + lane] += Al[h * BJ + j] * kv;
  }
};

// Elements of shared memory after the walk's: ‖v‖² partials, the staged α
// chunk, the partial means, weights, incumbents and thresholds.
__host__ __device__ inline size_t extra_elems(int M, int wr, int wc, int yr, int tc) {
  return (size_t)WARPS * TA + (size_t)M * BJ + (size_t)M * WARPS * TA +
         (size_t)wr * wc + yr + tc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
acq_score_multi_kernel(const T* __restrict__ anchors,  // (m, d)
                       const T* __restrict__ xt,       // (n, d)
                       const T* __restrict__ linv,     // (S, n, n)
                       const T* __restrict__ alphas,   // (S, M, n)
                       const T* __restrict__ mask,     // (n,)
                       const T* __restrict__ inv_ell,  // (S, d)
                       const T* __restrict__ wa,       // (S, d)
                       const T* __restrict__ wb,       // (S, d)
                       const T* __restrict__ won,      // (S, d)
                       const T* __restrict__ amp2,     // (S,)
                       const T* __restrict__ tcon,     // (tc,) thresholds
                       const T* __restrict__ weights,  // (wr, wc)
                       const T* __restrict__ ybw,      // (yr,) incumbents
                       T y_best, T has_feasible,
                       T* __restrict__ out,            // (S, m)
                       int m, int n, int d, int M, int C, int wr, int wc,
                       int yr, int tc, int mode) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* red = smem + smem_elems(d);  // WARPS × TA partial ‖v‖²
  T* Al = red + WARPS * TA;
  T* mus = Al + M * BJ;
  T* Wt = mus + M * WARPS * TA;
  T* Yb = Wt + wr * wc;
  T* Tc = Yb + yr;

  const int s = blockIdx.y;
  const int a0 = blockIdx.x * TA;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 5;
  const size_t ps = (size_t)s * d;
  const T a2 = amp2[s];

  for (int e = tid; e < wr * wc; e += THREADS) Wt[e] = weights[e];
  for (int e = tid; e < yr; e += THREADS) Yb[e] = ybw[e];
  for (int e = tid; e < tc; e += THREADS) Tc[e] = tcon[e];
  for (int h = 0; h < M; ++h) mus[(h * WARPS + g) * TA + lane] = T(0);

  HeadBlock<T> heads{alphas + (size_t)s * M * n, Al, mus, M, n};
  const T ss_part = variance_walk<T>(
      anchors, xt, linv + (size_t)s * n * n, mask, inv_ell + ps, wa + ps,
      wb + ps, won + ps, a2, m, n, d, a0, smem, heads);

  red[g * TA + lane] = ss_part;
  __syncthreads();
  if (g != 0 || a0 + lane >= m) return;

  T ss = T(0);
#pragma unroll
  for (int w = 0; w < WARPS; ++w) ss += red[w * TA + lane];
  // reduce each head's partial means into this thread's own warp-0 slot
  for (int h = 0; h < M; ++h) {
    T mu = T(0);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mu += mus[(h * WARPS + w) * TA + lane];
    mus[h * WARPS * TA + lane] = mu;
  }
  const T* mu = mus + lane;  // head h's mean at mu[h * WARPS * TA]
  const int hs = WARPS * TA;
  T var = a2 - ss;
  var = var < T(1e-12) ? T(1e-12) : var;
  const T sigma = repro::f_sqrt(var);

  T feas = T(1);
  for (int c = 0; c < C; ++c) feas *= norm_cdf((Tc[c] - mu[(M - C + c) * hs]) / sigma);

  T val;
  if (mode == 0) {  // constrained
    const T e0 = ei_closed_form(mu[0], sigma, y_best);
    val = has_feasible > T(0.5) ? e0 * feas : feas;
  } else if (mode == 1) {  // pareto
    T acc = T(0);
    for (int w = 0; w < wr; ++w) {
      T ms = T(0);
      T wn2 = T(0);
      for (int k = 0; k < wc; ++k) {
        const T wk = Wt[w * wc + k];
        ms += wk * mu[k * hs];
        wn2 += wk * wk;
      }
      acc += ei_closed_form(ms, sigma * repro::f_sqrt(wn2), Yb[w]);
    }
    val = acc / T(wr) * feas;
  } else if (mode == 2) {  // rungs
    T acc = T(0);
    for (int h = 0; h < M; ++h) acc += Wt[h] * ei_closed_form(mu[h * hs], sigma, Yb[h]);
    val = acc;
  } else {  // cost
    val = ei_closed_form(mu[0], sigma, y_best) * repro::f_exp(-Wt[0] * mu[hs]);
  }
  out[(size_t)s * m + a0 + lane] = val;
}

template <typename T>
int launch(const void* anchors, const void* xt, const void* linv,
           const void* alphas, const void* mask, const void* inv_ell,
           const void* wa, const void* wb, const void* won, const void* amp2,
           const void* tcon, const void* weights, const void* ybw,
           double y_best, double has_feasible, void* out, int S, int m, int n,
           int d, int M, int C, int wr, int wc, int yr, int mode,
           void* stream) {
  const int tc = C > 0 ? C : 1;
  const size_t smem = (smem_elems(d) + extra_elems(M, wr, wc, yr, tc)) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        acq_score_multi_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((m + TA - 1) / TA, S);
  acq_score_multi_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(anchors), static_cast<const T*>(xt),
      static_cast<const T*>(linv), static_cast<const T*>(alphas),
      static_cast<const T*>(mask), static_cast<const T*>(inv_ell),
      static_cast<const T*>(wa), static_cast<const T*>(wb),
      static_cast<const T*>(won), static_cast<const T*>(amp2),
      static_cast<const T*>(tcon), static_cast<const T*>(weights),
      static_cast<const T*>(ybw), static_cast<T>(y_best),
      static_cast<T>(has_feasible), static_cast<T*>(out), m, n, d, M, C, wr,
      wc, yr, tc, mode);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (elem: 4 or 8).
long long acq_score_multi_smem_bytes(int d, int M, int wr, int wc, int yr,
                                     int tc, int elem) {
  return (long long)((repro::walk::smem_elems(d) + extra_elems(M, wr, wc, yr, tc)) *
                     (size_t)elem);
}

// The most dynamic shared memory a block may opt in to on `device`, or -1.
long long acq_score_multi_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) {
    return -1;
  }
  return v;
}

int acq_score_multi_f64(const void* anchors, const void* xt, const void* linv,
                        const void* alphas, const void* mask,
                        const void* inv_ell, const void* wa, const void* wb,
                        const void* won, const void* amp2, const void* tcon,
                        const void* weights, const void* ybw, double y_best,
                        double has_feasible, void* out, int S, int m, int n,
                        int d, int M, int C, int wr, int wc, int yr, int mode,
                        void* stream) {
  return launch<double>(anchors, xt, linv, alphas, mask, inv_ell, wa, wb, won,
                        amp2, tcon, weights, ybw, y_best, has_feasible, out,
                        S, m, n, d, M, C, wr, wc, yr, mode, stream);
}

int acq_score_multi_f32(const void* anchors, const void* xt, const void* linv,
                        const void* alphas, const void* mask,
                        const void* inv_ell, const void* wa, const void* wb,
                        const void* won, const void* amp2, const void* tcon,
                        const void* weights, const void* ybw, double y_best,
                        double has_feasible, void* out, int S, int m, int n,
                        int d, int M, int C, int wr, int wc, int yr, int mode,
                        void* stream) {
  return launch<float>(anchors, xt, linv, alphas, mask, inv_ell, wa, wb, won,
                       amp2, tcon, weights, ybw, y_best, has_feasible, out,
                       S, m, n, d, M, C, wr, wc, yr, mode, stream);
}

}  // extern "C"
