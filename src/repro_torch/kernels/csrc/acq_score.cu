// Fused predict + acquisition over the anchor grid: acq_score.
//
// Replaces src/repro/kernels/acq_score/kernel.py::acq_score_pallas (body
// _acq_kernel). For GPHP sample s and anchor a:
//
//   K*[a, j] = mask_j · k_s(ω(x_a), ω(x_j))            (Matérn-5/2 ARD, warped)
//   μ  = Σ_j α_j K*[a, j]
//   σ² = max(amp² − Σ_i (Σ_j L⁻¹[i, j] K*[a, j])², 1e-12)
//   out[s, a] = EI(μ, σ; y*) clamped at 0, or κσ − μ (negated LCB)
//
// The TPU kernel holds the whole (tile, n) K* block in VMEM and runs L⁻¹K*ᵀ
// as one MXU product. Here the walk of acq_walk.cuh computes [L⁻¹; αᵀ]·K*ᵀ
// on the FP64 tensor cores (mma.sync.m16n8k8.f64; float on the FMA units):
// μ is the product's α row, σ² comes from the squares of its L⁻¹ rows. Up
// to 64 train rows a block warps its 32 anchors and every row, builds all
// its K* entries once in shared memory and applies EI/LCB itself: one
// launch. Above, K* is computed once into a workspace the wrapper
// allocates, blocks of 64 anchors walk pairs of row blocks of L⁻¹ through a
// cp.async ring, and with more than one block along the rows combine_kernel
// sums their partials in block order and applies EI/LCB.
//
// What bounds it: the L⁻¹·K* contraction, S·m·n(n+1)/2 multiply-adds over
// the lower triangle, on the FP64 tensor cores (67 TFLOP/s, SXM); beside
// it the S·m·n K* entries (a sqrt and an exp each) on the FP64 FMA units.
// At the main path's n ≤ 64 a launch is a few microseconds of work behind
// a ~5.5 µs launch floor (an empty walk, PERF.md); at n ≥ 1024 the walk's
// products and its L⁻¹ and K*ᵀ traffic from L2 (PERF.md §6).
//
// Padded train rows need no special case: mask 0 zeroes their K* entries
// and their identity rows of L⁻¹ then contribute nothing. Ragged anchor and
// row counts are masked here, so the dispatcher pads nothing for the kernel.
// Instantiated for double (the engine's dtype) and float: single walks of
// 32 or 8 anchors a block, paired walks of 64 or 8.

#include "acq_walk.cuh"

namespace {

using namespace repro::walk;

template <typename T>
__device__ __forceinline__ T acq_value(T ss, T mu, T a2, T y_best, T kappa, int acq) {
  const T sigma = sigma_of(a2, ss);
  return acq == 0 ? ei_closed_form(mu, sigma, y_best) : kappa * sigma - mu;
}

template <typename T, int NT, bool SINGLE, int G>
__global__ void __launch_bounds__(NTHREADS, SINGLE ? 3 : 1)
acq_score_kernel(Walk<T> w, T y_best, T kappa, int acq, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TA = 8 * NT;
  // thread a finishes anchor a: it reads only what it and the barrier
  // before wrote
  const Result<T> r = walk_block<T, NT, SINGLE, G>(w, reinterpret_cast<T*>(smem_raw), false);
  if (w.pairs > 1) return;
  const int s = blockIdx.z;
  const int a0 = blockIdx.x * TA;
  const T a2 = w.amp2[s];
  for (int a = threadIdx.x; a < TA; a += blockDim.x) {
    if (a0 + a < w.m) {
      out[(size_t)s * w.m + a0 + a] = acq_value(r.ss[a], r.mu[a], a2, y_best, kappa, acq);
    }
  }
}

// P > 1: one thread per (sample, anchor).
template <typename T>
__global__ void combine_kernel(Walk<T> w, T y_best, T kappa, int acq, T* __restrict__ out) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (a >= w.m) return;
  const T ss = combined_ss(w, s, a);
  const T mu = combined_mu(w, s, a)[0];
  out[(size_t)s * w.m + a] = acq_value(ss, mu, w.amp2[s], y_best, kappa, acq);
}

template <typename T, int NT, bool SINGLE, int G = 1>
int launch_nt(const Walk<T>& w, T y_best, T kappa, int acq, T* out, long long smem,
              cudaStream_t stream) {
  const int err = launch_walk<T, NT, SINGLE>(acq_score_kernel<T, NT, SINGLE, G>, w, smem,
                                             stream, y_best, kappa, acq, out);
  if (err != 0 || w.pairs == 1) return err;
  combine_kernel<T><<<dim3((w.m + 255) / 256, w.S), 256, 0, stream>>>(w, y_best, kappa, acq,
                                                                       out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* anchors, const void* xt, const void* linv, const void* alpha,
           const void* mask, const void* inv_ell, const void* wa, const void* wb,
           const void* won, const void* amp2, double y_best, double kappa, void* out, void* ws,
           int S, int m, int n, int d, int acq, int ta, int bm, long long smem,
           void* stream) {
  const int pairs = pairs_of(n, bm);
  if (!plan_ok<T>(ta, bm, d, n, 1, smem) || (ws == nullptr && !is_single(n, bm))) {
    return (int)cudaErrorInvalidValue;
  }
  const Walk<T> w{static_cast<const T*>(anchors), static_cast<const T*>(xt),
                  static_cast<const T*>(linv),    static_cast<const T*>(alpha),
                  static_cast<const T*>(mask),    static_cast<const T*>(inv_ell),
                  static_cast<const T*>(wa),      static_cast<const T*>(wb),
                  static_cast<const T*>(won),     static_cast<const T*>(amp2),
                  static_cast<T*>(ws),            S, m, n, d, 1, ta, bm, pairs};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  T* o = static_cast<T*>(out);
  const T yb = (T)y_best;
  const T ka = (T)kappa;
  if (is_single(n, bm)) {
    // the tiles' anchors over the warps a single walk leaves idle
    if (ta == 8) return launch_nt<T, 1, true>(w, yb, ka, acq, o, smem, st);
    return bm == 16   ? launch_nt<T, 4, true, 4>(w, yb, ka, acq, o, smem, st)
           : bm == 32 ? launch_nt<T, 4, true, 2>(w, yb, ka, acq, o, smem, st)
                      : launch_nt<T, 4, true, 1>(w, yb, ka, acq, o, smem, st);
  }
  return ta == 8 ? launch_nt<T, 1, false>(w, yb, ka, acq, o, smem, st)
                 : launch_nt<T, 8, false>(w, yb, ka, acq, o, smem, st);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (elem: 4 or 8).
long long acq_score_smem_bytes(int ta, int bm, int n, int d, int elem) {
  const repro::walk::Layout ly(ta, bm, n, d, repro::walk::is_single(n, bm), elem);
  return (long long)(ly.total * (size_t)elem);
}

// The most dynamic shared memory a block may opt in to on `device`, or -1.
long long acq_score_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) {
    return -1;
  }
  return v;
}

// ws: the plan's workspace (acq_walk.cuh Workspace; kernel.py sizes it), or
// null for a single walk.
int acq_score_f64(const void* anchors, const void* xt, const void* linv, const void* alpha,
                  const void* mask, const void* inv_ell, const void* wa, const void* wb,
                  const void* won, const void* amp2, double y_best, double kappa, void* out,
                  void* ws, int S, int m, int n, int d, int acq, int ta, int bm,
                  long long smem, void* stream) {
  return launch<double>(anchors, xt, linv, alpha, mask, inv_ell, wa, wb, won, amp2, y_best,
                        kappa, out, ws, S, m, n, d, acq, ta, bm, smem, stream);
}

int acq_score_f32(const void* anchors, const void* xt, const void* linv, const void* alpha,
                  const void* mask, const void* inv_ell, const void* wa, const void* wb,
                  const void* won, const void* amp2, double y_best, double kappa, void* out,
                  void* ws, int S, int m, int n, int d, int acq, int ta, int bm,
                  long long smem, void* stream) {
  return launch<float>(anchors, xt, linv, alpha, mask, inv_ell, wa, wb, won, amp2, y_best,
                       kappa, out, ws, S, m, n, d, acq, ta, bm, smem, stream);
}

}  // extern "C"
