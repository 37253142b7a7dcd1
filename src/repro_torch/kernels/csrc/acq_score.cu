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
// as one MXU product. Hopper has 227 KB of shared memory per block, which at
// double precision and n = 1024 would hold K* for ~24 anchors, so that
// tiling is not carried over. Instead each block owns TA anchors of one
// sample and walks L⁻¹ in row blocks I of BI rows; for each I it loops over
// the column chunks J ≤ I (L⁻¹ is lower triangular: half the work),
// recomputes the K* chunk for the BJ train rows of J from warped inputs in
// shared memory, and accumulates v_I = Σ_J L⁻¹[I, J]·K*[J]ᵀ in registers.
// ‖v_I‖² goes into σ², and α_J·K*_J into μ the first time chunk J is seen.
// Shared memory is bounded independently of n, and K* never reaches device
// memory, as on the TPU.
//
// Padded train rows need no special case: mask 0 zeroes their K* entries
// and their identity rows of L⁻¹ then contribute nothing. Ragged anchor and
// row counts are masked here, so the dispatcher pads nothing for the kernel.
//
// What bounds it: the L⁻¹·K* contraction, S·m·n(n+1)/2 multiply-adds over
// the lower triangle. This kernel runs it on the FP64 FMA units; the card's
// FP64 tensor cores would double the peak for that product, which is the
// gap between this design and the bound at large n. At the main path's
// n = 64 the whole launch is a few microseconds of work and launch latency
// dominates. The K* recomputation costs ~n/(2·BI) kernel evaluations per
// (anchor, train row) on top; the L⁻¹ reads (S·n²/2 values per anchor tile)
// stream from L2.
//
// The walk itself (row blocks of L⁻¹ × column chunks, K* in shared memory)
// lives in acq_walk.cuh, shared with acq_score_multi.cu. Instantiated for
// double (the engine's dtype) and float.

#include "acq_walk.cuh"

namespace {

using namespace repro::walk;

// One head: μ accumulates α_J·K*_J in a register on a chunk's first visit.
template <typename T>
struct OneHead {
  const T* al;  // (n,) α of this sample
  T mu;
  __device__ void stage(int) {}
  __device__ void add(int, int gj, T kv) { mu += al[gj] * kv; }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
acq_score_kernel(const T* __restrict__ anchors,  // (m, d)
                 const T* __restrict__ xt,       // (n, d)
                 const T* __restrict__ linv,     // (S, n, n)
                 const T* __restrict__ alpha,    // (S, n)
                 const T* __restrict__ mask,     // (n,)
                 const T* __restrict__ inv_ell,  // (S, d)
                 const T* __restrict__ wa,       // (S, d)
                 const T* __restrict__ wb,       // (S, d)
                 const T* __restrict__ won,      // (S, d)
                 const T* __restrict__ amp2,     // (S,)
                 T y_best, T kappa,
                 T* __restrict__ out,            // (S, m)
                 int m, int n, int d, int acq) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* red = smem + smem_elems(d);  // 2 × WARPS × TA partial sums

  const int s = blockIdx.y;
  const int a0 = blockIdx.x * TA;
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const size_t ps = (size_t)s * d;
  const T a2 = amp2[s];

  OneHead<T> head{alpha + (size_t)s * n, T(0)};
  const T ss_part = variance_walk<T>(
      anchors, xt, linv + (size_t)s * n * n, mask, inv_ell + ps, wa + ps,
      wb + ps, won + ps, a2, m, n, d, a0, smem, head);

  red[g * TA + lane] = head.mu;
  red[(WARPS + g) * TA + lane] = ss_part;
  __syncthreads();
  if (g == 0 && a0 + lane < m) {
    T mu = T(0);
    T ss = T(0);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      mu += red[w * TA + lane];
      ss += red[(WARPS + w) * TA + lane];
    }
    T var = a2 - ss;
    var = var < T(1e-12) ? T(1e-12) : var;
    const T sigma = repro::f_sqrt(var);
    const T val = acq == 0 ? repro::walk::ei_closed_form(mu, sigma, y_best)
                           : kappa * sigma - mu;
    out[(size_t)s * m + a0 + lane] = val;
  }
}

template <typename T>
int launch(const void* anchors, const void* xt, const void* linv,
           const void* alpha, const void* mask, const void* inv_ell,
           const void* wa, const void* wb, const void* won, const void* amp2,
           double y_best, double kappa, void* out, int S, int m, int n, int d,
           int acq, void* stream) {
  const size_t smem = (smem_elems(d) + 2 * WARPS * TA) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(acq_score_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  dim3 grid((m + TA - 1) / TA, S);
  acq_score_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(anchors), static_cast<const T*>(xt),
      static_cast<const T*>(linv), static_cast<const T*>(alpha),
      static_cast<const T*>(mask), static_cast<const T*>(inv_ell),
      static_cast<const T*>(wa), static_cast<const T*>(wb),
      static_cast<const T*>(won), static_cast<const T*>(amp2),
      static_cast<T>(y_best), static_cast<T>(kappa), static_cast<T*>(out),
      m, n, d, acq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int acq_score_f64(const void* anchors, const void* xt, const void* linv,
                  const void* alpha, const void* mask, const void* inv_ell,
                  const void* wa, const void* wb, const void* won,
                  const void* amp2, double y_best, double kappa, void* out,
                  int S, int m, int n, int d, int acq, void* stream) {
  return launch<double>(anchors, xt, linv, alpha, mask, inv_ell, wa, wb, won,
                        amp2, y_best, kappa, out, S, m, n, d, acq, stream);
}

int acq_score_f32(const void* anchors, const void* xt, const void* linv,
                  const void* alpha, const void* mask, const void* inv_ell,
                  const void* wa, const void* wb, const void* won,
                  const void* amp2, double y_best, double kappa, void* out,
                  int S, int m, int n, int d, int acq, void* stream) {
  return launch<float>(anchors, xt, linv, alpha, mask, inv_ell, wa, wb, won,
                       amp2, y_best, kappa, out, S, m, n, d, acq, stream);
}

}  // extern "C"
