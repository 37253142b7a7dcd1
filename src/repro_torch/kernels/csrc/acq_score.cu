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
// Instantiated for double (the engine's dtype) and float.

#include "matern52_common.cuh"

namespace {

constexpr int TA = 32;    // anchors per block (one per lane)
constexpr int BI = 64;    // rows of L⁻¹ per row block
constexpr int BJ = 32;    // train rows per column chunk
constexpr int WARPS = 8;  // threads per block = 32 · WARPS
constexpr int ROWS_PER_THREAD = BI / WARPS;
constexpr int J_PER_THREAD = BJ / WARPS;

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
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
  const int ld = repro::odd_stride(d);
  T* As = reinterpret_cast<T*>(smem_raw);  // TA × ld warped anchors
  T* Xs = As + TA * ld;                    // BJ × ld warped train rows
  T* Ks = Xs + BJ * ld;                    // BJ × TA K* chunk, [j][a]
  T* Ls = Ks + BJ * TA;                    // BI × BJ block of L⁻¹
  T* red = Ls + BI * BJ;                   // 2 × WARPS × TA partial sums

  const int s = blockIdx.y;
  const int a0 = blockIdx.x * TA;
  const int tid = threadIdx.x;
  const int lane = tid & 31;  // anchor within the tile
  const int g = tid >> 5;     // warp: row / chunk-entry group
  const T* ie = inv_ell + (size_t)s * d;
  const T* pa = wa + (size_t)s * d;
  const T* pb = wb + (size_t)s * d;
  const T* po = won + (size_t)s * d;
  const T* L = linv + (size_t)s * n * n;
  const T* al = alpha + (size_t)s * n;
  const T a2 = amp2[s];

  for (int e = tid; e < TA * d; e += 32 * WARPS) {
    const int r = e / d;
    const int k = e - r * d;
    const int ga = a0 + r;
    As[r * ld + k] = ga < m ? repro::warp_scale(anchors[(size_t)ga * d + k], pa[k], pb[k], po[k], ie[k]) : T(0);
  }

  T mu_part = T(0);
  T ss_part = T(0);
  const T* my_anchor = As + lane * ld;

  for (int i0 = 0; i0 < n; i0 += BI) {
    T acc[ROWS_PER_THREAD];
#pragma unroll
    for (int q = 0; q < ROWS_PER_THREAD; ++q) acc[q] = T(0);
    const int j_end = min(i0 + BI, n);
    for (int j0 = 0; j0 < j_end; j0 += BJ) {
      __syncthreads();  // previous chunk's Xs/Ks/Ls fully consumed
      for (int e = tid; e < BJ * d; e += 32 * WARPS) {
        const int r = e / d;
        const int k = e - r * d;
        const int gj = j0 + r;
        Xs[r * ld + k] = gj < n ? repro::warp_scale(xt[(size_t)gj * d + k], pa[k], pb[k], po[k], ie[k]) : T(0);
      }
      for (int e = tid; e < BI * BJ; e += 32 * WARPS) {
        const int r = e / BJ;
        const int c = e - r * BJ;
        const int gi = i0 + r;
        const int gj = j0 + c;
        Ls[e] = (gi < n && gj < n) ? L[(size_t)gi * n + gj] : T(0);
      }
      __syncthreads();
      const bool first_visit = j0 >= i0;  // chunk J seen for the first time
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
          kv = repro::matern52(r2, a2) * mask[gj];
          if (first_visit) mu_part += al[gj] * kv;
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

  red[g * TA + lane] = mu_part;
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
    T val;
    if (acq == 0) {
      const T gamma = (y_best - mu) / sigma;
      const T cdf = T(0.5) * (T(1) + repro::f_erf(gamma / T(1.4142135623730951)));
      const T pdf = T(0.3989422804014327) * repro::f_exp(T(-0.5) * gamma * gamma);
      const T ei = sigma * (gamma * cdf + pdf);
      val = ei < T(0) ? T(0) : ei;
    } else {
      val = kappa * sigma - mu;
    }
    out[(size_t)s * m + a0 + lane] = val;
  }
}

template <typename T>
int launch(const void* anchors, const void* xt, const void* linv,
           const void* alpha, const void* mask, const void* inv_ell,
           const void* wa, const void* wb, const void* won, const void* amp2,
           double y_best, double kappa, void* out, int S, int m, int n, int d,
           int acq, void* stream) {
  const int ld = repro::odd_stride(d);
  const size_t smem =
      ((size_t)TA * ld + (size_t)BJ * ld + BJ * TA + BI * BJ + 2 * WARPS * TA) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(acq_score_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  dim3 grid((m + TA - 1) / TA, S);
  acq_score_kernel<T><<<grid, 32 * WARPS, smem, static_cast<cudaStream_t>(stream)>>>(
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
