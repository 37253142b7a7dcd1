// Device helpers shared by the Matérn-5/2 and anchor-scoring kernels:
// the Kumaraswamy input warp (identity where `on` is 0) with lengthscale
// scaling, and the Matérn-5/2 response of a squared distance. Written for
// float and double alike; the arithmetic is that of the engine's torch
// functions (core/gp/warping.py, core/gp/kernels.py), which the plain
// versions (kernels/*/plain.py) are built from.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace repro {

__device__ __forceinline__ float f_exp(float x) { return expf(x); }
__device__ __forceinline__ double f_exp(double x) { return exp(x); }
__device__ __forceinline__ float f_log(float x) { return logf(x); }
__device__ __forceinline__ double f_log(double x) { return log(x); }
__device__ __forceinline__ float f_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double f_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float f_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double f_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float f_erf(float x) { return erff(x); }
__device__ __forceinline__ double f_erf(double x) { return erf(x); }

// max(x, lo) then min(., hi), propagating NaN like torch.clamp.
template <typename T>
__device__ __forceinline__ T clip_unit(T x) {
  const T lo = T(1e-6);
  const T hi = T(1.0 - 1e-6);
  return x < lo ? lo : (x > hi ? hi : x);
}

// Kumaraswamy CDF warp 1 - (1 - x^a)^b, blended by `on`, times 1/ℓ.
template <typename T>
__device__ __forceinline__ T warp_scale(T x, T a, T b, T on, T inv_ell) {
  const T xc = clip_unit(x);
  const T xa = clip_unit(f_exp(a * f_log(xc)));
  const T w = T(1) - f_exp(b * f_log1p(-xa));
  return (on * w + (T(1) - on) * x) * inv_ell;
}

// amp² (1 + √5 r + 5/3 r²) exp(-√5 r) of r² = ‖a − b‖².
template <typename T>
__device__ __forceinline__ T matern52(T r2, T amp2) {
  const T sqrt5 = T(2.2360679774997896);
  const T r = f_sqrt(r2);
  return amp2 * (T(1) + sqrt5 * r + T(5.0 / 3.0) * r2) * f_exp(-sqrt5 * r);
}

// k(a, b) of two warped, scaled rows: the squared distance summed over the
// features in order, then the Matérn response. Every gram kernel builds its
// entries with it (matern52.cu, slice_chain.cu), so their grams agree bit for
// bit.
template <typename T>
__device__ __forceinline__ T gram_entry(const T* a, const T* b, int d, T amp2) {
  T r2 = T(0);
  for (int k = 0; k < d; ++k) {
    const T diff = a[k] - b[k];
    r2 += diff * diff;
  }
  return matern52(r2, amp2);
}

// Row stride in shared memory: d rounded up to an odd count, so threads of
// a warp reading rows at the same column hit distinct banks.
__host__ __device__ __forceinline__ int odd_stride(int d) { return d | 1; }

}  // namespace repro
