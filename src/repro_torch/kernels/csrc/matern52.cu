// Matérn-5/2 ARD gram and cross-row kernels with the fused Kumaraswamy warp.
//
// Replaces src/repro/kernels/matern52/kernel.py::matern52_gram_pallas
// (body _kernel) and ::matern52_cross_pallas (body _cross_kernel).
//
// matern52_gram: K[s, i, j] = k_s(x1_i, x2_j) for S parameter sets at once.
//   The TPU kernel streams (128, d) tiles into VMEM and forms ‖a−b‖² on the
//   MXU as ‖a‖² + ‖b‖² − 2a·bᵀ. Here each 16×16 block warps and scales its
//   16 x1 rows and 16 x2 rows once into shared memory, and each thread sums
//   (a_k − b_k)² over the features for its entry: the difference form, which
//   keeps full relative accuracy near the diagonal and needs no tensor core
//   at the engine's d (≤ ~30). What bounds it: at the engine's shapes (n ≤
//   1024, d ≈ 6, float) the output write, n·m·4 bytes, against ~(3d + 20)
//   operations per entry — memory- or launch-bound, never the FP32 units.
//   The design writes each output once, coalesced along j, and reads each
//   input row once per block.
//
// matern52_cross: one row k_s(x_new, X) for S parameter sets. One thread per
//   train row; the warped x_new row sits in shared memory. The TPU kernel
//   replicated the row 8 times (its sublane minimum); nothing here needs
//   that. Bound: launch latency at the engine's n (≤ 1024 rows).
//
// Parameters are per set s: inv_ell, a, b, on are (S, d), amp2 is (S,).
// Every entry point returns cudaGetLastError() after its launch.

#include "matern52_common.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kCrossThreads = 128;

template <typename T>
__global__ void gram_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                            const T* __restrict__ inv_ell,
                            const T* __restrict__ wa, const T* __restrict__ wb,
                            const T* __restrict__ won,
                            const T* __restrict__ amp2, T* __restrict__ out,
                            int n, int m, int d) {
  extern __shared__ unsigned char smem_raw[];
  T* s1 = reinterpret_cast<T*>(smem_raw);
  const int ld = repro::odd_stride(d);
  T* s2 = s1 + kTile * ld;

  const int s = blockIdx.z;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const T* ie = inv_ell + (size_t)s * d;
  const T* pa = wa + (size_t)s * d;
  const T* pb = wb + (size_t)s * d;
  const T* po = won + (size_t)s * d;

  for (int e = tid; e < kTile * d; e += kTile * kTile) {
    const int r = e / d;
    const int k = e - r * d;
    const int gi = row0 + r;
    const int gj = col0 + r;
    s1[r * ld + k] = gi < n ? repro::warp_scale(x1[(size_t)gi * d + k], pa[k], pb[k], po[k], ie[k]) : T(0);
    s2[r * ld + k] = gj < m ? repro::warp_scale(x2[(size_t)gj * d + k], pa[k], pb[k], po[k], ie[k]) : T(0);
  }
  __syncthreads();

  const int i = row0 + threadIdx.y;
  const int j = col0 + threadIdx.x;
  if (i < n && j < m) {
    out[((size_t)s * n + i) * m + j] = repro::gram_entry(
        s1 + threadIdx.y * ld, s2 + threadIdx.x * ld, d, amp2[s]);
  }
}

template <typename T>
__global__ void cross_kernel(const T* __restrict__ xn, const T* __restrict__ xt,
                             const T* __restrict__ inv_ell,
                             const T* __restrict__ wa, const T* __restrict__ wb,
                             const T* __restrict__ won,
                             const T* __restrict__ amp2, T* __restrict__ out,
                             int n, int d) {
  extern __shared__ unsigned char smem_raw[];
  T* sn = reinterpret_cast<T*>(smem_raw);
  const int s = blockIdx.y;
  const T* ie = inv_ell + (size_t)s * d;
  const T* pa = wa + (size_t)s * d;
  const T* pb = wb + (size_t)s * d;
  const T* po = won + (size_t)s * d;
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    sn[k] = repro::warp_scale(xn[k], pa[k], pb[k], po[k], ie[k]);
  }
  __syncthreads();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n) {
    const T* row = xt + (size_t)j * d;
    T r2 = T(0);
    for (int k = 0; k < d; ++k) {
      const T diff = sn[k] - repro::warp_scale(row[k], pa[k], pb[k], po[k], ie[k]);
      r2 += diff * diff;
    }
    out[(size_t)s * n + j] = repro::matern52(r2, amp2[s]);
  }
}

template <typename T>
int launch_gram(const void* x1, const void* x2, const void* inv_ell,
                const void* wa, const void* wb, const void* won,
                const void* amp2, void* out, int S, int n, int m, int d,
                void* stream) {
  const size_t smem = 2 * kTile * repro::odd_stride(d) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  dim3 block(kTile, kTile);
  dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile, S);
  gram_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2),
      static_cast<const T*>(inv_ell), static_cast<const T*>(wa),
      static_cast<const T*>(wb), static_cast<const T*>(won),
      static_cast<const T*>(amp2), static_cast<T*>(out), n, m, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cross(const void* xn, const void* xt, const void* inv_ell,
                 const void* wa, const void* wb, const void* won,
                 const void* amp2, void* out, int S, int n, int d,
                 void* stream) {
  const size_t smem = d * sizeof(T);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(cross_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  dim3 grid((n + kCrossThreads - 1) / kCrossThreads, S);
  cross_kernel<T><<<grid, kCrossThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xn), static_cast<const T*>(xt),
      static_cast<const T*>(inv_ell), static_cast<const T*>(wa),
      static_cast<const T*>(wb), static_cast<const T*>(won),
      static_cast<const T*>(amp2), static_cast<T*>(out), n, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int matern52_gram_f32(const void* x1, const void* x2, const void* inv_ell,
                      const void* wa, const void* wb, const void* won,
                      const void* amp2, void* out, int S, int n, int m, int d,
                      void* stream) {
  return launch_gram<float>(x1, x2, inv_ell, wa, wb, won, amp2, out, S, n, m, d, stream);
}

int matern52_gram_f64(const void* x1, const void* x2, const void* inv_ell,
                      const void* wa, const void* wb, const void* won,
                      const void* amp2, void* out, int S, int n, int m, int d,
                      void* stream) {
  return launch_gram<double>(x1, x2, inv_ell, wa, wb, won, amp2, out, S, n, m, d, stream);
}

int matern52_cross_f32(const void* xn, const void* xt, const void* inv_ell,
                       const void* wa, const void* wb, const void* won,
                       const void* amp2, void* out, int S, int n, int d,
                       void* stream) {
  return launch_cross<float>(xn, xt, inv_ell, wa, wb, won, amp2, out, S, n, d, stream);
}

int matern52_cross_f64(const void* xn, const void* xt, const void* inv_ell,
                       const void* wa, const void* wb, const void* won,
                       const void* amp2, void* out, int S, int n, int d,
                       void* stream) {
  return launch_cross<double>(xn, xt, inv_ell, wa, wb, won, amp2, out, S, n, d, stream);
}

}  // extern "C"
