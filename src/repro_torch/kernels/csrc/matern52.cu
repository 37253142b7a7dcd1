// Matérn-5/2 ARD kernels with the fused Kumaraswamy warp: the gram, the
// cross rows of an append, and the masked operand of the factorize step.
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
//   input row once per block. The predictions (kriging believer) take it.
//
// matern52_cross: the cross rows of appending R rows x_new at rows idx,
//   idx + 1, … of a bucket of m: K[s, r, j] = k_s(x_new_r, z_j), where z is
//   the bucket's first idx rows, then x_new; columns from idx + R on are 0.
//   The append of row r reads columns [0, idx + r) of row r, so one launch
//   serves the whole pending set (the TPU kernel made one row a call and
//   replicated it 8 times, its sublane minimum). Inputs are the engine's
//   own float64 tensors: the rows and the (S, 3d + 2) table of log GPHPs,
//   packed here as kernels/matern52/ops.py packs them (cast to float, then
//   exponentiate); the gram is float32, as the TPU kernel's, written as
//   float64. One block a parameter set and a tile of 16 columns: it warps
//   its R new rows and its columns into shared memory once (each thread
//   packing the feature it warps, so the table's and the rows' loads go out
//   together and one barrier follows), and each thread computes (r, j)
//   entries with repro::gram_entry, stores coalesced along j. Bound: the
//   launch — at the engine's sizes (S = 10, R ≤ 3, m ≤ 64) the work is
//   ~2,000 entries, ~40 blocks, one dependent load and one barrier deep.
//
// matern52_operand: the factorize step's operand from the bucket's float64
//   rows, the table and the row mask, K̃ = k·mm + I·(1 − mm) + I·mm·noise
//   with mm = mask_i·mask_j and noise = exp(2 log σ) + jitter: the gram
//   kernel's tiles and entries (float32, packed as the cross rows pack),
//   then core/gp/gp.py::masked_operand in float64, in its order and with
//   its rounding (no contraction), so the operand equals the torch
//   composition around matern52_gram bit for bit. One launch where that
//   composition made ~20. Bound: the launch, then the S·n²·8-byte write.
//
// Each entry of every kernel is repro::gram_entry of two warped rows in
// shared memory, so the gram, the cross rows, the operand and slice_chain's
// gram agree bit for bit. matern52_empty launches nothing but itself: the
// launch floor the others are measured against.
// Every entry point returns cudaGetLastError() after its launch.

#include "matern52_common.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kRowThreads = 128;  // threads of a cross-row block
constexpr int kRowTile = 16;      // columns of its tile

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

// The warped, scaled value of x in feature k under one row p of the
// (S, 3d + 2) table of log GPHPs — log ℓ (d), log amplitude, log σ, log a
// (d), log b (d) — with the parameters packed as
// kernels/matern52/ops.py::packed_params packs them, in its order: cast to
// float, then exponentiate; `on` 0 where |log a| and |log b| are both below
// 1e-7 (tested on the doubles) or the warp is off. Each thread packs the
// feature it warps: three exponentials, and no barrier or second round of
// loads between the table and the rows.
__device__ __forceinline__ float warp_from_table(double x, const double* __restrict__ p,
                                                 int d, int k, int warp) {
  const double la = p[d + 2 + k];
  const double lb = p[2 * d + 2 + k];
  const float inv_ell = repro::f_exp(-float(p[k]));
  const float a = repro::f_exp(float(la));
  const float b = repro::f_exp(float(lb));
  const float on = (warp && !(fabs(la) < 1e-7 && fabs(lb) < 1e-7)) ? 1.0f : 0.0f;
  return repro::warp_scale(float(x), a, b, on, inv_ell);
}

// amp² of table row p, packed as ops.py packs it.
__device__ __forceinline__ float amp2_from_table(const double* __restrict__ p, int d) {
  return repro::f_exp(2.0f * float(p[d]));
}

// Cross rows of an append: block (column tile, s), kRowThreads threads;
// the tile's kRowTile columns and the R new rows are warped into shared
// memory (one element a thread at the engine's d), then each thread takes
// (r, j) entries, r-major, so stores run along j.
__global__ void cross_rows_kernel(const double* __restrict__ xn, const double* __restrict__ xt,
                                  const double* __restrict__ table, double* __restrict__ out,
                                  int R, int m, int d, int idx, int warp) {
  extern __shared__ float smem_f[];
  const int ld = repro::odd_stride(d);
  float* sn = smem_f;          // R new rows
  float* sc = sn + R * ld;     // the tile's columns
  const int s = blockIdx.y;
  const int col0 = blockIdx.x * kRowTile;
  const int tid = threadIdx.x;
  const int end = idx + R;  // columns from here on are no rows
  const double* p = table + (size_t)s * (3 * d + 2);
  const float amp2 = amp2_from_table(p, d);

  // elements [0, R·d) are the new rows', then the tile's live columns'
  const int cols = max(0, min(min(m, end) - col0, kRowTile));
  for (int e = tid; e < (R + cols) * d; e += kRowThreads) {
    const int r = e / d;
    const int k = e - r * d;
    double v;
    float* dst;
    if (r < R) {
      v = xn[(size_t)r * d + k];
      dst = sn + r * ld + k;
    } else {
      const int j = col0 + r - R;
      v = j < idx ? xt[(size_t)j * d + k] : xn[(size_t)(j - idx) * d + k];
      dst = sc + (r - R) * ld + k;
    }
    *dst = warp_from_table(v, p, d, k, warp);
  }
  __syncthreads();

  const int tile = min(m - col0, kRowTile);
  for (int e = tid; e < R * tile; e += kRowThreads) {
    const int r = e / tile;
    const int c = e - r * tile;
    const int j = col0 + c;
    out[((size_t)s * R + r) * m + j] =
        j < end ? double(repro::gram_entry(sn + r * ld, sc + c * ld, d, amp2)) : 0.0;
  }
}

// The factorize operand: block (column tile, row tile, s), kTile × kTile
// threads, the gram kernel's layout.
__global__ void operand_kernel(const double* __restrict__ x, const double* __restrict__ table,
                               const unsigned char* __restrict__ mask, double* __restrict__ out,
                               int n, int d, int warp, double jitter) {
  extern __shared__ float smem_f[];
  const int ld = repro::odd_stride(d);
  float* s1 = smem_f;
  float* s2 = s1 + kTile * ld;
  const int s = blockIdx.z;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const double* p = table + (size_t)s * (3 * d + 2);
  const int i = row0 + threadIdx.y;
  const int j = col0 + threadIdx.x;
  const bool inside = i < n && j < n;
  const float amp2 = amp2_from_table(p, d);
  const double noise = __dadd_rn(exp(2.0 * p[d + 1]), jitter);
  const double mm = (inside && mask[i] && mask[j]) ? 1.0 : 0.0;

  // elements [0, kTile·d) are the tile's rows', then its columns'
  for (int e = tid; e < 2 * kTile * d; e += kTile * kTile) {
    const int r = e / d;
    const int k = e - r * d;
    const int g = r < kTile ? row0 + r : col0 + r - kTile;
    float* dst = r < kTile ? s1 + r * ld : s2 + (r - kTile) * ld;
    dst[k] = g < n ? warp_from_table(x[(size_t)g * d + k], p, d, k, warp) : 0.0f;
  }
  __syncthreads();

  if (inside) {
    const double kv = double(repro::gram_entry(s1 + threadIdx.y * ld, s2 + threadIdx.x * ld,
                                               d, amp2));
    const double eye = i == j ? 1.0 : 0.0;
    // (k·mm + eye·(1 − mm)) + (eye·mm)·noise, each operation rounded as
    // torch rounds it
    out[((size_t)s * n + i) * n + j] =
        __dadd_rn(__dadd_rn(__dmul_rn(kv, mm), __dmul_rn(eye, __dsub_rn(1.0, mm))),
                  __dmul_rn(__dmul_rn(eye, mm), noise));
  }
}

__global__ void empty_kernel() {}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <typename K>
void allow_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
}

template <typename T>
int launch_gram(const void* x1, const void* x2, const void* inv_ell,
                const void* wa, const void* wb, const void* won,
                const void* amp2, void* out, int S, int n, int m, int d,
                void* stream) {
  const size_t smem = 2 * kTile * repro::odd_stride(d) * sizeof(T);
  allow_smem(gram_kernel<T>, smem);
  dim3 block(kTile, kTile);
  dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile, S);
  gram_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2),
      static_cast<const T*>(inv_ell), static_cast<const T*>(wa),
      static_cast<const T*>(wb), static_cast<const T*>(won),
      static_cast<const T*>(amp2), static_cast<T*>(out), n, m, d);
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

// xn (R, d), xt (at least idx rows of d), table (S, 3d + 2); out (S, R, m).
int matern52_cross_f64(const void* xn, const void* xt, const void* table, void* out,
                       int S, int R, int m, int d, int idx, int warp, void* stream) {
  const size_t smem = (size_t)(R + kRowTile) * repro::odd_stride(d) * sizeof(float);
  allow_smem(cross_rows_kernel, smem);
  dim3 grid((m + kRowTile - 1) / kRowTile, S);
  cross_rows_kernel<<<grid, kRowThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(xn), static_cast<const double*>(xt),
      static_cast<const double*>(table), static_cast<double*>(out), R, m, d, idx, warp);
  return (int)cudaGetLastError();
}

// x (n, d), table (S, 3d + 2), mask (n,) bool; out (S, n, n).
int matern52_operand_f64(const void* x, const void* table, const void* mask, void* out,
                         int S, int n, int d, int warp, double jitter, void* stream) {
  const size_t smem = 2 * (size_t)kTile * repro::odd_stride(d) * sizeof(float);
  allow_smem(operand_kernel, smem);
  dim3 block(kTile, kTile);
  dim3 grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile, S);
  operand_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<const double*>(table),
      static_cast<const unsigned char*>(mask), static_cast<double*>(out), n, d, warp, jitter);
  return (int)cudaGetLastError();
}

int matern52_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
