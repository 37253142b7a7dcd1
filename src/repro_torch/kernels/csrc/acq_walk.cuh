// The anchor-scoring walk shared by acq_score.cu and acq_score_multi.cu.
//
// The TPU kernels (src/repro/kernels/acq_score/kernel.py) share their warp,
// cross-gram and EI helpers between the single- and multi-head bodies; this
// header is that shared core for the two CUDA kernels. For GPHP sample s
// and anchor a it computes ‖L⁻¹K*ᵀ‖² and the M head means μ_h = α_h·K*,
// as one product [L⁻¹; αᵀ]·K*ᵀ whose L⁻¹ rows are squared and summed and
// whose α rows are kept.
//
// Design. The product [L⁻¹; αᵀ]·K*ᵀ runs on the FP64 tensor cores,
// mma.sync.m16n8k8.f64 (IEEE f64 FMAs; wgmma takes no f64), or for float on
// the FP32 FMA units with a register tile per lane fed by 16-byte shared
// loads, never TF32. A block has 8 warps; warp w owns 16-row tile w of its
// row block(s), the α rows (M ≤ 16 heads) are one more 16-row tile, so μ
// comes out of the same product as ‖v‖², and the triangle is skipped at
// the tile: tile r stops at k = 16r + 16. Chunks of BK = 16 train rows of
// L⁻¹ and α come through a three-stage cp.async ring, two chunks ahead.
// Two walks, picked by kernel.py::walk_plan:
//
// * Single (n ≤ 64: every bucket of the main path): one launch. A block
//   holds one sample × 32 anchors (8 for the re-rank's m ≤ 16) and one row
//   block covering all n rows. It warps its anchors and all rows, builds
//   every K* entry of its anchors once into shared memory (four entries a
//   thread at a time, so their square roots and exponentials overlap), then
//   runs the products; a single walk of at most three chunks loads them all
//   up front and waits once. Tile warps and the α warp split their anchors
//   over the warps left idle (4 groups at 16 rows, 2 at 32), and three
//   blocks fit an SM, so the grid runs in one wave.
// * Paired (n > 64): a first launch (warp_kernel) warps every sample's
//   anchors and rows once into the workspace, a second (kstar_kernel)
//   computes every K* entry once, written as K*ᵀ (S, n rounded to 16, m
//   rounded to 64); then the walk: a block holds one sample × 64 anchors
//   (each L⁻¹ element loaded feeds 64) × a pair of 128-row blocks (shorter
//   when the re-rank's grid must fill the card). Block 0 pairs α (warp 0's
//   first slot) with the last row block, whose chunks span every train row;
//   block p ≥ 1 pairs row blocks p − 1 and R − 1 − p, the triangle's short
//   and long rows, so the blocks do about the same work. Each chunk's K*ᵀ
//   tile rides the ring with its L⁻¹ rows, and the loop does no other
//   arithmetic. With more than one block along the rows, a last launch
//   (combine_kernel) sums their ‖v‖² in block order and finishes.
//
// Results are combined in a fixed order — a shuffle tree within a warp,
// warp order in shared memory, block order in combine_kernel — so a launch
// gives the same bits every run. Float walks that pair row blocks add the
// α rows' per-chunk sums into double running sums: a mean sums n products
// of both signs that cancel, and one f32 accumulator over n = 2048 of them
// missed the f32 bound where the plain version did not.
//
// Shared memory: 63,744 B for a single f64 block at n = 64, d = 6 (76,032
// at d = 20: three fit an SM's 228 KB); 161,280 B for a paired f64 block.
// The strides keep the f64 fragment loads (8-byte words, two wavefronts a
// warp) and the f32 tile loads free of bank conflicts. The wrapper sizes the
// workspace (85.7 MB at S = 10, m = n = 1024, f64) and raises, naming the
// limit, when a plan does not fit.
//
// Padding contract (the reference's): padded train rows have mask 0, α 0
// and identity rows of L⁻¹, so their K* entries are 0 and they add nothing.
// K* rows past n are 0; columns past n arrive as zeros (cp.async
// zero-fill); rows of a tile at or past n, and α rows past M, are never
// loaded and their product rows never read; anchors past m are warped as
// 0 and their results dropped.
#pragma once

#include "matern52_common.cuh"

namespace repro {
namespace walk {

constexpr int BK = 16;         // train rows (k) per chunk
constexpr int STAGES = 3;      // depth of the ring
constexpr int LDL = BK + 4;    // ring row stride of L⁻¹ and α, elements
constexpr int MAX_HEADS = 16;  // α rows: one 16-row tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int KROWS = 64;      // train rows a K* block
constexpr int ILP = 4;         // K* entries a thread computes at once

__host__ __device__ __forceinline__ int lda_of(int dp) { return dp | 1; }
__host__ __device__ __forceinline__ size_t round4(size_t x) { return (x + 3) & ~size_t(3); }
__host__ __device__ __forceinline__ int round_up(int n, int k) { return (n + k - 1) / k * k; }

// A walk block's shared memory (element offsets); kernel.py::smem_bytes
// mirrors the total. Single (one row block of at most 64 rows): the warped
// anchors and train rows and the mask (whose space the ‖v‖² partials and
// means reuse once K* is built), K* of every row, then a ring of α rows and
// the row block. Pairs: a ring of two row blocks (α in the first's rows for block
// 0) and the chunk's K*ᵀ tile, then the partials and means.
struct Layout {
  size_t as, xs, ms, ks, ring, red, mus, mu64, total;
  int lo_rows;      // rows of a stage's first region
  int kt;           // pairs: offset of a stage's K*ᵀ tile
  int stage_elems;  // a ring stage
  __host__ __device__ Layout(int ta, int bm, int n, int dp, bool single, int elem) {
    const int npad = round_up(n, BK);
    const size_t ends = round4((size_t)(bm / 16) * ta) + round4((size_t)MAX_HEADS * ta);
    lo_rows = single ? MAX_HEADS : bm;
    kt = (lo_rows + bm) * LDL;
    stage_elems = kt + (single ? 0 : BK * (ta + 4));
    as = 0;
    xs = round4((size_t)ta * lda_of(dp));
    ms = xs + round4((size_t)npad * dp);
    const size_t held = ms + round4((size_t)npad);
    ks = single ? (held > ends ? held : ends) : 0;
    ring = ks + (single ? round4((size_t)npad * (ta + 4)) : 0);
    red = single ? 0 : ring + round4((size_t)STAGES * stage_elems);
    mus = red + round4((size_t)(bm / 16) * ta);
    mu64 = single ? ring + round4((size_t)STAGES * stage_elems) : red + ends;
    // float, paired: the α rows' sums in double, MAX_HEADS × ta of them
    total = mu64 + (elem == 4 && !single ? (size_t)2 * MAX_HEADS * ta : 0);
  }
};

// Blocks along the rows of L⁻¹: one for α and the last row block, one for
// each further pair of row blocks; one in all for a single row block.
__host__ __device__ __forceinline__ int pairs_of(int n, int bm) {
  return 1 + (n + bm - 1) / bm / 2;  // 1 + ⌈(R − 1)/2⌉ for R = ⌈n / bm⌉ row blocks
}

// The workspace of a paired walk, in elements: K*ᵀ (S, npad, mpad); the
// warped anchors (S, mpad, dp) and rows (S, npad, dp); then with P > 1 the
// blocks' ‖v‖² partials (P, S, m) and the means (S, M, m). A single walk
// needs none.
struct Workspace {
  size_t kt, aw, xw, ss, mu, total;
  __host__ __device__ Workspace(int S, int m, int n, int dp, int M, int ta, int pairs) {
    const size_t npad = round_up(n, BK);
    const size_t mpad = round_up(m, ta);
    kt = 0;
    aw = round4(S * npad * mpad);
    xw = aw + round4(S * mpad * dp);
    ss = xw + round4(S * npad * dp);
    mu = ss + (pairs > 1 ? (size_t)pairs * S * m : 0);
    total = mu + (pairs > 1 ? (size_t)S * M * m : 0);
  }
};

// One row block of at most 64 rows: the block holds everything itself.
__host__ __device__ __forceinline__ bool is_single(int n, int bm) {
  return (n + bm - 1) / bm == 1 && bm <= 64;
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

// σ from amp² and ‖v‖²: sqrt(max(amp² − ‖v‖², 1e-12)).
template <typename T>
__device__ __forceinline__ T sigma_of(T a2, T ss) {
  const T var = a2 - ss;
  return f_sqrt(var < T(1e-12) ? T(1e-12) : var);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async; the bytes past src_bytes are written as 0 and not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D = A·B + D on the FP64 tensor cores, one 16 × 8 × 8 product. Fragments
// (lane = 4g + t): a_i at (g + 8(i & 1), t + 4(i >> 1)), b_i at (t + 4i, g),
// c_i at (g + 8(i >> 1), 2t + (i & 1)).
__device__ __forceinline__ void mma_f64_k8(double (&c)[4], const double (&a)[4],
                                           const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// One warp's accumulators: SLOTS 16-row tiles × TA = 8·NT anchors (its
// share of the block's; rows of mus and the double sums are ld apart). A slot
// holds a tile of L⁻¹ rows or the α tile. step() adds one 8-deep slice of
// each live slot's A (16 rows × LDL in shared memory) times K* (rows
// kk..kk+7 of the chunk, stride ldk); store_ss() writes Σ over the rows of
// the L⁻¹ slots of the square, per anchor; store_rows() writes the α slot's
// rows h < M.
template <typename T, int NT, int SLOTS>
struct Tile;

template <int NT, int SLOTS>
struct Tile<double, NT, SLOTS> {
  static constexpr int TA = 8 * NT;
  double c[SLOTS][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int u = 0; u < SLOTS; ++u)
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[u][q][i] = 0.0;
  }

  __device__ __forceinline__ void step(const double* const (&A)[SLOTS], const bool (&on)[SLOTS],
                                       const double* Kt, int ldk, int kk) {
    const int lane = threadIdx.x & 31;
    double a[SLOTS][4];
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      if (on[u]) {
        const double* p = A[u] + (lane >> 2) * LDL + kk + (lane & 3);
        a[u][0] = p[0];
        a[u][1] = p[8 * LDL];
        a[u][2] = p[4];
        a[u][3] = p[8 * LDL + 4];
      }
    }
    const double* kb = Kt + (kk + (lane & 3)) * ldk + (lane >> 2);
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const double b[2] = {kb[8 * q], kb[4 * ldk + 8 * q]};
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) {
        if (on[u]) mma_f64_k8(c[u][q], a[u], b);
      }
    }
  }

  __device__ __forceinline__ void store_ss(double* out, const int (&rows)[SLOTS]) const {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      double s0 = 0.0;
      double s1 = 0.0;
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) {
        // rows past the tile's live rows hold whatever the ring held: select, not scale
        const double a0 = g < rows[u] ? c[u][q][0] * c[u][q][0] : 0.0;
        const double a1 = g < rows[u] ? c[u][q][1] * c[u][q][1] : 0.0;
        const double b0 = g + 8 < rows[u] ? c[u][q][2] * c[u][q][2] : 0.0;
        const double b1 = g + 8 < rows[u] ? c[u][q][3] * c[u][q][3] : 0.0;
        s0 += a0 + b0;
        s1 += a1 + b1;
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (lane < 4) {
        out[8 * q + 2 * t] = s0;
        out[8 * q + 2 * t + 1] = s1;
      }
    }
  }

  // double accumulates in double already: nothing to flush
  __device__ __forceinline__ void flush_rows(double*, int, int, int) {}
  __device__ __forceinline__ void load_rows(const double*, int, int, int) {}

  __device__ __forceinline__ void store_rows(double* mus, int ld, int M, int u) const {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int v = 0; v < SLOTS; ++v) {
      if (v != u) continue;
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const int col = 8 * q + 2 * t;
        if (g < M) {
          mus[g * ld + col] = c[v][q][0];
          mus[g * ld + col + 1] = c[v][q][1];
        }
        if (g + 8 < M) {
          mus[(g + 8) * ld + col] = c[v][q][2];
          mus[(g + 8) * ld + col + 1] = c[v][q][3];
        }
      }
    }
  }
};

// float: lane (ry, cx) owns rows ry + RY·i and the QC adjacent anchors
// QC·cx .. QC·cx + QC − 1 of a tile. An 8-deep step reads each of its rows'
// 8 values and each k's QC anchors as 16-byte loads: 2·RI + 2·QC/4 loads
// a slot-pair feed 8·RI·QC FMAs a slot.
template <int NT, int SLOTS>
struct Tile<float, NT, SLOTS> {
  static constexpr int TA = 8 * NT;
  static constexpr int CX = NT == 1 ? 2 : (NT == 2 ? 4 : 8);  // lanes along the anchors
  static constexpr int RY = 32 / CX;          // lanes along the rows
  static constexpr int RI = 16 / RY;          // rows a lane
  static constexpr int QC = TA / CX;          // adjacent anchors a lane (4 or 8)
  float c[SLOTS][RI][QC];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int u = 0; u < SLOTS; ++u)
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int q = 0; q < QC; ++q) c[u][i][q] = 0.0f;
  }

  __device__ __forceinline__ void step(const float* const (&A)[SLOTS], const bool (&on)[SLOTS],
                                       const float* Kt, int ldk, int kk) {
    const int lane = threadIdx.x & 31;
    const int ry = lane / CX;
    const int cx = lane % CX;
    float a[SLOTS][RI][8];
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      if (on[u]) {
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float4* p = reinterpret_cast<const float4*>(A[u] + (ry + RY * i) * LDL + kk);
          const float4 lo = p[0];
          const float4 hi = p[1];
          a[u][i][0] = lo.x; a[u][i][1] = lo.y; a[u][i][2] = lo.z; a[u][i][3] = lo.w;
          a[u][i][4] = hi.x; a[u][i][5] = hi.y; a[u][i][6] = hi.z; a[u][i][7] = hi.w;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float b[QC];
#pragma unroll
      for (int q = 0; q < QC; q += 4) {
        const float4 v = *reinterpret_cast<const float4*>(Kt + (kk + k) * ldk + QC * cx + q);
        b[q] = v.x; b[q + 1] = v.y; b[q + 2] = v.z; b[q + 3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) {
        if (on[u]) {
#pragma unroll
          for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int q = 0; q < QC; ++q) c[u][i][q] = fmaf(a[u][i][k], b[q], c[u][i][q]);
        }
      }
    }
  }

  __device__ __forceinline__ void store_ss(float* out, const int (&rows)[SLOTS]) const {
    const int lane = threadIdx.x & 31;
    const int ry = lane / CX;
#pragma unroll
    for (int q = 0; q < QC; ++q) {
      float s = 0.0f;
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) {
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          s += ry + RY * i < rows[u] ? c[u][i][q] * c[u][i][q] : 0.0f;
        }
      }
#pragma unroll
      for (int o = CX; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane < CX) out[QC * lane + q] = s;
    }
  }

  // Add slot u's rows h < M (α: each a sum of one chunk's 16 products)
  // into their double running sums and restart them at 0. An α row sums
  // up to n products of both signs that cancel; one f32 accumulator over
  // all n would round ~n times at the magnitude of the terms.
  __device__ __forceinline__ void flush_rows(double* acc, int ld, int M, int u) {
    const int lane = threadIdx.x & 31;
    const int ry = lane / CX;
    const int cx = lane % CX;
#pragma unroll
    for (int v = 0; v < SLOTS; ++v) {
      if (v != u) continue;
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int h = ry + RY * i;
        if (h < M) {
#pragma unroll
          for (int q = 0; q < QC; ++q) {
            acc[h * ld + QC * cx + q] += (double)c[v][i][q];
            c[v][i][q] = 0.0f;
          }
        }
      }
    }
  }

  // Slot u's rows h < M from their double sums (after the last flush).
  __device__ __forceinline__ void load_rows(const double* acc, int ld, int M, int u) {
    const int lane = threadIdx.x & 31;
    const int ry = lane / CX;
    const int cx = lane % CX;
#pragma unroll
    for (int v = 0; v < SLOTS; ++v) {
      if (v != u) continue;
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int h = ry + RY * i;
        if (h < M) {
#pragma unroll
          for (int q = 0; q < QC; ++q) c[v][i][q] = (float)acc[h * ld + QC * cx + q];
        }
      }
    }
  }

  __device__ __forceinline__ void store_rows(float* mus, int ld, int M, int u) const {
    const int lane = threadIdx.x & 31;
    const int ry = lane / CX;
    const int cx = lane % CX;
#pragma unroll
    for (int v = 0; v < SLOTS; ++v) {
      if (v != u) continue;
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int h = ry + RY * i;
        if (h < M) {
#pragma unroll
          for (int q = 0; q < QC; ++q) mus[h * ld + QC * cx + q] = c[v][i][q];
        }
      }
    }
  }
};

// The walk's inputs, as packed by ops.py, and its plan.
template <typename T>
struct Walk {
  const T* anchors;  // (m, dp)
  const T* xt;       // (n, dp)
  const T* linv;     // (S, n, n)
  const T* alphas;   // (S, M, n)
  const T* mask;     // (n,)
  const T* inv_ell;  // (S, dp)
  const T* wa;       // (S, dp)
  const T* wb;       // (S, dp)
  const T* won;      // (S, dp)
  const T* amp2;     // (S,)
  T* ws;             // the Workspace
  int S, m, n, dp, M;
  int ta;            // anchors a block (64 or 8)
  int bm;            // rows of L⁻¹ per row block (16, 32, 64 or 128)
  int pairs;         // P: walk blocks along the rows, pairs_of(n, bm)

  __device__ __forceinline__ Workspace layout() const {
    return Workspace(S, m, n, dp, M, ta, pairs);
  }
  __device__ __forceinline__ int npad() const { return round_up(n, BK); }
  __device__ __forceinline__ int mpad() const { return round_up(m, ta); }
};

// Where the block's results are after walk_block: ‖v‖² of anchor a at
// ss[a], head h's mean at mu[h·TA + a].
template <typename T>
struct Result {
  const T* ss;
  const T* mu;
};

// Sample s's warp of feature f of x, scaled by 1/ℓ.
template <typename T>
__device__ __forceinline__ T warped(const Walk<T>& w, int s, T x, int f) {
  const size_t i = (size_t)s * w.dp + f;
  return warp_scale(x, w.wa[i], w.wb[i], w.won[i], w.inv_ell[i]);
}

// Features of sample s up to the last with 1/ℓ ≠ 0: the padded ones past
// it are 0 in every warped row, so a distance can stop there (adding their
// exact zeros changes nothing). One load a lane and a ballot; every lane
// of the warp must call it.
template <typename T>
__device__ __forceinline__ int live_dims(const Walk<T>& w, int s) {
  const int lane = threadIdx.x & 31;
  int d = 0;
  for (int f0 = 0; f0 < w.dp; f0 += 32) {
    const bool live = f0 + lane < w.dp && w.inv_ell[(size_t)s * w.dp + f0 + lane] != T(0);
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (mask != 0u) d = f0 + 32 - __clz(mask);
  }
  return d;
}

// Pairs: every sample's warped anchors (0 past m) and train rows (0 past
// n) into the workspace, each once.
template <typename T>
__global__ void warp_kernel(Walk<T> w) {
  const Workspace ws = w.layout();
  const int mpad = w.mpad();
  const int npad = w.npad();
  const size_t na = (size_t)w.S * mpad * w.dp;
  const size_t total = na + (size_t)w.S * npad * w.dp;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const bool anchor = e < na;
  const size_t r = anchor ? e : e - na;
  const int rows = anchor ? mpad : npad;
  const int s = (int)(r / ((size_t)rows * w.dp));
  const int row = (int)(r / w.dp) - s * rows;
  const int f = (int)(r % w.dp);
  T v = T(0);
  if (anchor && row < w.m) v = warped(w, s, w.anchors[(size_t)row * w.dp + f], f);
  if (!anchor && row < w.n) v = warped(w, s, w.xt[(size_t)row * w.dp + f], f);
  w.ws[(anchor ? ws.aw : ws.xw) + r] = v;
}

// K* of `rows` train rows from k0 (warped, stride dp, in Xs; their mask
// values in mask[0..rows)) and TA anchors (warped, stride lda, in As), 0
// past n: entry (j, a) to out[j·ld + a]; distances over the first dl
// features (live_dims).
// A thread computes ILP entries at once, their squared distances in one
// loop over the features (each summed in feature order, as gram_entry
// does), so the loads, square roots and exponentials of the ILP entries
// overlap.
template <typename T, int TA>
__device__ __forceinline__ void kstar_rows(T* out, int ld, const T* As, const T* Xs,
                                           const T* mask, const Walk<T>& w, T a2, int k0,
                                           int rows, int dl) {
  const int dp = w.dp;
  const int lda = lda_of(dp);
  const int total = rows * TA;
  for (int e0 = threadIdx.x; e0 < total; e0 += ILP * NTHREADS) {
    const T* pa[ILP];
    const T* px[ILP];
    T r2[ILP];
    T mk[ILP];
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      const int e = min(e0 + u * NTHREADS, total - 1);
      const int j = e / TA;
      pa[u] = As + (e - j * TA) * lda;
      px[u] = Xs + j * dp;
      mk[u] = k0 + j < w.n ? mask[j] : T(0);
      r2[u] = T(0);
    }
    // entries past total (a multiple of 32: whole warps) are not computed
    const int live = min(ILP, (total - e0 + NTHREADS - 1) / NTHREADS);
    for (int f = 0; f < dl; ++f) {
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        if (u < live) {
          const T diff = pa[u][f] - px[u][f];
          r2[u] += diff * diff;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      const int e = e0 + u * NTHREADS;
      const int j = e / TA;
      if (u < live) out[(size_t)j * ld + e - j * TA] = matern52(r2[u], a2) * mk[u];
    }
  }
}

// Pairs: K*ᵀ[s, j, a] for KROWS train rows × TA anchors a block (grid:
// anchor tiles × row tiles × samples) from the warped inputs in the
// workspace; 0 for rows past n.
template <typename T, int TA>
__global__ void __launch_bounds__(NTHREADS)
kstar_kernel(Walk<T> w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // TA × lda warped anchors
  const int lda = lda_of(w.dp);
  T* Xs = As + round4((size_t)TA * lda);  // KROWS × dp warped rows
  const Workspace ws = w.layout();
  const int s = blockIdx.z;
  const int a0 = blockIdx.x * TA;
  const int j0 = blockIdx.y * KROWS;
  const int mpad = w.mpad();
  const int npad = w.npad();
  for (int e = threadIdx.x; e < TA * w.dp; e += NTHREADS) {
    const int a = e / w.dp;
    As[a * lda + e - a * w.dp] = w.ws[ws.aw + ((size_t)s * mpad + a0) * w.dp + e];
  }
  const int rows = min(KROWS, npad - j0);
  for (int e = threadIdx.x; e < rows * w.dp; e += NTHREADS) {
    Xs[e] = w.ws[ws.xw + ((size_t)s * npad + j0) * w.dp + e];
  }
  __syncthreads();
  kstar_rows<T, TA>(w.ws + ws.kt + ((size_t)s * npad + j0) * mpad + a0, mpad, As, Xs,
                    w.mask + j0, w, w.amp2[s], j0, rows, live_dims(w, s));
}

// The block's rows. Single (one row block of at most 64 rows): the row
// block's tiles on warps 0 .. BM/16 − 1, α on the next warp. Pairs: block
// 0 holds α (slot 0 of warp 0) and the last row block (slot 1); block p ≥
// 1 holds row blocks p − 1 (slot 0) and R − 1 − p (slot 1, alone when they
// are the same block).
struct Rows {
  bool has_lo, has_alpha;
  int lo0, hi0, nch;
  __device__ Rows(int n, int bm, int p) {
    const int R = (n + bm - 1) / bm;
    const int lo = p - 1;
    const int hi = R - 1 - p;
    has_alpha = p == 0;
    has_lo = p > 0 && lo != hi;
    lo0 = lo * bm;
    hi0 = hi * bm;
    nch = (min(hi0 + bm, n) + BK - 1) / BK;
  }
};

// Issue the cp.async copies of chunk c into a ring stage: α (block 0) or
// the low row block's rows while the chunk is inside its triangle, the
// high row block's rows, and (pairs) the chunk's K*ᵀ tile.
template <typename T, int TA>
__device__ __forceinline__ void load_chunk(T* stage, const Walk<T>& w, const Rows& rw,
                                           const Layout& ly, const T* L, const T* al,
                                           const T* kt, int c) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int CPR = BK / EPC;        // copies per row of L⁻¹ or α
  constexpr int KPR = TA / EPC;        // copies per row of K*ᵀ
  const int bm = w.bm;
  const int n = w.n;
  const int k0 = c * BK;
  const int rows_lo = rw.has_alpha ? w.M : (rw.has_lo && k0 < rw.lo0 + bm ? bm : 0);
  const int rows_hi = min(bm, n - rw.hi0);
  const int total = (rows_lo + rows_hi) * CPR;
  for (int e = threadIdx.x; e < total; e += NTHREADS) {
    int r = e / CPR;
    const int q = e - r * CPR;
    const int k = k0 + q * EPC;
    const T* src;
    T* dst;
    if (r < rows_lo) {
      src = rw.has_alpha ? al + (size_t)r * n : L + (size_t)(rw.lo0 + r) * n;
      dst = stage + r * LDL;
    } else {
      r -= rows_lo;
      src = L + (size_t)(rw.hi0 + r) * n;
      dst = stage + (ly.lo_rows + r) * LDL;
    }
    const bool in = k < n;
    cp_async16(dst + q * EPC, in ? src + k : src, in ? 16 : 0);
  }
  if (kt == nullptr) return;  // single: K* is held whole
  const int mpad = w.mpad();
  for (int e = threadIdx.x; e < BK * KPR; e += NTHREADS) {
    const int j = e / KPR;
    const int q = e - j * KPR;
    cp_async16(stage + ly.kt + j * (TA + 4) + q * EPC, kt + (size_t)(k0 + j) * mpad + q * EPC,
               16);
  }
}

// Single: warp `rows` rows of dp-wide inputs of sample s (0 past `valid`
// rows): entry e of src to dst[(e / dp)·ld + e % dp], ILP values a thread
// at a time.
template <typename T>
__device__ __forceinline__ void warp_block(T* dst, int ld, const T* src, int rows, int valid,
                                           const Walk<T>& w, int s) {
  const int total = rows * w.dp;
  for (int e0 = threadIdx.x; e0 < total; e0 += ILP * NTHREADS) {
    T v[ILP];
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      const int e = e0 + u * NTHREADS;
      const int r = e / w.dp;
      v[u] = e < total && r < valid ? warped(w, s, src[e], e - r * w.dp) : T(0);
    }
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      const int e = e0 + u * NTHREADS;
      const int r = e / w.dp;
      if (e < total) dst[r * ld + e - r * w.dp] = v[u];
    }
  }
}

// Single, float: warp_block over the block's TA anchors (0 past m, to As
// with stride lda) and all npad rows (0 past n, to Xs) as one index space.
template <typename T>
__device__ __forceinline__ void warp_both(T* As, T* Xs, const Walk<T>& w, int s, int a0,
                                          int ta) {
  const int dp = w.dp;
  const int lda = lda_of(dp);
  const int na = ta * dp;
  const int total = na + round_up(w.n, BK) * dp;
  for (int e0 = threadIdx.x; e0 < total; e0 += ILP * NTHREADS) {
    T v[ILP];
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      const int e = e0 + u * NTHREADS;
      const bool anchor = e < na;
      const int i = anchor ? e : e - na;
      const int r = i / dp;
      const bool in = e < total && (anchor ? a0 + r < w.m : r < w.n);
      const T x = in ? (anchor ? w.anchors[(size_t)a0 * dp + i] : w.xt[i]) : T(0);
      v[u] = in ? warped(w, s, x, i - r * dp) : T(0);
    }
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      const int e = e0 + u * NTHREADS;
      if (e < na) {
        const int r = e / dp;
        As[r * lda + e - r * dp] = v[u];
      } else if (e < total) {
        Xs[e - na] = v[u];
      }
    }
  }
}

// The walk of block (anchor tile blockIdx.x, pair blockIdx.y, sample
// blockIdx.z) with 8 warps; pairs run after kstar_kernel. Every thread of
// the block must call it. With one pair it leaves the block's ‖v‖² and
// means in shared memory (the Result): ‖v‖² of anchor a is written by
// thread a, and the means before a barrier, so a caller whose thread a
// reads only ss[a] and mu[·] passes shared_end = false and skips the last
// barrier. With more pairs it writes them to the workspace and the Result
// is not to be read.
template <typename T, int NT, bool SINGLE, int G>
__device__ __forceinline__ Result<T> walk_block(const Walk<T>& w, T* smem, bool shared_end) {
  constexpr int TA = 8 * NT;
  constexpr int TW = TA / G;  // anchors a warp: a single walk's idle warps share the tiles
  constexpr int ldk = TA + 4;
  constexpr int SLOTS = SINGLE ? 1 : 2;
  static_assert(SINGLE || G == 1, "paired walks keep whole tiles on a warp");
  const int bm = w.bm;
  const int wr = bm / 16;  // warps with a row tile
  const int n = w.n;
  const int s = blockIdx.z;
  const int p = blockIdx.y;
  const int a0 = blockIdx.x * TA;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  const Layout ly(TA, bm, n, w.dp, SINGLE, sizeof(T));
  const Rows rw(n, bm, p);
  T* Ls = smem + ly.ring;
  T* red = smem + ly.red;
  T* mus = smem + ly.mus;
  // loaded now, so their latency passes while the copies are issued
  const T a2 = w.amp2[s];
  const int dl = SINGLE ? live_dims(w, s) : 0;
  const T* L = w.linv + (size_t)s * n * n;
  const T* al = w.alphas + (size_t)s * w.M * n;
  const T* kt = SINGLE ? nullptr
                       : w.ws + w.layout().kt + (size_t)s * w.npad() * w.mpad() + a0;

  // a single walk of at most STAGES chunks issues them all now and waits
  // for them once; otherwise the ring runs two chunks ahead
  const bool all_in = SINGLE && rw.nch <= STAGES;
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < rw.nch) load_chunk<T, TA>(Ls + c * ly.stage_elems, w, rw, ly, L, al, kt, c);
    if (all_in && c == STAGES - 2 && rw.nch == STAGES) {
      load_chunk<T, TA>(Ls + (STAGES - 1) * ly.stage_elems, w, rw, ly, L, al, kt, STAGES - 1);
    }
    cp_async_commit();
  }

  if (SINGLE) {  // warp the anchors and every row, then K* of every row
    const int npad = w.npad();
    T* As = smem + ly.as;
    T* Xs = smem + ly.xs;
    T* Ms = smem + ly.ms;  // first: its load then waits beside the warp's
    for (int r = tid; r < npad; r += NTHREADS) Ms[r] = r < n ? w.mask[r] : T(0);
    if constexpr (sizeof(T) == 4) {
      // float: the anchors' and the rows' loads in one pass, so their
      // latencies overlap (its transcendentals are cheap)
      warp_both(As, Xs, w, s, a0, TA);
    } else {
      warp_block(As, lda_of(w.dp), w.anchors + (size_t)a0 * w.dp, TA, w.m - a0, w, s);
      warp_block(Xs, w.dp, w.xt, npad, n, w, s);
    }
    __syncthreads();
    kstar_rows<T, TA>(smem + ly.ks, ldk, As, Xs, Ms, w, a2, 0, npad, dl);
  }

  // this warp's slots: where their rows sit in a stage, the k below which
  // they are on (a tile's last row + 1: the triangle), how many of their
  // rows are L⁻¹ rows below n (0 for α); which slot holds α (−1: none);
  // its tile (warps of a single walk: tile warp / G, anchors TW·(warp % G)
  // onward) and anchor offset
  int off[SLOTS];
  int lim[SLOTS];
  int live[SLOTS];
  int alpha_slot = -1;
  const int ti = SINGLE ? warp / G : warp;
  const int aoff = SINGLE ? TW * (warp % G) : 0;
  if (SINGLE) {
    off[0] = (ly.lo_rows + 16 * ti) * LDL;
    lim[0] = ti < wr && 16 * ti < n ? min(16 * ti + 16, n) : 0;
    live[0] = ti < wr ? max(0, min(16, n - 16 * ti)) : 0;
    if (ti == wr) {
      off[0] = 0;
      lim[0] = n;
      alpha_slot = 0;
    }
  } else {
    off[0] = 16 * warp * LDL;
    lim[0] = warp < wr && rw.has_lo ? rw.lo0 + 16 * warp + 16 : 0;
    live[0] = lim[0] > 0 ? 16 : 0;
    if (warp == 0 && rw.has_alpha) {
      lim[0] = n;
      live[0] = 0;
      alpha_slot = 0;
    }
    const int r1 = rw.hi0 + 16 * warp;
    off[SLOTS - 1] = (ly.lo_rows + 16 * warp) * LDL;
    lim[SLOTS - 1] = warp < wr && r1 < n ? min(r1 + 16, n) : 0;
    live[SLOTS - 1] = warp < wr ? max(0, min(16, n - r1)) : 0;
  }

  Tile<T, NT / G, SLOTS> tile;
  tile.zero();
  // float, paired: an α row sums up to n products (a single walk's at most
  // 64 need no help)
  constexpr bool WIDE = sizeof(T) == 4 && !SINGLE;
  double* mu64 = reinterpret_cast<double*>(smem + ly.mu64);
  if (WIDE && alpha_slot >= 0) {  // this warp's own sums
    for (int e = tid & 31; e < w.M * TW; e += 32) mu64[(e / TW) * TA + aoff + e % TW] = 0.0;
    __syncwarp();
  }
  for (int c = 0; c < rw.nch; ++c) {
    if (!all_in) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
    } else if (c == 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!all_in && c + STAGES - 1 < rw.nch) {
      load_chunk<T, TA>(Ls + ((c + STAGES - 1) % STAGES) * ly.stage_elems, w, rw, ly, L, al, kt,
                        c + STAGES - 1);
    }
    cp_async_commit();
    const T* stage = Ls + (c % STAGES) * ly.stage_elems;
    const T* A[SLOTS];
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) A[u] = stage + off[u];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      bool on[SLOTS];
      bool any = false;
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) {
        on[u] = c * BK + kk < lim[u];
        any = any || on[u];
      }
      if (any) {
        tile.step(A, on, (SINGLE ? smem + ly.ks + c * BK * ldk : stage + ly.kt) + aoff, ldk, kk);
      }
    }
    if (WIDE && alpha_slot >= 0) tile.flush_rows(mu64 + aoff, TA, w.M, alpha_slot);
  }
  cp_async_wait<0>();
  if (WIDE && alpha_slot >= 0) {
    __syncwarp();
    tile.load_rows(mu64 + aoff, TA, w.M, alpha_slot);
  }

  if (ti < wr) tile.store_ss(red + ti * TA + aoff, live);
  if (alpha_slot >= 0) tile.store_rows(mus + aoff, TA, w.M, alpha_slot);
  __syncthreads();
  // ‖v‖² per anchor, warps summed in order, into red[a]
  for (int a = tid; a < TA; a += NTHREADS) {
    T ss = T(0);
    for (int r = 0; r < wr; ++r) ss += red[r * TA + a];
    red[a] = ss;
    if (w.pairs > 1 && a0 + a < w.m) {
      w.ws[w.layout().ss + ((size_t)p * w.S + s) * w.m + a0 + a] = ss;
      if (rw.has_alpha) {
        T* mu = w.ws + w.layout().mu + (size_t)s * w.M * w.m + a0 + a;
        for (int h = 0; h < w.M; ++h) mu[(size_t)h * w.m] = mus[h * TA + a];
      }
    }
  }
  if (shared_end) __syncthreads();
  return Result<T>{red, mus};
}

// ‖v‖² of (sample s, anchor a) from the P blocks' partials, in block order,
// and the address of its head-0 mean (head h at + h·m).
template <typename T>
__device__ __forceinline__ T combined_ss(const Walk<T>& w, int s, int a) {
  const T* ss = w.ws + w.layout().ss;
  T v = T(0);
  for (int p = 0; p < w.pairs; ++p) v += ss[((size_t)p * w.S + s) * w.m + a];
  return v;
}

template <typename T>
__device__ __forceinline__ const T* combined_mu(const Walk<T>& w, int s, int a) {
  return w.ws + w.layout().mu + (size_t)s * w.M * w.m + a;
}

// Shared memory of a K* block.
__host__ __device__ __forceinline__ size_t kstar_smem_elems(int ta, int dp) {
  return round4((size_t)ta * lda_of(dp)) + (size_t)KROWS * dp;
}

// Launch (pairs) warp_kernel and kstar_kernel, then `kernel` — the walk —
// on the grid of anchor tiles × pairs × samples with `smem` bytes; the
// caller then launches its combine pass when P > 1.
template <typename T, int NT, bool SINGLE, typename Kernel, typename... Args>
__host__ int launch_walk(Kernel kernel, const Walk<T>& w, long long smem, cudaStream_t stream,
                         Args... args) {
  constexpr int TA = 8 * NT;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int npad = round_up(w.n, BK);
  const int mpad = round_up(w.m, TA);
  if constexpr (!SINGLE) {
    const size_t total = (size_t)w.S * (mpad + npad) * w.dp;
    warp_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(w);
    const size_t ksmem = kstar_smem_elems(TA, w.dp) * sizeof(T);
    if (ksmem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kstar_kernel<T, TA>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ksmem);
      if (err != cudaSuccess) return (int)err;
    }
    kstar_kernel<T, TA><<<dim3(mpad / TA, (npad + KROWS - 1) / KROWS, w.S), NTHREADS, ksmem,
                          stream>>>(w);
  }
  const dim3 grid(mpad / TA, w.pairs, w.S);
  kernel<<<grid, NTHREADS, smem, stream>>>(w, args...);
  return (int)cudaGetLastError();
}

// The plan's checks: tile sizes the kernels take (32 anchors a single
// block, 64 paired, 8 either way) and shared memory enough.
template <typename T>
__host__ bool plan_ok(int ta, int bm, int dp, int n, int M, long long smem) {
  const bool single = is_single(n, bm);
  return (ta == 8 || ta == (single ? 32 : 64)) &&
         (bm == 16 || bm == 32 || bm == 64 || bm == 128) && dp % 8 == 0 && n % 8 == 0 &&
         M >= 1 && M <= MAX_HEADS &&
         smem >= (long long)(Layout(ta, bm, n, dp, single, sizeof(T)).total * sizeof(T));
}

}  // namespace walk
}  // namespace repro
