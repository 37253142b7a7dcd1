// Tensor-core building blocks of the bf16 attention bodies: for
// decode_attention.cu, cp.async copies, ldmatrix fragment loads, the
// m16n8k16 bf16 MMA with f32 accumulation and the padded shared-memory tile
// layout it stages K, V and Q in; for both it and flash_attention.cu (whose
// wgmma, TMA and mbarrier helpers are in attn_wgmma.cuh), the split of P
// into two bf16 parts, quad reductions over the lanes that share an
// accumulator row, and the scores' exp2 domain.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane l holds, with
// g = l / 4 and c = 2·(l % 4),
//   A (16×16, row-major): a0 = (g, c..c+1), a1 = (g+8, c..c+1),
//                         a2 = (g, c+8..c+9), a3 = (g+8, c+8..c+9);
//   B (16×8, "col": stored n-major): b0 = (k c..c+1, n g), b1 = (k c+8..c+9, n g);
//   C/D (16×8, f32): d0, d1 = (g, c..c+1), d2, d3 = (g+8, c..c+1).
// So the accumulator of S = Q·Kᵀ over 16 keys (two n8 tiles) is, packed to
// bf16 pairs, the A fragment of P·V over those 16 keys: P never leaves
// registers. wgmma's m64 accumulator and register A operand give each warp
// of the warpgroup 16 rows in these same layouts.
//
// Shared tiles hold rows of DP bf16 values (the head dim rounded up to 16,
// the MMA depth; the columns past Dh are zeros) at a row stride of DP + 8
// values: DP/8 + 1 sixteen-byte chunks, an odd number, so the eight row
// addresses of one ldmatrix phase fall in eight distinct bank groups.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Row stride, in bf16 values, of a staged tile of padded width DP.
__host__ __device__ constexpr int tile_ld(int dp) { return dp + 8; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8×8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// d += a·b on the tensor cores (bf16 in, f32 accumulate).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Row addresses for an ldmatrix .x4 of the 16×16 block at (r0, c0) of a
// tile with row stride ld. a_rows: matrices (rows 0–7 | 8–15) × (cols 0–7 |
// 8–15), row half first — the A fragment of Q, and with .trans the B
// fragments (b0, b1) of V's columns c0..c0+7 then c0+8..c0+15 (rows =
// keys). k_rows: column half first — the B fragments (b0, b1) of K's rows
// (keys) r0..r0+7, then r0+8..r0+15.
__device__ __forceinline__ const __nv_bfloat16* a_rows(const __nv_bfloat16* t, int ld, int r0,
                                                       int c0, int lane) {
  return t + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 + (lane >> 4) * 8;
}

__device__ __forceinline__ const __nv_bfloat16* k_rows(const __nv_bfloat16* t, int ld, int r0,
                                                       int c0, int lane) {
  return t + (r0 + (lane & 7) + (lane >> 4) * 8) * ld + c0 + ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// p ≈ hi + lo, both bf16 pairs: hi = bf16(p), lo = bf16(p − hi). P·V runs
// once on each, so P keeps ~16 significant bits instead of bf16's 8: one
// bf16 rounding of P alone moves the output of a row over few keys past the
// per-element bound bf16 attention is held to (|Δ| ≤ 2^-7·|ref| + 2^-9).
__device__ __forceinline__ void split_bf16(float p0, float p1, unsigned& hi, unsigned& lo) {
  hi = pack_bf16(p0, p1);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack_bf16(p0 - h.x, p1 - h.y);
}

// 2^x on the special-function unit (2^-inf = 0).
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Score in the exp2 domain: (q·k)·scale, soft-capped when cap > 0, times
// log2(e).
__device__ __forceinline__ float score_log2(float s, float scale, float cap) {
  s *= scale;
  if (cap > 0.f) s = cap * tanhf(s / cap);
  return s * kLog2e;
}

// Zero the 16-byte chunks [from, to) of `rows` consecutive tile rows.
__device__ __forceinline__ void zero_chunks(__nv_bfloat16* t, int ld, int rows, int from, int to,
                                            int tid, int nthreads) {
  const int w = to - from;
  for (int e = tid; e < rows * w; e += nthreads) {
    const int r = e / w;
    *reinterpret_cast<uint4*>(t + r * ld + (from + e - r * w) * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
}

}  // namespace attn
