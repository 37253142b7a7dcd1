// Backward of causal / sliding-window GQA flash attention, for training.
//
// Replaces no TPU kernel: the JAX package trains attention through XLA,
// which fuses its plain composition; this is the port's counterpart of that
// fusion, the backward of flash_attention.cu's bf16 body (which writes the
// row log-sum-exp this file rebuilds the probabilities from).
//
// What it computes, in the model's layout: given q (B, S, Hq, Dh), k, v
// (B, S, Hkv, Dh), the forward's output o and its gradient do (B, S, Hq,
// Dh), all bf16, and the forward's row log-sum-exp lse (B, Hq, S) f32:
//   P  = exp(x − lse), x = (q·k)·scale, soft-capped to cap·tanh(x/cap) when
//        cap > 0, masked causally and to the window as the forward masks;
//   D  = rowsum(do ∘ o)                                   (kernel a, f32)
//   dV = Σ_g Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ∘ (dP − D) · (1 − tanh²),
//   dK = Σ_g dSᵀ·Q·scale                                  (kernel b)
//   dQ = dS·K·scale                                       (kernel c)
// with Σ_g the sum over the G = Hq / Hkv query heads of a KV head's group.
// dq, dk, dv are bf16. Nothing of size S² touches device memory: every
// block rebuilds the P tiles it needs from q, k and the LSE.
//
// Deterministic: no atomics. Each output element is summed in f32
// registers by one thread and written once: dK and dV by the block that
// owns the key tile, over the group's heads and query tiles in a fixed
// order; dQ by the block that owns the query tile. Two runs give the same
// bits.
//
// What bounds it on this card: the gradient needs S, dP, dV, dK and dQ once,
// 10·Dh FLOPs per live (query, key) pair, against q/k/v/o/do bytes read a
// few times — at training's shapes (Dh 64 or 128, S 1024–4096) hundreds of
// FLOPs a byte, over the ~295 FLOP/byte ridge: the operations, at the bf16
// tensor-core peak. This design does 14·Dh: (c) forms S and dP again (4·Dh)
// so that (b) and (c) each write their outputs once, with no atomics.
//
// Both MMA kernels are built like the forward's bf16 body: a block of two
// warpgroups (256 threads), 64 rows a warpgroup (one m64 wgmma tile), tiles
// of 64 rows × the whole head brought by TMA boxes into the no-swizzle
// core-matrix layout (attn_wgmma.cuh) and fed straight to wgmma through
// descriptors, a ring of two stages, one thread issuing the copies, every
// accumulator in f32 registers, the probabilities packed from the score
// registers into wgmma's register A operand (never through shared memory),
// and the elementwise mask only on tiles that cross the band's edge.
//   (b) dK/dV: a block owns 128 keys of one (batch, KV head). K and V stay
//       in shared memory; the block walks, for each of the group's G query
//       heads, the query tiles its keys meet (causal: from the keys on; with
//       a window, up to the last key + window − 1). Per tile: Sᵀ = K·Qᵀ and
//       dPᵀ = V·dOᵀ (m64n64, both operands from shared memory); Pᵀ and dSᵀ
//       in registers; dV += Pᵀ·dO and dK += dSᵀ·Q (m64nDP, A from
//       registers, dO and Q read MN-major from the same boxes). The LSE and
//       D of a tile's 64 queries are staged by 64 threads, loaded one tile
//       ahead and stored after the tile's MMAs (+inf and 0 past S, so those
//       queries give P = 0).
//   (c) dQ: a block owns 128 queries of one (batch, query head), with their
//       Q and dO in shared memory, and walks the key tiles of its band as
//       the forward does. Per tile: S = Q·Kᵀ and dP = dO·Vᵀ, dS in
//       registers, dQ += dS·K (K read MN-major from its box).
// Budgets at Dh = 128: shared memory 8 boxes of 16 KB (128 KB); registers
// of (b): dK and dV, 64 rows × 128 columns a warpgroup, 128 f32 a thread,
// plus 64 for Sᵀ and dPᵀ. Past 128 (up to 256, as the forward) neither fits
// whole: a block then writes 128 of the output's columns (blockIdx.z picks
// which), rebuilding Sᵀ and dPᵀ (or S and dP) over the whole head for each
// half, and its ring has one stage — 6 boxes of 32 KB (192 KB). Dh must be
// a multiple of 8 and at most 256; the inputs 16-byte aligned (the wrapper
// checks).
//
// Every entry point returns cudaGetLastError() after its launch (or the
// error of cudaFuncSetAttribute or of a tensor map).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;           // two warpgroups
constexpr int kBR = attn::kBoxRows;     // 64 rows: one box, one warpgroup's tile
constexpr int kBlockRows = 2 * kBR;     // keys (b) or queries (c) a block
constexpr int kDotThreads = 256;     // (a): 32 rows a block

// The score in the exp2 domain, as the forward forms it (score_log2), and
// dc = d(capped score)/d(scaled score): 1 − tanh² with a cap, else 1.
__device__ __forceinline__ float score_grad(float s, float scale, float scale2, float cap,
                                            float& dc) {
  if (cap > 0.f) {
    const float t = tanhf(s * scale / cap);
    dc = 1.f - t * t;
    return cap * t * attn::kLog2e;
  }
  dc = 1.f;
  return s * scale2;
}

// (a) D = rowsum(dO ∘ O): eight threads a row (b, s, h), 16-byte loads,
// rows in memory order.
__global__ void __launch_bounds__(kDotThreads)
bwd_dot(const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ delta,
        int rows, int S, int Hq, int dh) {
  const int sub = threadIdx.x & 7;
  const int row = blockIdx.x * (kDotThreads / 8) + (threadIdx.x >> 3);
  float acc = 0.f;
  if (row < rows) {
    for (int c = sub * 8; c < dh; c += 64) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + (size_t)row * dh + c);
      const uint4 g = *reinterpret_cast<const uint4*>(dout + (size_t)row * dh + c);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(a2[i]);
        const float2 y = __bfloat1622float2(g2[i]);
        acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
      }
    }
  }
  acc += __shfl_xor_sync(attn::kFull, acc, 4);
  acc += __shfl_xor_sync(attn::kFull, acc, 2);
  acc += __shfl_xor_sync(attn::kFull, acc, 1);
  if (row < rows && sub == 0) {
    const int h = row % Hq;
    const int bs = row / Hq;
    delta[((size_t)(bs / S) * Hq + h) * S + bs % S] = acc;
  }
}

// Pack 32 accumulator values (rows × 64 columns, m64n64 layout) into the
// register A operand of four k16 steps over those columns.
__device__ __forceinline__ void pack_a(const float (&x)[32], unsigned (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = attn::pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = attn::pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = attn::pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = attn::pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// Output columns a block writes, and the stages of its ring, at a padded
// head dim DP (see the budgets above).
template <int DP>
__host__ __device__ constexpr int out_cols() { return DP > 128 ? 128 : DP; }
template <int DP>
__host__ __device__ constexpr int ring_stages() { return DP > 128 ? 1 : 2; }

// Four resident boxes and two rings of boxes, and the LSE/D staging of (b).
template <int DP>
constexpr size_t mma_smem_bytes() {
  return (size_t)(4 + 2 * ring_stages<DP>()) * kBR * DP * sizeof(bf16) +
         4 * kBR * sizeof(float);
}

// (b) dK, dV of 128 keys of one (batch, KV head).
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
         const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
         bf16* __restrict__ dv, int S, int Hq, int Hkv, int dh, int window, float softcap,
         float scale) {
  constexpr int CH = kBR * 16;       // bytes of one chunk column of a box
  constexpr int TILE = kBR * DP * 2;  // bytes of one box
  constexpr int NO = out_cols<DP>() / 2;  // dK (and dV) accumulator registers a thread
  constexpr int ST = ring_stages<DP>();
  extern __shared__ __align__(128) uint4 smem_kv[];
  char* Ks = reinterpret_cast<char*>(smem_kv);  // two boxes, one a warpgroup
  char* Vs = Ks + 2 * TILE;                     // two boxes
  char* Qs = Vs + 2 * TILE;                     // [ST] stages
  char* Ds = Qs + ST * TILE;                    // [ST] stages of dO
  float* lse_s = reinterpret_cast<float*>(Ds + ST * TILE);  // [2][64], log2 domain
  float* dlt_s = lse_s + 2 * kBR;                          // [2][64]
  __shared__ uint64_t full[2];  // a Q/dO stage has landed
  __shared__ uint64_t kvbar;    // K and V have landed

  const int G = Hq / Hkv;
  const int b = blockIdx.y / Hkv;
  const int kvh = blockIdx.y - b * Hkv;
  const int k0 = blockIdx.x * kBlockRows;  // the longest bands first
  const int c_out = blockIdx.z * out_cols<DP>();  // this block's first output column
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;

  const int k_last = min(k0 + kBlockRows, S) - 1;
  const int t_lo = k0 / kBR;
  const int t_hi = (window > 0 ? min(S - 1, k_last + window - 1) : S - 1) / kBR;
  const int nt = t_hi - t_lo + 1;
  const int n_it = G * nt;  // iteration it: head kvh·G + it / nt, query tile t_lo + it % nt

  auto issue = [&](int it, int buf) {
    const int h = kvh * G + it / nt;
    const int q0 = (t_lo + it % nt) * kBR;
    attn::mbar_expect_tx(&full[buf], 2 * TILE);
    attn::tma_box(Qs + buf * TILE, &qmap, q0, h, b, &full[buf]);
    attn::tma_box(Ds + buf * TILE, &dmap, q0, h, b, &full[buf]);
  };
  // LSE (log2 domain) and D of query row tid of iteration it's tile
  auto stats = [&](int it, float& l2, float& d) {
    const int h = kvh * G + it / nt;
    const int q = (t_lo + it % nt) * kBR + tid;
    const size_t off = ((size_t)b * Hq + h) * S + q;
    l2 = q < S ? lse[off] * attn::kLog2e : INFINITY;
    d = q < S ? delta[off] : 0.f;
  };
  if (tid == 0) {
    attn::mbar_init(&full[0], 1);
    attn::mbar_init(&full[1], 1);
    attn::mbar_init(&kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    attn::mbar_expect_tx(&kvbar, 4 * TILE);
    attn::tma_box(Ks, &kmap, k0, kvh, b, &kvbar);
    attn::tma_box(Ks + TILE, &kmap, k0 + kBR, kvh, b, &kvbar);
    attn::tma_box(Vs, &vmap, k0, kvh, b, &kvbar);
    attn::tma_box(Vs + TILE, &vmap, k0 + kBR, kvh, b, &kvbar);
    issue(0, 0);
  }
  if (tid < kBR) stats(0, lse_s[tid], dlt_s[tid]);

  const float scale2 = scale * attn::kLog2e;
  const int c2 = 2 * (lane & 3);
  const int krow0 = k0 + warp * 16 + (lane >> 2);  // this lane's keys: krow0, krow0 + 8
  const char* kwg = Ks + wg * TILE;
  const char* vwg = Vs + wg * TILE;

  float dka[NO], dva[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  attn::mbar_wait(&kvbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int buf = it % ST;  // the ring's stage
    const int sb = it & 1;    // the LSE/D stage
    attn::mbar_wait(&full[buf], (it / ST) & 1);
    __syncthreads();  // every warp is past iteration it − 1: the other stage is free
    float next_l2 = 0.f, next_d = 0.f;
    if (it + 1 < n_it) {
      if (ST == 2 && tid == 0) issue(it + 1, buf ^ 1);
      if (tid < kBR) stats(it + 1, next_l2, next_d);
    }
    const char* qt = Qs + buf * TILE;
    const char* dt = Ds + buf * TILE;
    const int q0 = (t_lo + it % nt) * kBR;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: this warpgroup's 64 keys × the tile's 64
    // queries; warpgroup 1 issues after warpgroup 0, so that one's
    // elementwise work overlaps the other's MMAs
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      st[i] = 0.f;
      dpt[i] = 0.f;
    }
    if (wg == 1) asm volatile("bar.sync 1, 256;\n" ::: "memory");
    attn::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      attn::wgmma_ss_n64(st, attn::wgmma_desc(kwg + kk * 2 * CH, CH, 128),
                         attn::wgmma_desc(qt + kk * 2 * CH, CH, 128));
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      attn::wgmma_ss_n64(dpt, attn::wgmma_desc(vwg + kk * 2 * CH, CH, 128),
                         attn::wgmma_desc(dt + kk * 2 * CH, CH, 128));
    }
    attn::wgmma_commit();
    if (wg == 0) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    attn::wgmma_wait_all();
    attn::fence_regs(st);
    attn::fence_regs(dpt);

    // st[4j + i] is key krow0 + 8·(i / 2), query q0 + 8j + c2 + i % 2;
    // Pᵀ into st, dSᵀ (without the scale) into dpt
    const bool edge = k0 + kBlockRows - 1 > q0 || (window > 0 && q0 + kBR - 1 - k0 >= window);
    const float* ls = lse_s + sb * kBR;
    const float* ds = dlt_s + sb * kBR;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + c2);
      const float2 dd = *reinterpret_cast<const float2*>(ds + 8 * j + c2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float dc;
        const float x = score_grad(st[4 * j + i], scale, scale2, softcap, dc);
        float p = attn::exp2_fast(x - ((i & 1) ? l2.y : l2.x));
        if (edge) {
          const int kpos = krow0 + (i >> 1) * 8;
          const int qpos = q0 + 8 * j + c2 + (i & 1);
          const bool live = kpos <= qpos && (window <= 0 || qpos - kpos < window);
          p = live ? p : 0.f;
        }
        st[4 * j + i] = p;
        dpt[4 * j + i] = p * (dpt[4 * j + i] - ((i & 1) ? dd.y : dd.x)) * dc;
      }
    }

    // dV += Pᵀ·dO, dK += dSᵀ·Q over this block's columns: A from
    // registers, dO and Q MN-major
    unsigned pa[4][4], da[4][4];
    pack_a(st, pa);
    pack_a(dpt, da);
    const char* dtc = dt + c_out / 8 * CH;
    const char* qtc = qt + c_out / 8 * CH;
    attn::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      attn::wgmma_rs(dva, pa[kk], attn::wgmma_desc(dtc + kk * 256, 128, CH));
      attn::wgmma_rs(dka, da[kk], attn::wgmma_desc(qtc + kk * 256, 128, CH));
    }
    attn::wgmma_commit();
    attn::wgmma_wait_all();
    attn::fence_regs(dva);
    attn::fence_regs(dka);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      attn::fence_regs(pa[kk]);
      attn::fence_regs(da[kk]);
    }
    if (it + 1 < n_it && tid < kBR) {
      lse_s[(sb ^ 1) * kBR + tid] = next_l2;
      dlt_s[(sb ^ 1) * kBR + tid] = next_d;
    }
    if (ST == 1 && it + 1 < n_it) {
      __syncthreads();  // both warpgroups' MMAs have read the one stage
      if (tid == 0) issue(it + 1, 0);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = krow0 + r * 8;
    if (kpos >= S) continue;
    const size_t off = ((size_t)(b * S + kpos) * Hkv + kvh) * dh;
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      const int col = c_out + n * 8 + c2;
      if (col < dh) {
        *reinterpret_cast<unsigned*>(dk + off + col) =
            attn::pack_bf16(dka[4 * n + 2 * r] * scale, dka[4 * n + 2 * r + 1] * scale);
        *reinterpret_cast<unsigned*>(dv + off + col) =
            attn::pack_bf16(dva[4 * n + 2 * r], dva[4 * n + 2 * r + 1]);
      }
    }
  }
}

// (c) dQ of 128 queries of one (batch, query head).
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
       const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
       const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
       int S, int Hq, int Hkv, int dh, int window, float softcap, float scale) {
  constexpr int CH = kBR * 16;
  constexpr int TILE = kBR * DP * 2;
  constexpr int NO = out_cols<DP>() / 2;
  constexpr int ST = ring_stages<DP>();
  extern __shared__ __align__(128) uint4 smem_q[];
  char* Qs = reinterpret_cast<char*>(smem_q);  // two boxes, one a warpgroup
  char* Ds = Qs + 2 * TILE;                    // two boxes of dO
  char* Ks = Ds + 2 * TILE;                    // [ST] stages
  char* Vs = Ks + ST * TILE;                   // [ST] stages
  __shared__ uint64_t full[2];  // a K/V stage has landed
  __shared__ uint64_t qbar;     // Q and dO have landed

  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockRows;  // the longest bands first
  const int c_out = blockIdx.z * out_cols<DP>();  // this block's first output column
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;

  const int q_last = min(q0 + kBlockRows, S) - 1;
  const int t_lo = (window > 0 ? max(0, q0 - window + 1) : 0) / kBR;
  const int t_hi = q_last / kBR;
  auto issue = [&](int t, int buf) {
    attn::mbar_expect_tx(&full[buf], 2 * TILE);
    attn::tma_box(Ks + buf * TILE, &kmap, t * kBR, kvh, b, &full[buf]);
    attn::tma_box(Vs + buf * TILE, &vmap, t * kBR, kvh, b, &full[buf]);
  };
  if (tid == 0) {
    attn::mbar_init(&full[0], 1);
    attn::mbar_init(&full[1], 1);
    attn::mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    attn::mbar_expect_tx(&qbar, 4 * TILE);
    attn::tma_box(Qs, &qmap, q0, h, b, &qbar);
    attn::tma_box(Qs + TILE, &qmap, q0 + kBR, h, b, &qbar);
    attn::tma_box(Ds, &dmap, q0, h, b, &qbar);
    attn::tma_box(Ds + TILE, &dmap, q0 + kBR, h, b, &qbar);
    issue(t_lo, 0);
  }

  const float scale2 = scale * attn::kLog2e;
  const int c2 = 2 * (lane & 3);
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this lane's rows: row0, row0 + 8
  const char* qwg = Qs + wg * TILE;
  const char* dwg = Ds + wg * TILE;
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    const size_t off = (size_t)blockIdx.y * S + qpos;
    l2[r] = qpos < S ? lse[off] * attn::kLog2e : INFINITY;
    dd[r] = qpos < S ? delta[off] : 0.f;
  }

  float dqa[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dqa[i] = 0.f;

  attn::mbar_wait(&qbar, 0);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) % ST;
    attn::mbar_wait(&full[buf], ((t - t_lo) / ST) & 1);
    __syncthreads();  // every warp is past tile t − 1: its stage is free
    if (ST == 2 && tid == 0 && t < t_hi) issue(t + 1, buf ^ 1);
    const char* kt = Ks + buf * TILE;
    const char* vt = Vs + buf * TILE;

    // S = Q·Kᵀ and dP = dO·Vᵀ over the tile's 64 keys
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    if (wg == 1) asm volatile("bar.sync 1, 256;\n" ::: "memory");
    attn::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      attn::wgmma_ss_n64(s, attn::wgmma_desc(qwg + kk * 2 * CH, CH, 128),
                         attn::wgmma_desc(kt + kk * 2 * CH, CH, 128));
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      attn::wgmma_ss_n64(dp, attn::wgmma_desc(dwg + kk * 2 * CH, CH, 128),
                         attn::wgmma_desc(vt + kk * 2 * CH, CH, 128));
    }
    attn::wgmma_commit();
    if (wg == 0) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    attn::wgmma_wait_all();
    attn::fence_regs(s);
    attn::fence_regs(dp);

    // s[4j + i] is row row0 + 8·(i / 2), key k0 + 8j + c2 + i % 2; dS
    // (without the scale) into dp
    const int k0 = t * kBR;
    const bool edge = k0 + kBR - 1 > q0 || (window > 0 && q0 + kBlockRows - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float dc;
        const float x = score_grad(s[4 * j + i], scale, scale2, softcap, dc);
        float p = attn::exp2_fast(x - l2[i >> 1]);
        if (edge) {
          const int qpos = row0 + (i >> 1) * 8;
          const int kpos = k0 + 8 * j + c2 + (i & 1);
          const bool live = kpos <= qpos && (window <= 0 || qpos - kpos < window);
          p = live ? p : 0.f;
        }
        dp[4 * j + i] = p * (dp[4 * j + i] - dd[i >> 1]) * dc;
      }
    }

    // dQ += dS·K over this block's columns: A from registers, K MN-major
    unsigned da[4][4];
    pack_a(dp, da);
    const char* ktc = kt + c_out / 8 * CH;
    attn::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      attn::wgmma_rs(dqa, da[kk], attn::wgmma_desc(ktc + kk * 256, 128, CH));
    }
    attn::wgmma_commit();
    attn::wgmma_wait_all();
    attn::fence_regs(dqa);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) attn::fence_regs(da[kk]);
    if (ST == 1 && t < t_hi) {
      __syncthreads();  // both warpgroups' MMAs have read the one stage
      if (tid == 0) issue(t + 1, 0);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    if (qpos >= S) continue;
    bf16* qrow = dq + ((size_t)(b * S + qpos) * Hq + h) * dh;
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      const int col = c_out + n * 8 + c2;
      if (col < dh) {
        *reinterpret_cast<unsigned*>(qrow + col) =
            attn::pack_bf16(dqa[4 * n + 2 * r] * scale, dqa[4 * n + 2 * r + 1] * scale);
      }
    }
  }
}

template <int DP>
int maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v, const void* dout,
         int B, int S, int Hq, int Hkv, int dh) {
  int err = attn::head_map<DP>(&m[0], q, B, S, Hq, dh);
  if (err == 0) err = attn::head_map<DP>(&m[1], k, B, S, Hkv, dh);
  if (err == 0) err = attn::head_map<DP>(&m[2], v, B, S, Hkv, dh);
  if (err == 0) err = attn::head_map<DP>(&m[3], dout, B, S, Hq, dh);
  return err;
}

template <int DP>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dk, void* dv, int B, int S, int Hq, int Hkv, int dh,
                int window, float softcap, float scale, void* stream) {
  CUtensorMap m[4];
  const int err = maps<DP>(m, q, k, v, dout, B, S, Hq, Hkv, dh);
  if (err != 0) return err;
  const size_t smem = mma_smem_bytes<DP>();
  const cudaError_t e = cudaFuncSetAttribute(
      bwd_dkdv<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kBlockRows - 1) / kBlockRows, B * Hkv, DP / out_cols<DP>());
  bwd_dkdv<DP><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Hq, Hkv, dh, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int S, int Hq, int Hkv, int dh, int window,
              float softcap, float scale, void* stream) {
  CUtensorMap m[4];
  const int err = maps<DP>(m, q, k, v, dout, B, S, Hq, Hkv, dh);
  if (err != 0) return err;
  const size_t smem = mma_smem_bytes<DP>();
  const cudaError_t e = cudaFuncSetAttribute(
      bwd_dq<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kBlockRows - 1) / kBlockRows, B * Hq, DP / out_cols<DP>());
  bwd_dq<DP><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), S, Hq, Hkv, dh, window, softcap, scale);
  return (int)cudaGetLastError();
}

bool head_dim_ok(int dh) { return dh >= 8 && dh % 8 == 0 && dh <= 256; }

}  // namespace

extern "C" {

// (a) delta (B, Hq, S) f32 = rowsum(dout ∘ o).
int flash_attention_bwd_dot_bf16(const void* o, const void* dout, void* delta, int B, int S,
                                 int Hq, int dh, void* stream) {
  if (!head_dim_ok(dh)) return (int)cudaErrorInvalidValue;
  const int rows = B * S * Hq;
  if (rows == 0) return 0;
  const int per_block = kDotThreads / 8;
  bwd_dot<<<(rows + per_block - 1) / per_block, kDotThreads, 0,
            static_cast<cudaStream_t>(stream)>>>(static_cast<const bf16*>(o),
                                                 static_cast<const bf16*>(dout),
                                                 static_cast<float*>(delta), rows, S, Hq, dh);
  return (int)cudaGetLastError();
}

#define BWD_DISPATCH(LAUNCH)                 \
  if (!head_dim_ok(dh)) return (int)cudaErrorInvalidValue; \
  if (dh <= 64) return LAUNCH(64);           \
  if (dh <= 80) return LAUNCH(80);           \
  if (dh <= 96) return LAUNCH(96);           \
  if (dh <= 128) return LAUNCH(128);         \
  return LAUNCH(256);

// (b) dk, dv (B, S, Hkv, Dh) bf16.
int flash_attention_bwd_dkdv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int B,
                                  int S, int Hq, int Hkv, int dh, int window, float softcap,
                                  float scale, void* stream) {
#define DKDV(DP) \
  launch_dkdv<DP>(q, k, v, dout, lse, delta, dk, dv, B, S, Hq, Hkv, dh, window, softcap, scale, \
                  stream)
  BWD_DISPATCH(DKDV)
#undef DKDV
}

// (c) dq (B, S, Hq, Dh) bf16.
int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int B, int S,
                                int Hq, int Hkv, int dh, int window, float softcap, float scale,
                                void* stream) {
#define DQ(DP) \
  launch_dq<DP>(q, k, v, dout, lse, delta, dq, B, S, Hq, Hkv, dh, window, softcap, scale, stream)
  BWD_DISPATCH(DQ)
#undef DQ
}

#undef BWD_DISPATCH

}  // extern "C"
