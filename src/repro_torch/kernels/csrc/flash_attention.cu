// Causal / sliding-window GQA attention with an online softmax (flash
// attention), prefill of the LM workload's attention blocks.
//
// Replaces src/repro/kernels/flash_attention/ops.py::flash_attention (its own
// GQA-addressed pallas_call, body kernel.py::_kernel) and
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas.
//
// What it computes, in the model's layout: q (B, S, Hq, Dh) against k, v
// (B, S, Hkv, Dh), out (B, S, Hq, Dh) in the inputs' type (bf16 or f32).
// Scores s = (q·k)·scale (Dh^-1/2, or a model's own), optionally
// soft-capped (cap·tanh(s/cap)), masked causally (k ≤ q) and, with
// window > 0, to the band q − k < window; the softmax is taken online in
// f32 (running max m, running sum l, f32 accumulator) and the output is
// acc / l; the bf16 body can also write the row log-sum-exp m + log l (f32,
// (B, Hq, S)), the one statistic training's backward needs
// (flash_attention_bwd.cu). KV head of query head h is
// h / (Hq / Hkv): KV rows are addressed, never expanded. Both bodies visit
// only the KV tiles that meet a block's band — tiles wholly outside the
// causal/window band are skipped, as the TPU kernel skips them
// (kernel.py:50–56) — so the work is what the band holds, not S². The
// ragged tail (S not a multiple of a tile) arrives as zeros in shared
// memory (the TMA's out-of-bounds fill in the bf16 body, bounds checks in
// the f32 body), never padded in device memory.
//
// What bounds it on this card: 4·Dh FLOPs per live (query, key) pair against
// q/k/v/o bytes — at the serving shape (Dh = 256, window 2048) about 1 KB of
// work per 2 bytes moved, far above the H100's ~295 FLOP/byte ridge: the
// operations, at the bf16 tensor-core peak.
//
// bf16 body (flash_wgmma, every served model): Hopper's warpgroup MMA fed
// by the tensor memory accelerator. A block of two warpgroups (256
// threads) owns kWgBQ = 128 query positions of one (batch, head), 64 a
// warpgroup: one m64 wgmma tile. Both share each staged K/V tile of 64
// keys: with 128 rows a block, the band of one batch element (3000 × 256 ×
// 2 B × 2 = 3 MB of K and V) is read from L2 half as often as with 64, and
// L2, not HBM, is what the re-reads cost. Per tile:
//   * one thread issues two TMA box copies (K and V, 64 keys × the whole
//     head) into the free one of two stages; an mbarrier counts their
//     bytes. The box of a (8, S, Dh/8, H, B) view of the tensor lands in
//     the no-swizzle core-matrix layout wgmma reads (attn_wgmma.cuh): no
//     thread computes an address, and keys past S and the head's padding
//     chunks (Dh 120 → 128) arrive as zeros;
//   * S = Q·Kᵀ: DP/16 wgmma m64n64k16, Q and K straight from shared memory
//     through descriptors; warpgroup 1 issues after warpgroup 0 (a named
//     barrier), so that one's softmax overlaps the other's MMAs;
//   * the elementwise mask runs only on tiles that cross the band's edge;
//     the running max and sum of a row come from the four lanes that share
//     it (quad shuffles); exponentials on the SFU in the exp2 domain; O is
//     rescaled only when some row's max rose;
//   * O += P·V: wgmma m64nDPk16 with P from the score registers as the A
//     operand (never through shared memory) and V as an MN-major B. P is
//     split into two bf16 parts, hi = bf16(p) and lo = bf16(p − hi), and
//     P·V runs on both: one bf16 rounding of P alone breaks the per-element
//     bound for rows over few keys (attn_mma.cuh); the split keeps ~16 bits
//     of P for 1.5× the MMAs.
// Budgets at Dh = 256: shared memory Q 2 × 32 KB + two stages of K and V,
// 4 × 32 KB = 192 KB, one block an SM; registers: the O accumulator is 64
// rows × 256 columns a warpgroup, 128 f32 a thread, plus 32 for the scores
// and 32 for P's two parts (203 in all, no spills). Dh must be a multiple
// of 8 (whole 16-byte chunks: the tensor map's strides) and at most 256,
// and the inputs 16-byte aligned (the wrapper checks).
//
// f32 body (flash_kernel, the f32 entry only): SIMT on the FMA units, the
// f32 tolerance (3e-5) being tighter than TF32 tensor cores could hold. A
// block owns kBQ = 32 consecutive query positions of one (batch, query
// head) and walks the KV tiles of kBK = 32 keys that meet its band. Eight
// warps own four query rows each. Per tile:
//   * the block stages K and V (converted to f32) in shared memory;
//   * lane j of a warp owns key j of the tile: it forms its four rows'
//     scores from float4 reads of its K row (row stride Dh + 4 floats, so the
//     eight lanes of each 16-byte phase hit distinct banks for every Dh that
//     is a multiple of 4) and broadcast float4 reads of the Q rows;
//   * the row max and the rescale factor come from warp shuffles; the running
//     sum l stays a per-lane partial until the end;
//   * P·V: each lane owns float4 groups of the head (lane + 32·g), and p_j is
//     broadcast from lane j by shuffle.
// Shared memory (f32): Q 32×Dh + K 32×(Dh+4) + V 32×Dh floats — at Dh = 256
// that is 32 + 33.3 + 32 = 97.3 KB, so two blocks (16 warps) fit in the
// 227 KB an SM offers. Dh must be a multiple of 4 and at most 256.
//
// Every entry point returns cudaGetLastError() after its launch (or the
// error of cudaFuncSetAttribute).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_wgmma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;             // query rows per warp
constexpr int kBQ = kWarps * kRows;  // query rows per block
constexpr int kBK = 32;              // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

// The SIMT body below is instantiated for f32 only (T = float).
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// G4: float4 groups of the head each lane owns in P·V, ceil(Dh / 128).
template <typename T, int G4>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int Hq,
             int Hkv, int dh, int window, float softcap, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  const int ldk = dh + 4;
  float* Ks = Qs + kBQ * dh;
  float* Vs = Ks + kBK * ldk;

  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nd4 = dh >> 2;

  for (int e = tid; e < kBQ * dh; e += kThreads) {
    const int r = e / dh;
    const int d = e - r * dh;
    const int pos = q0 + r;
    Qs[e] = pos < S ? to_f32(q[((size_t)(b * S + pos) * Hq + h) * dh + d]) : 0.f;
  }

  // KV tiles that meet the block's band [k_lo, k_hi]
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = q_last;

  float m[kRows], l[kRows];
  float4 acc[kRows][G4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int g = 0; g < G4; ++g) acc[r][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4* q4 = reinterpret_cast<const float4*>(Qs + warp * kRows * dh);

  for (int t = k_lo / kBK; t <= k_hi / kBK; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // Q staged; the previous tile consumed
    for (int e = tid; e < kBK * dh; e += kThreads) {
      const int j = e / dh;
      const int d = e - j * dh;
      const int pos = k0 + j;
      float kk = 0.f, vv = 0.f;
      if (pos < S) {
        const size_t off = ((size_t)(b * S + pos) * Hkv + kvh) * dh + d;
        kk = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      Ks[j * ldk + d] = kk;
      Vs[j * dh + d] = vv;
    }
    __syncthreads();

    // scores of this lane's key against the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(Ks + lane * ldk);
#pragma unroll 4
    for (int c = 0; c < nd4; ++c) {
      const float4 kv = k4[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = q4[r * nd4 + c];
        s[r] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r;
      float x = s[r] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      bool live = kpos <= qpos && qpos < S;
      if (window > 0) live = live && qpos - kpos < window;
      x = live ? x : -INFINITY;

      const float m_new = fmaxf(m[r], warp_max(x));
      float p = 0.f;
      if (m_new != -INFINITY) {  // warp-uniform: the row has a live key
        const float alpha = expf(m[r] - m_new);  // 0 while m was -inf
        p = live ? expf(x - m_new) : 0.f;
        l[r] = l[r] * alpha + p;
        m[r] = m_new;
#pragma unroll
        for (int g = 0; g < G4; ++g) {
          acc[r][g].x *= alpha;
          acc[r][g].y *= alpha;
          acc[r][g].z *= alpha;
          acc[r][g].w *= alpha;
        }
      }
      s[r] = p;
    }

    // P·V over the tile's keys
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pj[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pj[r] = __shfl_sync(kFull, s[r], j);
      const float4* v4 = reinterpret_cast<const float4*>(Vs + j * dh);
#pragma unroll
      for (int g = 0; g < G4; ++g) {
        const int c = lane + 32 * g;
        if (c < nd4) {
          const float4 vv = v4[c];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r][g].x += pj[r] * vv.x;
            acc[r][g].y += pj[r] * vv.y;
            acc[r][g].z += pj[r] * vv.z;
            acc[r][g].w += pj[r] * vv.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    const float inv = 1.f / fmaxf(warp_sum(l[r]), 1e-30f);
    if (qpos >= S) continue;
    T* o = out + ((size_t)(b * S + qpos) * Hq + h) * dh;
#pragma unroll
    for (int g = 0; g < G4; ++g) {
      const int c = lane + 32 * g;
      if (c < nd4) {
        o[4 * c + 0] = from_f32<T>(acc[r][g].x * inv);
        o[4 * c + 1] = from_f32<T>(acc[r][g].y * inv);
        o[4 * c + 2] = from_f32<T>(acc[r][g].z * inv);
        o[4 * c + 3] = from_f32<T>(acc[r][g].w * inv);
      }
    }
  }
}

template <typename T, int G4>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Hq, int Hkv, int dh, int window, float softcap,
           float scale, void* stream) {
  const size_t smem = (size_t)(kBQ * dh + kBK * (dh + 4) + kBK * dh) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, G4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  flash_kernel<T, G4><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Hq, Hkv, dh, window,
      softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int Hq, int Hkv, int dh, int window, float softcap,
             float scale, void* stream) {
  if (dh <= 128) {
    return launch<T, 1>(q, k, v, out, B, S, Hq, Hkv, dh, window, softcap, scale, stream);
  }
  return launch<T, 2>(q, k, v, out, B, S, Hq, Hkv, dh, window, softcap, scale, stream);
}

// ------------------------------------------------------------- bf16 body
constexpr int kWgThreads = 256;  // two warpgroups
constexpr int kWgBQ = 128;       // query rows per block: 64 a warpgroup
constexpr int kWgBK = attn::kBoxRows;  // keys per staged tile

template <int DP>
constexpr size_t wg_smem_bytes() {
  return (size_t)(kWgBQ + 4 * kWgBK) * DP * sizeof(__nv_bfloat16);
}

// DP: the head dim rounded up to a multiple of 16 (the MMA depth).
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
            float* __restrict__ lse, int S, int Hq, int Hkv, int dh, int window, float softcap,
            float scale) {
  using bf16 = __nv_bfloat16;
  // A box lands as [chunk][row][16 bytes]: chunk c of row r at c·CH + r·16.
  // Q, K (K-major): LBO = CH (next 8 of the head), SBO = 128 (next 8 rows);
  // V (MN-major): LBO = 128 (next 8 keys), SBO = CH (next 8 of the head).
  constexpr int CH = kWgBK * 16;        // bytes of one chunk column of a 64-row box
  constexpr int TILE = kWgBK * DP * 2;  // bytes of one 64-row box
  constexpr int NO = DP / 2;            // O accumulator registers a thread
  extern __shared__ __align__(128) uint4 smem_wg[];
  char* Qs = reinterpret_cast<char*>(smem_wg);  // two boxes, one a warpgroup
  char* Ks = Qs + 2 * TILE;                     // [2] boxes
  char* Vs = Ks + 2 * TILE;                     // [2] boxes
  __shared__ uint64_t full[2];  // a K/V stage has landed
  __shared__ uint64_t qbar;     // Q has landed

  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBQ;  // the longest bands first
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;

  const int q_last = min(q0 + kWgBQ, S) - 1;
  const int t_lo = (window > 0 ? max(0, q0 - window + 1) : 0) / kWgBK;
  const int t_hi = q_last / kWgBK;
  // keys past S, rows past S and the head's padding chunks arrive as zeros
  auto issue = [&](int t, int buf) {
    attn::mbar_expect_tx(&full[buf], 2 * TILE);
    attn::tma_box(Ks + buf * TILE, &kmap, t * kWgBK, kvh, b, &full[buf]);
    attn::tma_box(Vs + buf * TILE, &vmap, t * kWgBK, kvh, b, &full[buf]);
  };
  if (tid == 0) {
    attn::mbar_init(&full[0], 1);
    attn::mbar_init(&full[1], 1);
    attn::mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    attn::mbar_expect_tx(&qbar, 2 * TILE);
    attn::tma_box(Qs, &qmap, q0, h, b, &qbar);
    attn::tma_box(Qs + TILE, &qmap, q0 + kWgBK, h, b, &qbar);
    issue(t_lo, 0);
  }

  const float scale2 = scale * attn::kLog2e;
  const int c2 = 2 * (lane & 3);
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this lane's rows: row0, row0 + 8
  const char* qwg = Qs + wg * TILE;               // this warpgroup's 64 rows

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  attn::mbar_wait(&qbar, 0);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    attn::mbar_wait(&full[buf], ((t - t_lo) >> 1) & 1);
    __syncthreads();  // every warp is past tile t − 1: its buffer is free
    if (tid == 0 && t < t_hi) issue(t + 1, buf ^ 1);
    const char* kt = Ks + buf * TILE;
    const char* vt = Vs + buf * TILE;

    // S = Q·Kᵀ over the tile's 64 keys, one warpgroup MMA per 16 of the
    // head; warpgroup 1 issues after warpgroup 0, so that one's softmax
    // overlaps the other's MMAs
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    if (wg == 1) asm volatile("bar.sync 1, 256;\n" ::: "memory");
    attn::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      attn::wgmma_ss_n64(s, attn::wgmma_desc(qwg + kk * 2 * CH, CH, 128),
                         attn::wgmma_desc(kt + kk * 2 * CH, CH, 128));
    }
    attn::wgmma_commit();
    if (wg == 0) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    attn::wgmma_wait_all();
    attn::fence_regs(s);
    // scores in the exp2 domain, masked only on tiles that cross the band's
    // edge (block-uniform); s[4j + i] is row row0 + 8·(i / 2), key
    // k0 + 8j + c2 + i % 2
    const int k0 = t * kWgBK;
    const bool edge = k0 + kWgBK - 1 > q0 || (window > 0 && q0 + kWgBQ - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = softcap > 0.f ? attn::score_log2(s[4 * j + i], scale, softcap)
                                : s[4 * j + i] * scale2;
        if (edge) {
          const int qpos = row0 + (i >> 1) * 8;
          const int kpos = k0 + j * 8 + c2 + (i & 1);
          const bool live = kpos <= qpos && (window <= 0 || qpos - kpos < window);
          x = live ? x : -INFINITY;
        }
        s[4 * j + i] = x;
      }
    }

    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      const float m_new = fmaxf(m[r], attn::quad_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no live key yet
      alpha[r] = attn::exp2_fast(m[r] - m_use);              // 0 while m was -inf
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j + 2 * r] = attn::exp2_fast(s[4 * j + 2 * r] - m_use);
        s[4 * j + 2 * r + 1] = attn::exp2_fast(s[4 * j + 2 * r + 1] - m_use);
        sum += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
      }
      l[r] = l[r] * alpha[r] + sum;
    }
    if (__any_sync(attn::kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NO / 4; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
    }

    // O += P·V, P = hi + lo straight from the score registers
    unsigned ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      attn::split_bf16(s[8 * kk], s[8 * kk + 1], ph[kk][0], pl[kk][0]);
      attn::split_bf16(s[8 * kk + 2], s[8 * kk + 3], ph[kk][1], pl[kk][1]);
      attn::split_bf16(s[8 * kk + 4], s[8 * kk + 5], ph[kk][2], pl[kk][2]);
      attn::split_bf16(s[8 * kk + 6], s[8 * kk + 7], ph[kk][3], pl[kk][3]);
    }
    attn::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = attn::wgmma_desc(vt + kk * 256, 128, CH);
      attn::wgmma_rs(o, ph[kk], dv);
      attn::wgmma_rs(o, pl[kk], dv);
    }
    attn::wgmma_commit();
    attn::wgmma_wait_all();
    attn::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      attn::fence_regs(ph[kk]);
      attn::fence_regs(pl[kk]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    const float sum = attn::quad_sum(l[r]);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    if (qpos >= S) continue;
    if (lse != nullptr && (lane & 3) == 0) {
      lse[(size_t)blockIdx.y * S + qpos] = (m[r] + log2f(sum)) * attn::kLn2;
    }
    bf16* orow = out + ((size_t)(b * S + qpos) * Hq + h) * dh;
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      const int col = n * 8 + c2;
      if (col < dh) {
        *reinterpret_cast<unsigned*>(orow + col) =
            attn::pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
      }
    }
  }
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                 int S, int Hq, int Hkv, int dh, int window, float softcap, float scale,
                 void* stream) {
  CUtensorMap qmap, kmap, vmap;
  int err = attn::head_map<DP>(&qmap, q, B, S, Hq, dh);
  if (err == 0) err = attn::head_map<DP>(&kmap, k, B, S, Hkv, dh);
  if (err == 0) err = attn::head_map<DP>(&vmap, v, B, S, Hkv, dh);
  if (err != 0) return err;
  const size_t smem = wg_smem_bytes<DP>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kWgBQ - 1) / kWgBQ, B * Hq);
  flash_wgmma<DP><<<grid, kWgThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), lse, S, Hq, Hkv, dh, window, softcap,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* out, void* lse,
                        int B, int S, int Hq, int Hkv, int dh, int window,
                        float softcap, float scale, void* stream) {
  if (lse != nullptr) return (int)cudaErrorInvalidValue;  // the LSE is the bf16 body's
  return dispatch<float>(q, k, v, out, B, S, Hq, Hkv, dh, window, softcap, scale, stream);
}

// The tensor-core body only: a head dim it does not take is refused, never
// sent to the f32 body. lse: null (prefill) or (B, Hq, S) f32, the row
// log-sum-exp of the scaled (soft-capped) scores, which training's backward
// (flash_attention_bwd.cu) rebuilds P from.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                         int B, int S, int Hq, int Hkv, int dh, int window,
                         float softcap, float scale, void* stream) {
  if (dh < 8 || dh % 8 || dh > 256) return (int)cudaErrorInvalidValue;
#define FLASH_WGMMA(DP) \
  launch_wgmma<DP>(q, k, v, out, static_cast<float*>(lse), B, S, Hq, Hkv, dh, window, softcap, \
                   scale, stream)
  if (dh <= 64) return FLASH_WGMMA(64);
  if (dh <= 80) return FLASH_WGMMA(80);
  if (dh <= 96) return FLASH_WGMMA(96);
  if (dh <= 128) return FLASH_WGMMA(128);
  return FLASH_WGMMA(256);
#undef FLASH_WGMMA
}

}  // extern "C"
