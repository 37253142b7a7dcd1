// Flash-decode: one query token per sequence against a KV cache with a
// per-slot validity mask, G grouped query heads per KV head, optional soft
// cap. The LM workload's single-token attention.
//
// Replaces src/repro/kernels/decode_attention/ops.py::decode_attention →
// src/repro/kernels/decode_attention/kernel.py::decode_attention_pallas
// (body _kernel).
//
// What it computes, in the model's layout: q (B, Hq, Dh) against k, v
// (B, C, Hkv, Dh) with valid (B, C) (bool, one byte a slot), out (B, Hq, Dh)
// in the inputs' type (bf16 or f32). Scores s = (q·k)·Dh^-1/2, optionally
// soft-capped (cap·tanh(s/cap)), masked to the valid slots; the softmax is
// taken online in f32 and out = acc / max(l, 1e-30). Query head h reads KV
// head h / G (G = Hq / Hkv): KV rows are addressed, never expanded. A row
// with no valid slot gives 0, as the TPU kernel does (its safe max keeps
// p = 0 and l = 0); the JAX oracle gives the mean of V there (ROADMAP C9).
//
// Two passes. A partial pass: a block owns up to 16 query heads of one
// (batch, KV head) and one split of the cache — a contiguous run of tiles —
// and writes the split's running max, sum and accumulator (f32) to
// scratch. Splitting C fills the card when B·Hkv is small (4 blocks at
// recurrentgemma-9b's decode shape); the wrapper picks the split count.
// Then decode_combine: a block per (batch, query head) merges the splits:
// M = max m_s, out = Σ e^(m_s−M)·acc_s / max(Σ e^(m_s−M)·l_s, 1e-30); a
// split with no valid slot (m = −∞, l = 0) drops out, so an empty row
// gives 0. The ragged tail (C not a multiple of a tile) is bounds-checked
// and staged as zeros, never padded in device memory.
//
// What bounds it on this card: bytes — every K and V row is read once
// (4·Dh FLOPs per (head, slot) against 2·Dh·(bytes per element) per KV
// head and slot, far below the ~295 FLOP/byte ridge).
//
// bf16 partial pass (decode_mma, every served model): the G heads are the
// rows of an m16 tile (padded with zero rows), so Q·Kᵀ and P·V run as
// mma.sync m16n8k16 on the tensor cores. A tile is 64 keys; each of the
// four warps owns 16 of them, so every warp computes at every G, and keeps
// its own (m, l, O) over its keys; the four merge in shared memory at the
// end of the split. Tiles arrive by cp.async into a ring of three stages
// (two in flight while one is used: 64 KB at Dh = 128, 128 KB at 256,
// beyond the ~25 KB an SM needs in flight to stream at the HBM rate), and
// the tile's validity bytes travel with it in the same stage: the 16-byte
// granules that hold them, so no load of the mask waits inside the compute
// loop. P is split into bf16 hi + lo as in flash_attention.cu (attn_mma.cuh).
// Shared memory at Dh = 256: Q 16×264×2 + 3 stages × K, V 64×264×2 = 207 KB
// (one block an SM); at Dh = 128, 107 KB (two). Dh a multiple of 8 and at
// most 256; q, k, v 16-byte aligned (the wrapper checks).
//
// f32 partial pass (decode_partial, the f32 entry only): SIMT. A block owns
// up to 16 query heads — four warps of four heads — and 32-key tiles,
// copied raw with cp.async, double-buffered. Lane j of a warp owns key j:
// its four heads' scores come from 16-byte reads of its K row (row stride
// an odd number of 16-byte chunks, so the eight lanes of each phase hit
// distinct banks) against broadcast reads of Q, staged in f32; row max and
// rescale by warp shuffles; the sum l stays a per-lane partial. P·V: each
// lane owns 16-byte chunks of the head (lane + 32·i) and p_j is broadcast
// from lane j. Dh a multiple of 4 and at most 256.
//
// Every entry point returns cudaGetLastError() after its launches (or the
// error of cudaFuncSetAttribute).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;                       // query heads per warp
constexpr int kRowsPerBlock = kWarps * kRows;  // query heads per block
constexpr int kBK = 32;                        // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr int kCombineThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// Elements of T per 16-byte chunk, and their widening to f32 (the SIMT
// body is instantiated for f32 only).
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int E = 4;
  __device__ static __forceinline__ void unpack(const uint4 r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static __forceinline__ float to_f32(float x) { return x; }
  __device__ static __forceinline__ float from_f32(float x) { return x; }
};
// bf16 only as decode_combine's output type
template <>
struct Vec<__nv_bfloat16> {
  __device__ static __forceinline__ __nv_bfloat16 from_f32(float x) {
    return __float2bfloat16(x);
  }
};

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

using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;

// Row stride of a staged tile, in 16-byte chunks: odd, so that the eight
// lanes of a 16-byte phase reading eight rows hit distinct banks.
__host__ __device__ __forceinline__ int tile_ld(int nch) { return nch | 1; }

// NG: 16-byte chunks of the head each lane owns in P·V, ceil(nch / 32).
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const uint8_t* __restrict__ valid,
               float* __restrict__ part_m, float* __restrict__ part_l,
               float* __restrict__ part_acc, int C, int Hq, int Hkv, int dh,
               int tiles_per_split, float softcap, float scale) {
  constexpr int E = Vec<T>::E;
  extern __shared__ uint4 smem16[];
  const int nch = dh / E;
  const int ld = tile_ld(nch);
  uint4* Ks = smem16;             // [2][kBK][ld]
  uint4* Vs = Ks + 2 * kBK * ld;  // [2][kBK][ld]
  float* Qs = reinterpret_cast<float*>(Vs + 2 * kBK * ld);  // [kRowsPerBlock][dh]

  const int G = Hq / Hkv;
  const int split = blockIdx.x;
  const int bh = blockIdx.y;  // b·Hkv + kv head
  const int b = bh / Hkv;
  const int kvh = bh - b * Hkv;
  const int g0 = blockIdx.z * kRowsPerBlock;
  const int R = gridDim.y * G;  // B·Hq rows of the output
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < kRowsPerBlock * dh; e += kThreads) {
    const int r = e / dh;
    const int g = g0 + r;
    Qs[e] = g < G ? Vec<T>::to_f32(q[((size_t)b * Hq + kvh * G + g) * dh + (e - r * dh)])
                  : 0.f;
  }

  const int tiles = (C + kBK - 1) / kBK;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(tiles, t_begin + tiles_per_split);

  // copy tile t into buffer buf: rows past C are zeros, so P·V never reads
  // anything but data
  auto issue = [&](int t, int buf) {
    uint4* kd = Ks + buf * kBK * ld;
    uint4* vd = Vs + buf * kBK * ld;
    for (int e = tid; e < kBK * nch; e += kThreads) {
      const int j = e / nch;
      const int ch = e - j * nch;
      const int pos = t * kBK + j;
      if (pos < C) {
        const size_t off = ((size_t)(b * C + pos) * Hkv + kvh) * dh + ch * E;
        cp_async16(kd + j * ld + ch, k + off);
        cp_async16(vd + j * ld + ch, v + off);
      } else {
        kd[j * ld + ch] = make_uint4(0u, 0u, 0u, 0u);
        vd[j * ld + ch] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };

  float m[kRows], l[kRows];
  float acc[kRows][NG][E];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][i][e] = 0.f;
    }
  }
  // warp-uniform: does this warp own a live query head?
  const bool warp_live = g0 + warp * kRows < G;
  const float* qw = Qs + warp * kRows * dh;

  if (t_begin < t_end) issue(t_begin, 0);
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      issue(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q, on the first pass) visible to all

    if (warp_live) {
      const uint4* kt = Ks + buf * kBK * ld;
      const uint4* vt = Vs + buf * kBK * ld;
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = 0.f;
      const uint4* krow = kt + lane * ld;
#pragma unroll 2
      for (int ch = 0; ch < nch; ++ch) {
        float kf[E];
        Vec<T>::unpack(krow[ch], kf);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4* q4 = reinterpret_cast<const float4*>(qw + r * dh + ch * E);
#pragma unroll
          for (int i = 0; i < E / 4; ++i) {
            const float4 qv = q4[i];
            s[r] += qv.x * kf[4 * i] + qv.y * kf[4 * i + 1] + qv.z * kf[4 * i + 2] +
                    qv.w * kf[4 * i + 3];
          }
        }
      }

      const int pos = t * kBK + lane;
      const bool live = pos < C && valid[(size_t)b * C + pos] != 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float x = s[r] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x = live ? x : -INFINITY;
        const float m_new = fmaxf(m[r], warp_max(x));
        float p = 0.f;
        if (m_new != -INFINITY) {  // warp-uniform: the row has a live slot
          const float alpha = expf(m[r] - m_new);  // 0 while m was -inf
          p = live ? expf(x - m_new) : 0.f;
          l[r] = l[r] * alpha + p;
          m[r] = m_new;
#pragma unroll
          for (int i = 0; i < NG; ++i) {
#pragma unroll
            for (int e = 0; e < E; ++e) acc[r][i][e] *= alpha;
          }
        }
        s[r] = p;
      }

#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        float pj[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) pj[r] = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const int ch = lane + 32 * i;
          if (ch < nch) {
            float vf[E];
            Vec<T>::unpack(vt[j * ld + ch], vf);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
#pragma unroll
              for (int e = 0; e < E; ++e) acc[r][i][e] += pj[r] * vf[e];
            }
          }
        }
      }
    }
    __syncthreads();  // tile t consumed before its buffer is refilled
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float lsum = warp_sum(l[r]);
    const int g = g0 + warp * kRows + r;
    if (g >= G) continue;
    const size_t idx = (size_t)split * R + (size_t)bh * G + g;
    if (lane == 0) {
      part_m[idx] = m[r];
      part_l[idx] = lsum;
    }
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int ch = lane + 32 * i;
      if (ch < nch) {
#pragma unroll
        for (int e = 0; e < E; ++e) part_acc[idx * dh + ch * E + e] = acc[r][i][e];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
               const float* __restrict__ part_acc, T* __restrict__ out, int R,
               int dh, int nsplit) {
  extern __shared__ float w[];  // [nsplit]: e^(m_s − M)
  const int row = blockIdx.x;
  float M = -INFINITY;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, part_m[(size_t)s * R + row]);
  for (int s = threadIdx.x; s < nsplit; s += kCombineThreads) {
    w[s] = M == -INFINITY ? 0.f : expf(part_m[(size_t)s * R + row] - M);
  }
  __syncthreads();
  float L = 0.f;
  for (int s = 0; s < nsplit; ++s) L += w[s] * part_l[(size_t)s * R + row];
  const float denom = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < dh; d += kCombineThreads) {
    float o = 0.f;
    for (int s = 0; s < nsplit; ++s) o += w[s] * part_acc[((size_t)s * R + row) * dh + d];
    out[(size_t)row * dh + d] = Vec<T>::from_f32(o / denom);
  }
}

template <typename T, int NG>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, void* part_m, void* part_l, void* part_acc, int B, int C,
           int Hq, int Hkv, int dh, int nsplit, int tiles_per_split,
           float softcap, float scale, void* stream) {
  const int nch = dh / Vec<T>::E;
  const size_t smem = (size_t)4 * kBK * tile_ld(nch) * 16 +
                      (size_t)kRowsPerBlock * dh * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial<T, NG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = Hq / Hkv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nsplit, B * Hkv, (G + kRowsPerBlock - 1) / kRowsPerBlock);
  decode_partial<T, NG><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), C, Hq, Hkv, dh,
      tiles_per_split, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine<T><<<B * Hq, kCombineThreads, nsplit * sizeof(float), st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<T*>(out), B * Hq, dh, nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* valid,
             void* out, void* part_m, void* part_l, void* part_acc, int B, int C,
             int Hq, int Hkv, int dh, int nsplit, int tiles_per_split,
             float softcap, float scale, void* stream) {
  if (dh / Vec<T>::E <= 32) {
    return launch<T, 1>(q, k, v, valid, out, part_m, part_l, part_acc, B, C, Hq, Hkv,
                        dh, nsplit, tiles_per_split, softcap, scale, stream);
  }
  return launch<T, 2>(q, k, v, valid, out, part_m, part_l, part_acc, B, C, Hq, Hkv,
                      dh, nsplit, tiles_per_split, softcap, scale, stream);
}

// ------------------------------------------------------ bf16 partial pass
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaBK = kMmaWarps * 16;  // keys per tile: 16 a warp
constexpr int kMmaRows = 16;            // query heads per block: one m16 tile
constexpr int kStages = 3;
constexpr int kMaskBytes = kMmaBK + 16;  // the 16-byte granules holding a tile's mask

template <int DP>
constexpr size_t mma_smem_bytes() {
  return (size_t)(kMmaRows + 2 * kStages * kMmaBK) * attn::tile_ld(DP) * sizeof(__nv_bfloat16) +
         kStages * kMaskBytes;
}

// DP: the head dim rounded up to a multiple of 16 (the MMA depth).
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
decode_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ valid,
           float* __restrict__ part_m, float* __restrict__ part_l, float* __restrict__ part_acc,
           int C, int Hq, int Hkv, int dh, int tiles_per_split, float softcap, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = attn::tile_ld(DP);
  constexpr int NT = DP / 8;  // n8 tiles of the head in P·V
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  extern __shared__ uint4 smem_mma[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_mma);  // [kMmaRows][LD]
  bf16* Ks = Qs + kMmaRows * LD;                 // [kStages][kMmaBK][LD]
  bf16* Vs = Ks + kStages * kMmaBK * LD;         // [kStages][kMmaBK][LD]
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Vs + kStages * kMmaBK * LD);  // [kStages][kMaskBytes]

  const int G = Hq / Hkv;
  // KV heads on the fastest grid axis: blocks that run together read the
  // neighbouring heads of the same slots, adjacent in device memory
  const int bh = blockIdx.x;  // b·Hkv + kv head
  const int split = blockIdx.y;
  const int b = bh / Hkv;
  const int kvh = bh - b * Hkv;
  const int g0 = blockIdx.z * kMmaRows;
  const int R = gridDim.x * G;  // B·Hq rows of the output
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nch = dh / 8;  // 16-byte chunks of a row in device memory

  if (nch < DP / 8) {
    attn::zero_chunks(Qs, LD, kMmaRows + 2 * kStages * kMmaBK, nch, DP / 8, tid, kMmaThreads);
  }
  for (int e = tid; e < kMmaRows * nch; e += kMmaThreads) {
    const int r = e / nch;
    const int c = e - r * nch;
    bf16* dst = Qs + r * LD + c * 8;
    if (g0 + r < G) {
      attn::cp_async16(dst, q + ((size_t)b * Hq + kvh * G + g0 + r) * dh + c * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = zero;
    }
  }

  const int tiles = (C + kMmaBK - 1) / kMmaBK;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(tiles, t_begin + tiles_per_split);
  const uint8_t* vrow = valid + (size_t)b * C;

  // copy tile t into stage st: K and V rows past C are zeros; the mask
  // bytes of keys t·64.. as the aligned 16-byte granules that hold them
  // (a granule never crosses a page, so reading one whole is safe).
  // Commits a group even with nothing to copy, so that every iteration
  // waits on the same count.
  auto issue = [&](int t, int st) {
    if (t < t_end) {
      bf16* kd = Ks + st * kMmaBK * LD;
      bf16* vd = Vs + st * kMmaBK * LD;
      for (int e = tid; e < kMmaBK * nch; e += kMmaThreads) {
        const int j = e / nch;
        const int c = e - j * nch;
        const int pos = t * kMmaBK + j;
        const int o = j * LD + c * 8;
        if (pos < C) {
          const size_t off = ((size_t)(b * C + pos) * Hkv + kvh) * dh + c * 8;
          attn::cp_async16(kd + o, k + off);
          attn::cp_async16(vd + o, v + off);
        } else {
          *reinterpret_cast<uint4*>(kd + o) = zero;
          *reinterpret_cast<uint4*>(vd + o) = zero;
        }
      }
      const uintptr_t first = reinterpret_cast<uintptr_t>(vrow + t * kMmaBK);
      const uintptr_t last = first + min(kMmaBK, C - t * kMmaBK) - 1;
      const uintptr_t base = first & ~uintptr_t(15);
      if (tid <= (int)(((last & ~uintptr_t(15)) - base) / 16)) {
        attn::cp_async16(Ms + st * kMaskBytes + tid * 16,
                         reinterpret_cast<const void*>(base + tid * 16));
      }
    }
    attn::cp_async_commit();
  };

  const float scale2 = scale * attn::kLog2e;
  const int c2 = 2 * (lane & 3);
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  issue(t_begin, 0);  // with Q
  issue(t_begin + 1, 1);
  for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
    const int st = i % kStages;
    attn::cp_async_wait<1>();
    __syncthreads();  // tile t visible to all; tile t − 1 consumed
    issue(t + 2, (i + 2) % kStages);
    const bf16* kt = Ks + (st * kMmaBK + warp * 16) * LD;
    const bf16* vt = Vs + (st * kMmaBK + warp * 16) * LD;
    const uint8_t* mt = Ms + st * kMaskBytes +
                        (reinterpret_cast<uintptr_t>(vrow + t * kMmaBK) & 15) + warp * 16;
    const int kpos0 = t * kMmaBK + warp * 16;

    // S = Q·Kᵀ over this warp's 16 keys
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      unsigned a[4], bk[4];
      attn::ldsm_x4(a, attn::a_rows(Qs, LD, 0, kk * 16, lane));
      attn::ldsm_x4(bk, attn::k_rows(kt, LD, 0, kk * 16, lane));
      attn::mma_bf16(s[0], a, bk[0], bk[1]);
      attn::mma_bf16(s[1], a, bk[2], bk[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + c2 + (e & 1);
        const bool live = kpos0 + key < C && mt[key] != 0;
        const float x =
            softcap > 0.f ? attn::score_log2(s[j][e], scale, softcap) : s[j][e] * scale2;
        s[j][e] = live ? x : -INFINITY;
      }
    }

    // online softmax of rows lane / 4 (e = 0, 1) and lane / 4 + 8 (e = 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                             fmaxf(s[1][2 * r], s[1][2 * r + 1]));
      const float m_new = fmaxf(m[r], attn::quad_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no live slot yet
      const float alpha = attn::exp2_fast(m[r] - m_use);     // 0 while m was -inf
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][2 * r] = attn::exp2_fast(s[j][2 * r] - m_use);
        s[j][2 * r + 1] = attn::exp2_fast(s[j][2 * r + 1] - m_use);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    // O += P·V over the 16 keys, P = hi + lo
    unsigned ph[4], pl[4];
    attn::split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
    attn::split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
    attn::split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
    attn::split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int nn = 0; nn < DP / 16; ++nn) {
      unsigned bv[4];
      attn::ldsm_x4_trans(bv, attn::a_rows(vt, LD, 0, nn * 16, lane));
      attn::mma_bf16(o[2 * nn], ph, bv[0], bv[1]);
      attn::mma_bf16(o[2 * nn + 1], ph, bv[2], bv[3]);
      attn::mma_bf16(o[2 * nn], pl, bv[0], bv[1]);
      attn::mma_bf16(o[2 * nn + 1], pl, bv[2], bv[3]);
    }
  }

  // merge the four warps' (m, l, O) through shared memory (the stages are
  // free once every copy has landed and every warp is past its last tile)
  attn::cp_async_wait<0>();
  __syncthreads();
  float* Os = reinterpret_cast<float*>(Ks);  // [kMmaWarps][kMmaRows][DP]
  float* Mw = Os + kMmaWarps * kMmaRows * DP;  // [kMmaWarps][kMmaRows]
  float* Lw = Mw + kMmaWarps * kMmaRows;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = attn::quad_sum(l[r]);
    const int row = warp * kMmaRows + (lane >> 2) + r * 8;
    if ((lane & 3) == 0) {
      Mw[row] = m[r];
      Lw[row] = lsum;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(Os + row * DP + n * 8 + c2) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
    }
  }
  __syncthreads();
  const int rows = min(kMmaRows, G - g0);
  for (int e = tid; e < rows * dh; e += kMmaThreads) {
    const int r = e / dh;
    const int d = e - r * dh;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) M = fmaxf(M, Mw[w * kMmaRows + r]);
    float L = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float mw = Mw[w * kMmaRows + r];
      const float sc = mw == -INFINITY ? 0.f : attn::exp2_fast(mw - M);
      L += sc * Lw[w * kMmaRows + r];
      acc += sc * Os[(w * kMmaRows + r) * DP + d];
    }
    const size_t idx = (size_t)split * R + (size_t)bh * G + g0 + r;
    part_acc[idx * dh + d] = acc;
    if (d == 0) {
      part_m[idx] = M * 0.6931471805599453f;  // back to the e domain decode_combine uses
      part_l[idx] = L;
    }
  }
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, const void* valid, void* out,
               void* part_m, void* part_l, void* part_acc, int B, int C, int Hq, int Hkv, int dh,
               int nsplit, int tiles_per_split, float softcap, float scale, void* stream) {
  const size_t smem = mma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_mma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = Hq / Hkv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * Hkv, nsplit, (G + kMmaRows - 1) / kMmaRows);
  decode_mma<DP><<<grid, kMmaThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(valid),
      static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_acc), C,
      Hq, Hkv, dh, tiles_per_split, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine<__nv_bfloat16><<<B * Hq, kCombineThreads, nsplit * sizeof(float), st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<__nv_bfloat16*>(out), B * Hq, dh, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* valid, void* out, void* part_m, void* part_l,
                         void* part_acc, int B, int C, int Hq, int Hkv, int dh,
                         int nsplit, int tiles_per_split, float softcap,
                         float scale, void* stream) {
  return dispatch<float>(q, k, v, valid, out, part_m, part_l, part_acc, B, C, Hq, Hkv,
                         dh, nsplit, tiles_per_split, softcap, scale, stream);
}

// The tensor-core body only (tiles_per_split counts its 64-key tiles): a
// head dim it does not take is refused, never sent to the f32 body.
int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* valid, void* out, void* part_m, void* part_l,
                          void* part_acc, int B, int C, int Hq, int Hkv, int dh,
                          int nsplit, int tiles_per_split, float softcap,
                          float scale, void* stream) {
  if (dh < 8 || dh % 8 || dh > 256) return (int)cudaErrorInvalidValue;
#define DECODE_MMA(DP)                                                                      \
  launch_mma<DP>(q, k, v, valid, out, part_m, part_l, part_acc, B, C, Hq, Hkv, dh, nsplit, \
                 tiles_per_split, softcap, scale, stream)
  if (dh <= 64) return DECODE_MMA(64);
  if (dh <= 80) return DECODE_MMA(80);
  if (dh <= 96) return DECODE_MMA(96);
  if (dh <= 128) return DECODE_MMA(128);
  return DECODE_MMA(256);
#undef DECODE_MMA
}

}  // extern "C"
