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
// Design. Two passes.
//   1. decode_partial: a block owns up to 16 query heads of one (batch, KV
//      head) — four warps of four heads — and one split of the cache: a
//      contiguous run of 32-key tiles. Splitting C fills the card when
//      B·Hkv is small (4 blocks at recurrentgemma-9b's decode shape); the
//      wrapper picks the split count. Tiles are copied raw into shared
//      memory with cp.async, 16 bytes a thread, double-buffered so the next
//      tile is in flight while this one is used. Lane j of a warp owns key
//      j: its four heads' scores come from 16-byte reads of its K row (row
//      stride an odd number of 16-byte chunks, so the eight lanes of each
//      phase hit distinct banks) against broadcast reads of Q, staged in
//      f32; row max and rescale by warp shuffles; the sum l stays a per-lane
//      partial. P·V: each lane owns 16-byte chunks of the head (lane + 32·i)
//      and p_j is broadcast from lane j. The split's (m, l, acc) go to
//      scratch in f32.
//   2. decode_combine: a block per (batch, query head) merges the splits:
//      M = max m_s, out = Σ e^(m_s−M)·acc_s / max(Σ e^(m_s−M)·l_s, 1e-30).
// No tensor cores: a plain SIMT kernel, right first. The ragged tail (C not
// a multiple of 32) is bounds-checked and staged as zeros, never padded in
// device memory.
//
// What bounds it on this card: bytes — every K and V row is read once
// (4·Dh FLOPs per (head, slot) against 2·Dh·(bytes per element) per KV
// head and slot, far below the ~295 FLOP/byte ridge).
//
// Dh·sizeof(T) must be a multiple of 16 and Dh ≤ 256; k and v 16-byte
// aligned (the wrapper checks). Every entry point returns
// cudaGetLastError() after its launches (or the error of
// cudaFuncSetAttribute).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;                       // query heads per warp
constexpr int kRowsPerBlock = kWarps * kRows;  // query heads per block
constexpr int kBK = 32;                        // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr int kCombineThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// Elements of T per 16-byte chunk, and their widening to f32.
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
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  // a bf16 is the high half of the f32 with the same bits
  __device__ static __forceinline__ void unpack(const uint4 r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* valid, void* out, void* part_m, void* part_l,
                          void* part_acc, int B, int C, int Hq, int Hkv, int dh,
                          int nsplit, int tiles_per_split, float softcap,
                          float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, valid, out, part_m, part_l, part_acc, B, C,
                                 Hq, Hkv, dh, nsplit, tiles_per_split, softcap, scale,
                                 stream);
}

}  // extern "C"
