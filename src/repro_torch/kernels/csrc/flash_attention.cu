// Causal / sliding-window GQA attention with an online softmax (flash
// attention), prefill of the LM workload's attention blocks.
//
// Replaces src/repro/kernels/flash_attention/ops.py::flash_attention (its own
// GQA-addressed pallas_call, body kernel.py::_kernel) and
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas.
//
// What it computes, in the model's layout: q (B, S, Hq, Dh) against k, v
// (B, S, Hkv, Dh), out (B, S, Hq, Dh) in the inputs' type (bf16 or f32).
// Scores s = (q·k)·Dh^-1/2, optionally soft-capped (cap·tanh(s/cap)), masked
// causally (k ≤ q) and, with window > 0, to the band q − k < window; the
// softmax is taken online in f32 (running max m, running sum l, f32
// accumulator) and the output is acc / l. KV head of query head h is
// h / (Hq / Hkv): KV rows are addressed, never expanded.
//
// Design. A block owns kBQ = 32 consecutive query positions of one
// (batch, query head) and walks the KV tiles of kBK = 32 keys that meet its
// band — tiles wholly outside the causal/window band are never visited, as
// the TPU kernel skips them (kernel.py:50–56) — so the work is what the band
// holds, not S². Eight warps own four query rows each. Per tile:
//   * the block stages K and V (converted to f32) in shared memory;
//   * lane j of a warp owns key j of the tile: it forms its four rows'
//     scores from float4 reads of its K row (row stride Dh + 4 floats, so the
//     eight lanes of each 16-byte phase hit distinct banks for every Dh that
//     is a multiple of 4) and broadcast float4 reads of the Q rows;
//   * the row max and the rescale factor come from warp shuffles; the running
//     sum l stays a per-lane partial until the end;
//   * P·V: each lane owns float4 groups of the head (lane + 32·g), and p_j is
//     broadcast from lane j by shuffle.
// No tensor cores, no TMA: a plain SIMT kernel, right first (wgmma is a later
// redesign). The ragged tail (S not a multiple of 32) is handled by bounds
// checks: rows and keys past S are staged as zeros and masked, never padded
// in device memory.
//
// Shared memory (f32): Q 32×Dh + K 32×(Dh+4) + V 32×Dh floats — at Dh = 256
// that is 32 + 33.3 + 32 = 97.3 KB, so two blocks (16 warps) fit in the
// 227 KB an SM offers; at Dh = 128, 48.5 KB and four blocks. Dh must be a
// multiple of 4 and at most 256 (the wrapper checks).
//
// What bounds it on this card: 4·Dh FLOPs per live (query, key) pair against
// q/k/v/o bytes — at the main path's shape (Dh = 256, window 2048) about 1 KB
// of work per 2 bytes moved, far above the H100's ~295 FLOP/byte ridge, so
// the operations. The bound is priced at the bf16 tensor-core peak; this
// kernel runs on the f32 FMA units and cannot reach it (see PERF.md).
//
// Every entry point returns cudaGetLastError() after its launch (or the
// error of cudaFuncSetAttribute).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;             // query rows per warp
constexpr int kBQ = kWarps * kRows;  // query rows per block
constexpr int kBK = 32;              // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                        int B, int S, int Hq, int Hkv, int dh, int window,
                        float softcap, float scale, void* stream) {
  return dispatch<float>(q, k, v, out, B, S, Hq, Hkv, dh, window, softcap, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                         int B, int S, int Hq, int Hkv, int dh, int window,
                         float softcap, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, B, S, Hq, Hkv, dh, window, softcap,
                                 scale, stream);
}

}  // extern "C"
