// Mamba-1 selective scan, prefill of the LM workload's Mamba blocks
// (falcon-mamba-7b).
//
// Replaces src/repro/kernels/mamba_scan/ops.py::selective_scan →
// src/repro/kernels/mamba_scan/kernel.py::mamba_scan_pallas (body _kernel).
//
// What it computes, in the model's layout: u, dt (B, S, di), a (di, ds),
// b, c (B, S, ds), all f32, with h_{−1} = 0 per (batch, channel):
//   h_t = exp(dt_t·a) ⊙ h_{t−1} + (dt_t·u_t)·b_t     (ds ≤ 16 states)
//   y_t = Σ_n h_t[n]·c_t[n]
// → y (B, S, di) and h_last (B, di, ds) = h at step S − 1, the state the
// decode cache starts from. The D skip and the gate are applied outside, in
// f32, as the JAX package does.
//
// What bounds it on an H100 SXM, at the serving shape (4, 3000, 8192, 16):
// * the exponentials — B·S·di·ds = 1.573e9 of them on the special-function
//   units (SFU), 16 a clock an SM: 0.376 ms on 132 SMs at 1.98 GHz;
// * the bytes — u and dt read, y written, 12 an element (1.18 GB), plus
//   b, c, a and h_last: 0.353 ms at 3.35 TB/s (a plain copy of the same
//   bytes takes ~0.40 ms on the card).
// The two are within 6% of each other, so the SFU and the memory have to
// be kept busy at once, and every other instruction competes with both for
// the issue slots.
//
// Design, one part for each:
// * Exponentials on the SFU alone: exp(dt·a) = 2^(dt·a₂) with a₂ = a·log₂e
//   computed once into registers, as one multiply and one ex2.approx.ftz.f32
//   (MUFU.EX2). expf adds its range reduction, ~6 more FP32 instructions a
//   state and step, and makes the kernel issue-bound (1.69 ms against 0.51
//   at the serving shape on the H100). Error: ex2.approx is
//   within 2 ulp (the CUDA math API's bound for exp2f, the same
//   instruction); the rounding of a₂ and of dt·a₂ adds |dt·a₂|·2^-24 to the
//   exponent; a result below 2^-126 flushes to 0 (exp of an argument below
//   −87, a decay no f32 state survives anyway). All of it is far inside the
//   reference's 1e-4 over 3000 steps; tests/test_torch_mamba.py emulates
//   this arithmetic on the CPU against the JAX kernel.
// * Latency hidden by independent work, not by more threads: one thread
//   holds one channel's 16 states and its row of a₂ in registers, so each
//   step issues 16 independent exponentials and updates; blocks run along
//   the channels, so each step's y store is coalesced across a warp in the
//   (B, S, di) layout. Spreading a channel's states over 2 or 4 lanes (2× or
//   4× the warps, y summed by shuffles) measured slower on the card: the
//   shuffles, the repeated reads of u and dt and the stores cost more issue
//   slots than the extra warps save.
// * Loads in flight: u, dt (64 channels × 16 steps) and b, c (16 × 16,
//   zero-padded past ds) go through a ring of three tiles in shared memory
//   by cp.async, two tiles ahead of the one being computed; one barrier a
//   tile frees the oldest slot. b_t and c_t are read from shared memory as
//   broadcasts. u and dt are copied 16 bytes at a time when di % 4 == 0 and
//   both are 16-byte aligned (the wrapper passes vec), else 4 bytes at a
//   time. Channels past di and steps past S read as 0 and leave h as it is
//   (2^0·h + 0·b); states past ds hold a₂ = 0 and read b = c = 0, so they
//   stay 0 and add 0 to y: every ds from 1 to 16 runs the same code.
// __launch_bounds__ asks for 4 blocks of 64 threads an SM, so the serving
// shape's 512 blocks run in one wave.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxState = 16;  // ds ≤ 16 (the wrapper checks)
constexpr int kThreads = 64;   // channels a block, one a thread
constexpr int kSteps = 16;     // steps a tile
constexpr int kStages = 3;     // tiles in the ring
constexpr int kUd = kSteps * kThreads;   // floats of u (or dt) a tile
constexpr int kBc = kSteps * kMaxState;  // floats of b (or c) a tile
constexpr int kTile = 2 * kUd + 2 * kBc;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 4 or 16 bytes; the bytes past src_bytes are written as 0 and
// not read (src_bytes 0 reads nothing).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
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

// Copy the tile of steps t0 .. t0 + kSteps − 1 of u, dt, b, c into a ring
// slot, zero-filling channels ≥ di, steps ≥ S and states ≥ ds.
template <bool kVec>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ u,
                                          const float* __restrict__ dt,
                                          const float* __restrict__ bm,
                                          const float* __restrict__ cm, int bi, int c0,
                                          int t0, int S, int di, int ds) {
  float* us = tile;
  float* dts = tile + kUd;
  float* bs = tile + 2 * kUd;
  float* cs = bs + kBc;
  constexpr int kWidth = kVec ? 4 : 1;
  constexpr int kRow = kThreads / kWidth;
#pragma unroll
  for (int i = 0; i < kSteps * kRow / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kRow, col = (e % kRow) * kWidth;
    const int t = t0 + r, ch = c0 + col;
    const int left = t < S ? min(di - ch, kWidth) : 0;
    const int bytes = left > 0 ? 4 * left : 0;
    const size_t off = bytes ? ((size_t)bi * S + t) * di + ch : 0;
    if (kVec) {
      cp_async16(us + r * kThreads + col, u + off, bytes);
      cp_async16(dts + r * kThreads + col, dt + off, bytes);
    } else {
      cp_async4(us + r * kThreads + col, u + off, bytes);
      cp_async4(dts + r * kThreads + col, dt + off, bytes);
    }
  }
#pragma unroll
  for (int i = 0; i < kBc / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kMaxState, n = e % kMaxState;
    const int t = t0 + r;
    const int bytes = (t < S && n < ds) ? 4 : 0;
    const size_t off = bytes ? ((size_t)bi * S + t) * ds + n : 0;
    cp_async4(bs + e, bm + off, bytes);
    cp_async4(cs + e, cm + off, bytes);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
mamba_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                  const float* __restrict__ a, const float* __restrict__ bm,
                  const float* __restrict__ cm, float* __restrict__ y,
                  float* __restrict__ h_last, int S, int di, int ds) {
  __shared__ __align__(16) float ring[kStages][kTile];
  const int c0 = blockIdx.x * kThreads;
  const int c = c0 + threadIdx.x;
  const int bi = blockIdx.y;
  const bool active = c < di;

  float a2[kMaxState], h[kMaxState];
#pragma unroll
  for (int n = 0; n < kMaxState; ++n) {
    a2[n] = (active && n < ds) ? a[(size_t)c * ds + n] * kLog2e : 0.f;
    h[n] = 0.f;
  }

  const int tiles = (S + kSteps - 1) / kSteps;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < tiles) load_tile<kVec>(ring[k], u, dt, bm, cm, bi, c0, k * kSteps, S, di, ds);
    cp_async_commit();
  }
  float* yq = y + (size_t)bi * S * di + c;  // y of the next step
  for (int k = 0; k < tiles; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile k has landed; every thread is done with tile k − 1
    const int kn = k + kStages - 1;
    if (kn < tiles) {
      load_tile<kVec>(ring[kn % kStages], u, dt, bm, cm, bi, c0, kn * kSteps, S, di, ds);
    }
    cp_async_commit();

    const float* tile = ring[k % kStages];
    const int steps = min(kSteps, S - k * kSteps);
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {
      const float uv = tile[r * kThreads + threadIdx.x];
      const float dv = tile[kUd + r * kThreads + threadIdx.x];
      const float* bt = tile + 2 * kUd + r * kMaxState;
      const float* ct = bt + kBc;
      const float du = dv * uv;
      float yt = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxState; ++n) {
        h[n] = fmaf(ex2_approx(dv * a2[n]), h[n], du * bt[n]);
        yt = fmaf(h[n], ct[n], yt);
      }
      if (active && r < steps) *yq = yt;
      yq += di;
    }
  }
  cp_async_wait<0>();
  if (active) {
    float* hl = h_last + ((size_t)bi * di + c) * ds;
#pragma unroll
    for (int n = 0; n < kMaxState; ++n) {
      if (n < ds) hl[n] = h[n];
    }
  }
}

}  // namespace

extern "C" {

// vec != 0: di % 4 == 0 and u, dt 16-byte aligned (the wrapper checks), so
// u and dt are copied 16 bytes at a time.
int mamba_scan_f32(const void* u, const void* dt, const void* a, const void* b,
                   const void* c, void* y, void* h_last, int B, int S, int di, int ds,
                   int vec, void* stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* uf = static_cast<const float*>(u);
  auto* dtf = static_cast<const float*>(dt);
  auto* af = static_cast<const float*>(a);
  auto* bf = static_cast<const float*>(b);
  auto* cf = static_cast<const float*>(c);
  auto* yf = static_cast<float*>(y);
  auto* hf = static_cast<float*>(h_last);
  if (vec) {
    mamba_scan_kernel<true><<<grid, kThreads, 0, st>>>(uf, dtf, af, bf, cf, yf, hf, S, di, ds);
  } else {
    mamba_scan_kernel<false><<<grid, kThreads, 0, st>>>(uf, dtf, af, bf, cf, yf, hf, S, di,
                                                        ds);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
