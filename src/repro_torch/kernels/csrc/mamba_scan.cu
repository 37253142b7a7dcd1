// Mamba-1 selective scan, prefill of the LM workload's Mamba blocks
// (falcon-mamba-7b).
//
// Replaces src/repro/kernels/mamba_scan/ops.py::selective_scan →
// src/repro/kernels/mamba_scan/kernel.py::mamba_scan_pallas (body _kernel).
//
// What it computes, in the model's layout: u, dt (B, S, di), a (di, ds),
// b, c (B, S, ds), all f32, with h_{−1} = 0 per (batch, channel):
//   h_t = exp(dt_t·a) ⊙ h_{t−1} + (dt_t·u_t)·b_t     (ds states)
//   y_t = Σ_n h_t[n]·c_t[n]
// → y (B, S, di) and h_last (B, di, ds) = h at step S − 1, the state the
// decode cache starts from. The D skip and the gate are applied outside, in
// f32, as the JAX package does.
//
// Design. One thread per (batch, channel), holding the channel's ds ≤ 16
// states and its row of a in registers; blocks run along the channels, so
// each step's loads of u and dt and store of y are coalesced across a warp
// in the (B, S, di) layout — no transposes and no padding, unlike the TPU
// wrapper's (B, di, S) layout padded to 256-channel × 128-step blocks. b_t
// and c_t are shared by every channel of a batch row: the block stages a
// chunk of kChunk steps of both in shared memory once, and every thread
// reads them there as broadcasts. u and dt do not depend on h, so each
// thread issues kUnroll steps of loads before it runs their recurrence, as
// the RG-LRU scan does. y_t needs no exchange between threads, which is why
// a whole channel's states sit in one thread rather than one state per lane
// (16× more threads, but a shuffle reduction of y at every step).
//
// The ds exponentials of a step do not depend on h either, so the serial
// chain per step is one multiply-add per state. expf (not __expf) keeps the
// result within the reference's 1e-4.
//
// What bounds it on this card: at the serving shape (4, 3000, 8192, 16)
// the exponentials — B·S·di·ds of them on the special-function units, 16
// per clock per SM — slightly more than the bytes (u, dt read and y written,
// 12 per element, plus b, c, a and h_last).
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;   // channels per block
constexpr int kChunk = 128;    // steps of b and c staged per pass
constexpr int kUnroll = 16;    // steps of u and dt loaded ahead
constexpr int kMaxState = 16;  // ds ≤ 16 (the wrapper checks)

// kFull: ds == kMaxState, so every state guard folds away at compile time.
template <bool kFull>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                  const float* __restrict__ a, const float* __restrict__ bm,
                  const float* __restrict__ cm, float* __restrict__ y,
                  float* __restrict__ h_last, int S, int di, int ds) {
  __shared__ float Bs[kChunk * kMaxState];
  __shared__ float Cs[kChunk * kMaxState];
  const int nds = kFull ? kMaxState : ds;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const bool active = c < di;

  float A[kMaxState], h[kMaxState];
#pragma unroll
  for (int n = 0; n < kMaxState; ++n) {
    A[n] = (active && n < nds) ? a[(size_t)c * nds + n] : 0.f;
    h[n] = 0.f;
  }
  const size_t base = (size_t)b * S * di + c;
  const float* brow = bm + (size_t)b * S * nds;
  const float* crow = cm + (size_t)b * S * nds;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int len = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < len * nds; e += kThreads) {
      Bs[e] = brow[(size_t)t0 * nds + e];
      Cs[e] = crow[(size_t)t0 * nds + e];
    }
    __syncthreads();
    if (!active) continue;

    for (int tt = 0; tt < len; tt += kUnroll) {
      const int steps = min(kUnroll, len - tt);
      float uv[kUnroll], dv[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (k < steps) {
          const size_t off = base + (size_t)(t0 + tt + k) * di;
          uv[k] = u[off];
          dv[k] = dt[off];
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (k < steps) {
          const float* bt = Bs + (tt + k) * nds;
          const float* ct = Cs + (tt + k) * nds;
          const float du = dv[k] * uv[k];
          float yt = 0.f;
#pragma unroll
          for (int n = 0; n < kMaxState; ++n) {
            if (n < nds) {
              h[n] = expf(dv[k] * A[n]) * h[n] + du * bt[n];
              yt += h[n] * ct[n];
            }
          }
          y[base + (size_t)(t0 + tt + k) * di] = yt;
        }
      }
    }
  }
  if (active) {
    float* hl = h_last + ((size_t)b * di + c) * nds;
#pragma unroll
    for (int n = 0; n < kMaxState; ++n) {
      if (n < nds) hl[n] = h[n];
    }
  }
}

}  // namespace

extern "C" {

int mamba_scan_f32(const void* u, const void* dt, const void* a, const void* b,
                   const void* c, void* y, void* h_last, int B, int S, int di,
                   int ds, void* stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_last);
  if (ds == kMaxState) {
    mamba_scan_kernel<true><<<grid, kThreads, 0, st>>>(uf, dtf, af, bf, cf, yf, hf,
                                                       S, di, ds);
  } else {
    mamba_scan_kernel<false><<<grid, kThreads, 0, st>>>(uf, dtf, af, bf, cf, yf, hf,
                                                        S, di, ds);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
