// RG-LRU linear recurrence h_t = a_t·h_{t−1} + g_t per channel (Griffin),
// prefill of the LM workload's recurrent blocks.
//
// Replaces src/repro/kernels/rglru_scan/ops.py::rglru_scan →
// src/repro/kernels/rglru_scan/kernel.py::rglru_scan_pallas (body _kernel).
//
// What it computes: a, g (B, S, di) f32 → h (B, S, di) f32 with h_{−1} = 0,
// and h_last (B, di) = h at step S − 1, the state the decode cache starts
// from. The recurrence runs serially over time within each thread, on
// purpose: the log-space prefix-product form (h_t = A_t·Σ g_τ/A_τ with
// A_t = Π a_τ) underflows f32 for small decays over long runs — the TPU
// kernel's docstring says why it, too, loops step by step.
//
// Design. One thread per (batch, channel), blocks along the channels, so
// every step's loads and stores are coalesced across a warp in the model's
// own (B, S, di) layout — no transposes and no padding, unlike the TPU
// wrapper's (B, di, S) layout padded to 256-channel × 128-step blocks. The
// loads do not depend on h, so each thread issues kUnroll steps of a and g
// before it runs their recurrence, which keeps enough bytes in flight with
// only B·di threads.
//
// What bounds it on this card: bytes — 12 per element (a and g read, h
// written) against 2 FLOPs; h_last is di·B more floats.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ g,
                  float* __restrict__ h, float* __restrict__ h_last, int S,
                  int di) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= di) return;
  const size_t base = (size_t)b * S * di + c;
  float hc = 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t off = base + (size_t)(t + u) * di;
      av[u] = a[off];
      gv[u] = g[off];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hc = av[u] * hc + gv[u];
      h[base + (size_t)(t + u) * di] = hc;
    }
  }
  for (; t < S; ++t) {
    const size_t off = base + (size_t)t * di;
    hc = a[off] * hc + g[off];
    h[off] = hc;
  }
  h_last[(size_t)b * di + c] = hc;
}

}  // namespace

extern "C" {

int rglru_scan_f32(const void* a, const void* g, void* h, void* h_last, int B,
                   int S, int di, void* stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(g),
      static_cast<float*>(h), static_cast<float*>(h_last), S, di);
  return (int)cudaGetLastError();
}

}  // extern "C"
