// The Mamba-2 (SSD) scan of models/mamba2.py, forward and backward, for
// training.
//
// Replaces no TPU kernel: the JAX package has no Mamba-2 mixer (granite
// 4.0-H is the port's own arch). It takes the place of the plain chunked
// composition `models/mamba2.py::ssd`, which builds an f32 (Bt, H, K, L, L)
// decay tensor a layer, multiplies it by a broadcast C·Bᵀ and keeps both
// for autograd.
//
// What it computes (the module docstring of mamba2.py has the equations):
// x (Bt, S, H, P) bf16, Δ (Bt, S, H) f32, A (H,) f32, B and C (Bt, S, G, N)
// bf16 (head h reads group h / (H/G)); S cut in chunks of L (the last one
// padded with Δ = 0); in chunk k, with cs the running sum of Δ·A,
//   y_i = Σ_{j≤i} (C_i·B_j)·e^{cs_i − cs_j}·Δ_j x_j + e^{cs_i}·C_i·E_kᵀ,
//   E_0 = 0,  E_{k+1} = e^{cs_L}·E_k + Σ_j e^{cs_L − cs_j}·Δ_j x_j ⊗ B_j,
// y (Bt, S, H, P) f32. x, B and C are read in rows (the last dims
// contiguous, any stride between tokens); ssd_pack first copies the mixer's
// views of its conv output, a token apart along S, into such rows.
//
// Forward, four launches:
//   (a) ssd_cb: C·Bᵀ of every chunk and group, f32 (Bt, G, K, Lp, Lp), the
//       causal 64 × 64 tiles only — once a group, not once a head;
//   (b) ssd_chunk_state<fwd>: a block per (chunk, batch·head):
//       the chunk's running sums cs (kept, (Bt, H, K, L) f32) and its own
//       state (x·Δ·e^{cs_L − cs})ᵀ·B on the tensor cores, f32; then
//       ssd_carry<fwd>, a block per (1,024 state elements, batch·head), walks
//       the chunks in f32 from the own states to the state entering each
//       chunk, E (Bt, H, K, P, N) f32;
//   (c) ssd_out: a block per (batch, head, chunk, 64 rows): e^{cs_i}·C·E_kᵀ,
//       then the causal part, its A operand bf16(CB_ij·e^{cs_i − cs_j}·Δ_j)
//       built in registers from CB and the sums (the mask before the
//       exponential; no L × L tile in memory), times x. y is written once.
// Backward, six launches, given dy (Bt, S, H, P) f32 and the forward's cs,
// CB and E:
//   (d) ssd_chunk_state<bwd> (a block per 64 states of a chunk and head)
//       and ssd_carry<bwd>: the same two steps in reverse for the state's
//       gradient, Ĝ_{k−1} = e^{cs_L}·Ĝ_k + Σ_i
//       e^{cs_i}·dy_i ⊗ C_i (Ĝ_k: the gradient of the state leaving chunk k,
//       Ĝ_{K−1} = 0), kept as bf16 (Bt, H, K, P, N), and ⟨Ĝ_k, E_{k+1}⟩ in
//       parts, one a carry block;
//   (e) ssd_bwd_j: a block per (batch, group, chunk, 64 rows j, hpb heads):
//       dxd_j = Σ_{i≥j} CB_ij·e^{cs_i − cs_j}·dy_i + e^{cs_L − cs_j}·Ĝ·B_j,
//       dx = Δ·dxd, r_j = x_j·dxd_j, and dB summed over its heads:
//       Σ_{i≥j} e^{cs_i − cs_j}·Δ_j(x_j·dy_i)·C_i + e^{cs_L − cs_j}·Δ_j x_j·Ĝ;
//       what the running sums' gradient dcs_j loses, q_j = Σ_{i>j} W_ij +
//       Δ_j x_j·(e^{cs_L − cs_j}·Ĝ·B_j), W_ij = Δ_j(x_j·dy_i)·CB_ij·e^{cs_i − cs_j};
//   (f) ssd_bwd_i: the same blocks by rows i: dC_i = Σ_{j≤i} e^{cs_i −
//       cs_j}·Δ_j(dy_i·x_j)·B_j + e^{cs_i}·dy_i·E_k, summed over its heads;
//       what dcs_i gains, u_i = Σ_{j<i} W_ij + dy_i·e^{cs_i}·C_i·E_kᵀ (the
//       diagonal of W cancels and is left out of both, as autograd's sum
//       over the decays leaves it);
//   (g) ssd_bwd_dt: a block a head: dcs_i = u_i − q_i (+ ⟨Ĝ_k, E_{k+1}⟩ on a
//       chunk's last row), its reverse running sum dā, dΔ = r + A·dā and
//       dA = Σ Δ·dā over batch and chunks;
//   (h) ssd_bwd_sum: dB and dC, the head groups' partial sums added in
//       order and cast to bf16.
//
// Precision: the running sums, every exponential (the decays inside a tile
// by ex2.approx of the sums times log2 e), the carries and the accumulators
// are f32; every product takes bf16 operands (the decays are
// applied to CB in f32 before the single cast) with f32 accumulation on the
// tensor cores (mma.sync m16n8k16, fragments by ldmatrix from padded shared
// tiles: attn_mma.cuh).
//
// Deterministic: no atomics. Every output element is summed in a fixed
// order by one thread (dB and dC over a block's heads in registers, then
// over the head groups by (h); dA by one block a head, in a fixed tree).
//
// What bounds it on this card: at granite-4.0-h-small's shape (H 128, P 64,
// N 128, L 256) the forward's least time is its bytes (x and y, ~200 MB a
// 4,096-token microbatch: ~61 µs), the products ~26 GFLOP of bf16 (~27 µs
// at the dense peak). The design keeps every L × L quantity in registers or
// L2 (CB, 4 MB a microbatch) and runs the products on the tensor cores;
// shapes: P ≤ 64 and N ≤ 128, multiples of 8; L ≤ 256 (the wrapper checks).
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using attn::a_rows;
using attn::exp2_fast;
using attn::kLog2e;
using attn::k_rows;
using attn::kFull;
using attn::ldsm_x4;
using attn::ldsm_x4_trans;
using attn::mma_bf16;
using attn::pack_bf16;
using attn::quad_sum;

constexpr int kThreads = 128;  // four warps, 16 rows of a 64-row tile each
constexpr int kTile = 64;
constexpr int kCarrySlice = 8 * kThreads;  // state elements a carry block walks

struct Dims {
  int B, S, H, P, G, N, L, K;
  int T;   // 64-row tiles a chunk
  int Lp;  // 64·T: CB's row length
  int Lr;  // L rounded up to 16: the state pass's rows
  long long xs, bs, cs;  // token strides of x, B and C
};

__device__ __forceinline__ long long bhk_of(const Dims& d, int b, int h, int k) {
  return (static_cast<long long>(b) * d.H + h) * d.K + k;
}

// Valid rows of a tile whose first row is chunk row i0 of chunk k.
__device__ __forceinline__ int valid_rows(const Dims& d, int k, int i0, int rows) {
  const int v = min(d.L - i0, d.S - k * d.L - i0);
  return max(0, min(rows, v));
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// rows (at most 64) × W into a bf16 shared tile of row stride W + 8: row r
// from src + r·ld (valid below `nvalid`), columns below `cols` (a multiple
// of 8), times scale(r), rounded once; zeros elsewhere. Every load is
// issued before the first store.
template <int W, typename Src, typename Scale>
__device__ __forceinline__ void stage(bf16* dst, const Src* src, long long ld, int rows,
                                      int nvalid, int cols, Scale scale) {
  constexpr int V = W / 8, IT = (kTile * V + kThreads - 1) / kThreads;
  float v[IT][8];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = threadIdx.x + it * kThreads, r = e / V, q = e - r * V;
    if (e < rows * V && r < nvalid && q * 8 < cols) load8(src + r * ld + q * 8, v[it]);
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = threadIdx.x + it * kThreads, r = e / V, q = e - r * V;
    if (e >= rows * V) continue;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid && q * 8 < cols) {
      const float sc = scale(r);
      out.x = pack_bf16(v[it][0] * sc, v[it][1] * sc);
      out.y = pack_bf16(v[it][2] * sc, v[it][3] * sc);
      out.z = pack_bf16(v[it][4] * sc, v[it][5] * sc);
      out.w = pack_bf16(v[it][6] * sc, v[it][7] * sc);
    }
    *reinterpret_cast<uint4*>(dst + r * (W + 8) + q * 8) = out;
  }
}

// rows × W bf16 copied as they are into a shared tile of row stride W + 8
// by cp.async, every 16-byte piece in flight at once (zeros past `nvalid`
// rows or `cols` columns); landed() waits for this thread's copies, and a
// barrier after it for everyone's.
template <int W>
__device__ __forceinline__ void copy_async(bf16* dst, const bf16* src, long long ld, int rows,
                                           int nvalid, int cols) {
  constexpr int V = W / 8;
  for (int e = threadIdx.x; e < rows * V; e += kThreads) {
    const int r = e / V, q = e - r * V;
    const bool ok = r < nvalid && q * 8 < cols;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     attn::smem_addr(dst + r * (W + 8) + q * 8)),
                 "l"(ok ? src + r * ld + q * 8 : src), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void landed() {
  attn::cp_async_commit();
  attn::cp_async_wait<0>();
}

// Inclusive running sum of v[0..n) (from the end when `rev`), n ≤ 1024, by
// the calling warp: each lane sums a run of consecutive entries in order,
// the runs' totals are scanned across lanes, and each lane adds its run.
__device__ void warp_scan(float* v, int n, bool rev) {
  const int lane = threadIdx.x & 31;
  const int per = (n + 31) >> 5;
  const int lo = min(lane * per, n), hi = min(lo + per, n);
  float tot = 0.f;
  for (int t = lo; t < hi; ++t) tot += v[rev ? n - 1 - t : t];
  float incl = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  float run = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) run = 0.f;
  for (int t = lo; t < hi; ++t) {
    const int i = rev ? n - 1 - t : t;
    run += v[i];
    v[i] = run;
  }
}

// x·s on the two bf16 of a packed pair, rounded once.
__device__ __forceinline__ unsigned scale_pair(unsigned u, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  return pack_bf16(f.x * s, f.y * s);
}

__device__ __forceinline__ float bf16_at(const bf16* t, int i) { return __bfloat162float(t[i]); }

// ----------------------------------------------------------------- (a) CB
template <int NT>
__global__ void __launch_bounds__(kThreads) ssd_cb(const bf16* __restrict__ bm,
                                                   const bf16* __restrict__ cm,
                                                   float* __restrict__ cb, Dims d) {
  constexpr int LD = NT + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem);
  bf16* Bs = Cs + kTile * LD;
  int q = blockIdx.x, ti = 0;
  while (q > ti) q -= ++ti;
  const int tj = q, k = blockIdx.y, b = blockIdx.z / d.G, g = blockIdx.z % d.G;
  const long long s0 = static_cast<long long>(b) * d.S + k * d.L;
  copy_async<NT>(Cs, cm + (s0 + ti * kTile) * d.cs + g * d.N, d.cs, kTile,
                 valid_rows(d, k, ti * kTile, kTile), d.N);
  copy_async<NT>(Bs, bm + (s0 + tj * kTile) * d.bs + g * d.N, d.bs, kTile,
                 valid_rows(d, k, tj * kTile, kTile), d.N);
  landed();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[8][4] = {};
#pragma unroll
  for (int kk = 0; kk < NT / 16; ++kk) {
    unsigned a[4];
    ldsm_x4(a, a_rows(Cs, LD, 16 * warp, 16 * kk, lane));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      unsigned f[4];
      ldsm_x4(f, k_rows(Bs, LD, 16 * u, 16 * kk, lane));
      mma_bf16(acc[2 * u], a, f[0], f[1]);
      mma_bf16(acc[2 * u + 1], a, f[2], f[3]);
    }
  }
  float* out = cb + (static_cast<long long>(blockIdx.z) * d.K + k) * d.Lp * d.Lp;
  const int i = ti * kTile + 16 * warp + (lane >> 2), j0 = tj * kTile + 2 * (lane & 3);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    *reinterpret_cast<float2*>(out + static_cast<long long>(i) * d.Lp + j0 + 8 * c) =
        make_float2(acc[c][0], acc[c][1]);
    *reinterpret_cast<float2*>(out + static_cast<long long>(i + 8) * d.Lp + j0 + 8 * c) =
        make_float2(acc[c][2], acc[c][3]);
  }
}

// ------------------------------------------------- (b), (d) chunk states
// A block per (NW states, chunk, batch·head): the chunk's own product,
// (PT × L)·(L × NW) over 64-row tiles of the chunk — forward
// (x·Δ·e^{cs_L − cs})ᵀ·B, backward (dy·e^{cs})ᵀ·C — as m16 tiles of P times
// 16-wide units of the block's states, spread over the four warps; f32 into
// `own` (Bt, H, K, P, N). The
// forward also forms the chunk's running sums (and the first state tile's
// block keeps them); the backward reads them, and its first state tile's
// block keeps dy in bf16.
template <int PT, int NW, bool REV>
__global__ void __launch_bounds__(kThreads) ssd_chunk_state(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const bf16* __restrict__ mat, long long mat_ts, const float* __restrict__ dy,
    float* __restrict__ cs, float* __restrict__ own, bf16* __restrict__ dy16, Dims d) {
  constexpr int LDP = PT + 8, LDW = NW + 8;
  constexpr int MT = PT / 16, NU = NW / 16, ITEMS = MT * NU;
  constexpr int IPW = (ITEMS + 3) / 4;
  static_assert(4 % MT == 0, "a warp's items keep one m16 tile");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Ms = Xs + kTile * LDP;
  float* csS = reinterpret_cast<float*>(Ms + kTile * LDW);
  float* scl = csS + d.Lr;

  const int nt = blockIdx.x, k = blockIdx.y, b = blockIdx.z / d.H, h = blockIdx.z % d.H;
  const int g = h / (d.H / d.G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_base = nt * NW;
  const long long bhk = bhk_of(d, b, h, k);
  const long long s0 = static_cast<long long>(b) * d.S + k * d.L;
  const int nval = valid_rows(d, k, 0, d.Lr);
  for (int i = threadIdx.x; i < d.Lr; i += kThreads) {
    const float dti = i < nval ? dt[(s0 + i) * d.H + h] : 0.f;
    scl[i] = dti;
    if (REV) csS[i] = i < d.L ? cs[bhk * d.L + i] : 0.f;
    else csS[i] = dti * A[h];
  }
  __syncthreads();
  if (!REV && warp == 0) warp_scan(csS, d.L, false);
  __syncthreads();
  const float cs_last = csS[d.L - 1];
  for (int i = threadIdx.x; i < d.Lr; i += kThreads) {
    if (!REV && nt == 0 && i < d.L) cs[bhk * d.L + i] = csS[i];
    // forward: x_j·Δ_j·e^{cs_L − cs_j}; backward: dy_i·e^{cs_i}
    scl[i] = REV ? expf(csS[i]) : scl[i] * expf(cs_last - csS[i]);
  }
  // the chunk's rows 64 at a time: a small tile, many blocks an SM
  float acc[IPW][2][4] = {};
  for (int q0 = 0; q0 < d.Lr; q0 += kTile) {
    const int rows = min(kTile, d.Lr - q0), qval = max(0, min(rows, nval - q0));
    __syncthreads();  // the tiles' previous rows are read (and scl written)
    copy_async<NW>(Ms, mat + (s0 + q0) * mat_ts + g * d.N + n_base, mat_ts, rows, qval,
                   d.N - n_base);
    if (REV && nt == 0) {  // dy in bf16, for the backward's other products
      for (int e = threadIdx.x; e < qval * (PT / 8); e += kThreads) {
        const int r = e / (PT / 8), q = e - r * (PT / 8);
        if (q * 8 >= d.P) continue;
        const long long at = ((s0 + q0 + r) * d.H + h) * d.P + q * 8;
        float v[8];
        load8(dy + at, v);
        *reinterpret_cast<uint4*>(dy16 + at) =
            make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                       pack_bf16(v[6], v[7]));
      }
    }
    if (REV) {
      stage<PT>(Xs, dy + ((s0 + q0) * d.H + h) * d.P, static_cast<long long>(d.H) * d.P, rows,
                qval, d.P, [&](int r) { return scl[q0 + r]; });
    } else {
      stage<PT>(Xs, x + (s0 + q0) * d.xs + h * d.P, d.xs, rows, qval, d.P,
                [&](int r) { return scl[q0 + r]; });
    }
    landed();
    __syncthreads();
    for (int kk = 0; kk < rows / 16; ++kk) {
      unsigned a[4];  // a warp's items share their m16 tile: warp % MT
      ldsm_x4_trans(a, k_rows(Xs, LDP, 16 * kk, 16 * (warp % MT), lane));
#pragma unroll
      for (int it = 0; it < IPW; ++it) {
        const int item = warp + 4 * it;
        if (item >= ITEMS) continue;
        const int nu = item / MT;
        unsigned f[4];
        ldsm_x4_trans(f, a_rows(Ms, LDW, 16 * kk, 16 * nu, lane));
        mma_bf16(acc[it][0], a, f[0], f[1]);
        mma_bf16(acc[it][1], a, f[2], f[3]);
      }
    }
  }
#pragma unroll
  for (int it = 0; it < IPW; ++it) {
    const int item = warp + 4 * it;
    if (item >= ITEMS) continue;
    const int mt = item % MT, nu = item / MT;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = n_base + 16 * nu + 8 * hh + 2 * (lane & 3);
      if (n >= d.N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 16 * mt + (lane >> 2) + 8 * half;
        if (p < d.P)
          *reinterpret_cast<float2*>(own + (bhk * d.P + p) * d.N + n) =
              make_float2(acc[it][hh][2 * half], acc[it][hh][2 * half + 1]);
      }
    }
  }
}

// --------------------------------------------------- (b'), (d') the carry
// A block per (1,024 state elements, batch·head) walks the chunks, eight
// elements a thread, in f32, the next chunk's loads issued before this
// chunk's stores: forward E_k = carry (f32, and bf16 for the products that
// read it), carry = e^{cs_L}·carry + own_k; backward (from the last chunk)
// Ĝ_k = carry (bf16), the block's part of ⟨Ĝ_k, E_{k+1}⟩, carry =
// e^{cs_L}·carry + own_k.
template <bool REV>
__global__ void __launch_bounds__(kThreads) ssd_carry(
    const float* __restrict__ cs, const float* __restrict__ own, const float* __restrict__ e_fwd,
    float* __restrict__ e_out, bf16* __restrict__ half_out, float* __restrict__ dot_out, Dims d) {
  __shared__ float red[4];
  const int slice = blockIdx.x, nslices = gridDim.x;
  const int b = blockIdx.y / d.H, h = blockIdx.y % d.H;
  const int pn = d.P * d.N;
  const int e0 = slice * kCarrySlice + 8 * threadIdx.x;
  const bool mine = e0 < pn;
  auto chunk = [&](int step) { return REV ? d.K - 1 - step : step; };
  float carry[8] = {}, v[8] = {}, e[8] = {};
  float decay = 0.f;
  {
    const long long bhk = bhk_of(d, b, h, chunk(0));
    if (mine) load8(own + bhk * pn + e0, v);
    if (REV && mine && chunk(0) + 1 < d.K) load8(e_fwd + (bhk + 1) * pn + e0, e);
    decay = cs[bhk * d.L + d.L - 1];
  }
  for (int step = 0; step < d.K; ++step) {
    const int k = chunk(step);
    const long long bhk = bhk_of(d, b, h, k);
    float vn[8] = {}, en[8] = {}, decay_n = 0.f;
    if (step + 1 < d.K) {
      const long long nx = bhk_of(d, b, h, chunk(step + 1));
      if (mine) load8(own + nx * pn + e0, vn);
      if (REV && mine && chunk(step + 1) + 1 < d.K) load8(e_fwd + (nx + 1) * pn + e0, en);
      decay_n = cs[nx * d.L + d.L - 1];
    }
    float dot = 0.f;
    if (mine) {
      uint4 packed;
      packed.x = pack_bf16(carry[0], carry[1]);
      packed.y = pack_bf16(carry[2], carry[3]);
      packed.z = pack_bf16(carry[4], carry[5]);
      packed.w = pack_bf16(carry[6], carry[7]);
      *reinterpret_cast<uint4*>(half_out + bhk * pn + e0) = packed;
      if (REV) {
#pragma unroll
        for (int q = 0; q < 8; ++q) dot += carry[q] * e[q];
      } else {
        float* o = e_out + bhk * pn + e0;
        *reinterpret_cast<float4*>(o) = make_float4(carry[0], carry[1], carry[2], carry[3]);
        *reinterpret_cast<float4*>(o + 4) = make_float4(carry[4], carry[5], carry[6], carry[7]);
      }
      const float f = expf(decay);
#pragma unroll
      for (int q = 0; q < 8; ++q) carry[q] = f * carry[q] + v[q];
    }
    if (REV) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
      __syncthreads();  // the last chunk's sums are read
      if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = dot;
      __syncthreads();
      if (threadIdx.x == 0) dot_out[bhk * nslices + slice] = (red[0] + red[1]) + (red[2] + red[3]);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = vn[q], e[q] = en[q];
    decay = decay_n;
  }
}

// ------------------------------------------------------------- (c) output
template <int PT, int NT>
__global__ void __launch_bounds__(kThreads) ssd_out(
    const bf16* __restrict__ x, const float* __restrict__ dt, const bf16* __restrict__ cm,
    const float* __restrict__ cb, const float* __restrict__ cs, const bf16* __restrict__ E16,
    float* __restrict__ y, Dims d) {
  constexpr int LDP = PT + 8, LDN = NT + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Es = reinterpret_cast<bf16*>(smem);
  bf16* Cs = Es + PT * LDN;
  bf16* Xs = Cs;  // C is read only before the first x tile is staged
  float* csS = reinterpret_cast<float*>(Cs + kTile * (LDN > LDP ? LDN : LDP));
  float* dtS = csS + d.Lp;

  const int t = blockIdx.x, k = blockIdx.y, b = blockIdx.z / d.H, h = blockIdx.z % d.H;
  const int g = h / (d.H / d.G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tig = lane & 3;
  const long long bhk = bhk_of(d, b, h, k);
  const long long s0 = static_cast<long long>(b) * d.S + k * d.L;
  const int nval = valid_rows(d, k, 0, d.Lp);
  for (int i = threadIdx.x; i < d.Lp; i += kThreads) {
    csS[i] = i < d.L ? cs[bhk * d.L + i] * kLog2e : 0.f;
    dtS[i] = i < nval ? dt[(s0 + i) * d.H + h] : 0.f;
  }
  copy_async<NT>(Cs, cm + (s0 + t * kTile) * d.cs + g * d.N, d.cs, kTile,
                 valid_rows(d, k, t * kTile, kTile), d.N);
  copy_async<NT>(Es, E16 + bhk * d.P * d.N, d.N, PT, d.P, d.N);
  landed();
  __syncthreads();

  const int il = t * kTile + 16 * warp + (lane >> 2), ih = il + 8;
  const float* cb0 = cb + (static_cast<long long>(b * d.G + g) * d.K + k) * d.Lp * d.Lp;
  float acc[PT / 8][4] = {};
  // e^{cs_i}·C_i·E_kᵀ
#pragma unroll
  for (int kk = 0; kk < NT / 16; ++kk) {
    unsigned a[4];
    ldsm_x4(a, a_rows(Cs, LDN, 16 * warp, 16 * kk, lane));
#pragma unroll
    for (int q = 0; q < PT / 16; ++q) {
      unsigned f[4];
      ldsm_x4(f, k_rows(Es, LDN, 16 * q, 16 * kk, lane));
      mma_bf16(acc[2 * q], a, f[0], f[1]);
      mma_bf16(acc[2 * q + 1], a, f[2], f[3]);
    }
  }
  const float cs_l = csS[il], cs_h = csS[ih];
  {
    const float el = il < d.L ? exp2_fast(cs_l) : 0.f, eh = ih < d.L ? exp2_fast(cs_h) : 0.f;
#pragma unroll
    for (int c = 0; c < PT / 8; ++c) {
      acc[c][0] *= el, acc[c][1] *= el, acc[c][2] *= eh, acc[c][3] *= eh;
    }
  }
  // Σ_{j≤i} bf16(CB_ij·e^{cs_i − cs_j}·Δ_j)·x_j
  auto m = [&](int i, float cs_i, int j, float c) {
    return (j <= i && i < d.L) ? c * exp2_fast(cs_i - csS[j]) * dtS[j] : 0.f;
  };
  for (int u = 0; u <= t; ++u) {
    __syncthreads();
    copy_async<PT>(Xs, x + (s0 + u * kTile) * d.xs + h * d.P, d.xs, kTile,
                   valid_rows(d, k, u * kTile, kTile), d.P);
    landed();
    __syncthreads();
    const int jbs = u < t ? 4 : warp + 1;
    // this block's four CB pairs (rows il, ih; columns j0, j0 + 8), the
    // next block's loaded while this one is used
    auto cb_pairs = [&](int jb, float2 (&v)[4]) {
      const float* cbl = cb0 + static_cast<long long>(il) * d.Lp + u * kTile + 16 * jb + 2 * tig;
      v[0] = *reinterpret_cast<const float2*>(cbl);
      v[1] = *reinterpret_cast<const float2*>(cbl + 8 * d.Lp);
      v[2] = *reinterpret_cast<const float2*>(cbl + 8);
      v[3] = *reinterpret_cast<const float2*>(cbl + 8 * d.Lp + 8);
    };
    float2 cur[4], nxt[4] = {};
    cb_pairs(0, cur);
    for (int jb = 0; jb < jbs; ++jb) {
      if (jb + 1 < jbs) cb_pairs(jb + 1, nxt);
      const int j0 = u * kTile + 16 * jb + 2 * tig;
      const float2 cl0 = cur[0], ch0 = cur[1], cl1 = cur[2], ch1 = cur[3];
      unsigned a[4];
      a[0] = pack_bf16(m(il, cs_l, j0, cl0.x), m(il, cs_l, j0 + 1, cl0.y));
      a[1] = pack_bf16(m(ih, cs_h, j0, ch0.x), m(ih, cs_h, j0 + 1, ch0.y));
      a[2] = pack_bf16(m(il, cs_l, j0 + 8, cl1.x), m(il, cs_l, j0 + 9, cl1.y));
      a[3] = pack_bf16(m(ih, cs_h, j0 + 8, ch1.x), m(ih, cs_h, j0 + 9, ch1.y));
#pragma unroll
      for (int q = 0; q < PT / 16; ++q) {
        unsigned f[4];
        ldsm_x4_trans(f, a_rows(Xs, LDP, 16 * jb, 16 * q, lane));
        mma_bf16(acc[2 * q], a, f[0], f[1]);
        mma_bf16(acc[2 * q + 1], a, f[2], f[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) cur[e] = nxt[e];
    }
  }
  const int vrows = valid_rows(d, k, 0, d.Lp);
#pragma unroll
  for (int c = 0; c < PT / 8; ++c) {
    const int p = 8 * c + 2 * tig;
    if (p >= d.P) continue;
    if (il < vrows)
      *reinterpret_cast<float2*>(y + ((s0 + il) * d.H + h) * d.P + p) =
          make_float2(acc[c][0], acc[c][1]);
    if (ih < vrows)
      *reinterpret_cast<float2*>(y + ((s0 + ih) * d.H + h) * d.P + p) =
          make_float2(acc[c][2], acc[c][3]);
  }
}

// ------------------------------------------------- (e) backward by rows j
template <int PT, int NT>
__global__ void __launch_bounds__(kThreads) ssd_bwd_j(
    const bf16* __restrict__ x, const float* __restrict__ dt, const bf16* __restrict__ bm,
    const bf16* __restrict__ cm, const float* __restrict__ cb, const float* __restrict__ cs,
    const bf16* __restrict__ gst, const bf16* __restrict__ dy16, bf16* __restrict__ dx,
    float* __restrict__ r_out, float* __restrict__ q_out, float* __restrict__ db_part, Dims d,
    int hpb) {
  constexpr int LDP = PT + 8, LDN = NT + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Bs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Bs + kTile * LDN;
  bf16* Xs = Gs + PT * LDN;
  bf16* Cs2 = Xs + kTile * LDP;  // two buffers each of C and dy rows i
  bf16* Ds2 = Cs2 + 2 * kTile * LDN;
  float* csS = reinterpret_cast<float*>(Ds2 + 2 * kTile * LDP);
  float* dtS = csS + d.Lp;

  const int nhg = d.H / d.G / hpb;
  const int t = blockIdx.x, k = blockIdx.y;
  const int b = blockIdx.z / (d.G * nhg), g = blockIdx.z / nhg % d.G, hg = blockIdx.z % nhg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tig = lane & 3;
  const long long s0 = static_cast<long long>(b) * d.S + k * d.L;
  const int nval = valid_rows(d, k, 0, d.Lp);
  const int rl = 16 * warp + (lane >> 2);  // rows of the j tile: rl and rl + 8
  const int jrow[2] = {t * kTile + rl, t * kTile + rl + 8};
  const float* cb0 = cb + (static_cast<long long>(b * d.G + g) * d.K + k) * d.Lp * d.Lp;

  copy_async<NT>(Bs, bm + (s0 + t * kTile) * d.bs + g * d.N, d.bs, kTile,
                 valid_rows(d, k, t * kTile, kTile), d.N);
  float dbacc[NT / 8][4] = {};
  for (int e = 0; e < hpb; ++e) {
    const int h = g * (d.H / d.G) + hg * hpb + e;
    const long long bhk = bhk_of(d, b, h, k);
    __syncthreads();
    for (int i = threadIdx.x; i < d.Lp; i += kThreads) {
      csS[i] = i < d.L ? cs[bhk * d.L + i] * kLog2e : 0.f;
      dtS[i] = i < nval ? dt[(s0 + i) * d.H + h] : 0.f;
    }
    copy_async<PT>(Xs, x + (s0 + t * kTile) * d.xs + h * d.P, d.xs, kTile,
                   valid_rows(d, k, t * kTile, kTile), d.P);
    copy_async<NT>(Gs, gst + bhk * d.P * d.N, d.N, PT, d.P, d.N);
    landed();
    __syncthreads();

    const float cs_last = csS[d.L - 1];
    float csj[2], dtj[2], to_end[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      csj[hf] = csS[jrow[hf]];
      dtj[hf] = dtS[jrow[hf]];
      to_end[hf] = jrow[hf] < d.L ? exp2_fast(cs_last - csj[hf]) : 0.f;
    }
    auto fetch = [&](int u, int bi) {
      const int uval = valid_rows(d, k, u * kTile, kTile);
      copy_async<PT>(Ds2 + bi * kTile * LDP, dy16 + ((s0 + u * kTile) * d.H + h) * d.P,
                     static_cast<long long>(d.H) * d.P, kTile, uval, d.P);
      copy_async<NT>(Cs2 + bi * kTile * LDN, cm + (s0 + u * kTile) * d.cs + g * d.N, d.cs, kTile,
                     uval, d.N);
      attn::cp_async_commit();
    };
    fetch(t, 0);  // in flight while the state's part runs
    unsigned xa[PT / 16][4];
#pragma unroll
    for (int kk = 0; kk < PT / 16; ++kk) ldsm_x4(xa[kk], a_rows(Xs, LDP, 16 * warp, 16 * kk, lane));

    // the state's part: dxd_j = e^{cs_L − cs_j}·B_j·Ĝᵀ and
    // dB_j += e^{cs_L − cs_j}·Δ_j·x_j·Ĝ
    float dxd[PT / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < NT / 16; ++kk) {
      unsigned a[4];
      ldsm_x4(a, a_rows(Bs, LDN, 16 * warp, 16 * kk, lane));
#pragma unroll
      for (int q = 0; q < PT / 16; ++q) {
        unsigned f[4];
        ldsm_x4(f, k_rows(Gs, LDN, 16 * q, 16 * kk, lane));
        mma_bf16(dxd[2 * q], a, f[0], f[1]);
        mma_bf16(dxd[2 * q + 1], a, f[2], f[3]);
      }
    }
    // dcs_j loses Δ_j·x_j·dxd_state_j (and Σ_{i>j} W_ij below)
    float lose[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < PT / 8; ++c) {
      const int p = 8 * c + 2 * tig;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        dxd[c][2 * hf] *= to_end[hf];
        dxd[c][2 * hf + 1] *= to_end[hf];
        lose[hf] += dtj[hf] * (bf16_at(Xs, (rl + 8 * hf) * LDP + p) * dxd[c][2 * hf] +
                               bf16_at(Xs, (rl + 8 * hf) * LDP + p + 1) * dxd[c][2 * hf + 1]);
      }
    }
    {
      const float sl = dtj[0] * to_end[0], sh = dtj[1] * to_end[1];
#pragma unroll
      for (int kk = 0; kk < PT / 16; ++kk) {
        const unsigned a[4] = {scale_pair(xa[kk][0], sl), scale_pair(xa[kk][1], sh),
                               scale_pair(xa[kk][2], sl), scale_pair(xa[kk][3], sh)};
#pragma unroll
        for (int q = 0; q < NT / 16; ++q) {
          unsigned f[4];
          ldsm_x4_trans(f, a_rows(Gs, LDN, 16 * kk, 16 * q, lane));
          mma_bf16(dbacc[2 * q], a, f[0], f[1]);
          mma_bf16(dbacc[2 * q + 1], a, f[2], f[3]);
        }
      }
    }

    // the causal part, over the rows i ≥ j, 64 at a time: the next tile's
    // copies in flight while this one is used
    for (int u = t; u < d.T; ++u) {
      const int bi = (u - t) & 1;
      __syncthreads();  // the other buffers' last reads are done
      if (u + 1 < d.T) {
        fetch(u + 1, bi ^ 1);
        attn::cp_async_wait<1>();
      } else {
        attn::cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* Ds = Ds2 + bi * kTile * LDP;
      const bf16* Cs = Cs2 + bi * kTile * LDN;
      for (int ib = (u == t ? warp : 0); ib < 4; ++ib) {
        const int i0 = u * kTile + 16 * ib + 2 * tig;
        // (x_j·dy_i) over the block's 16 rows i
        float sa[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < PT / 16; ++kk) {
          unsigned f[4];
          ldsm_x4(f, k_rows(Ds, LDP, 16 * ib, 16 * kk, lane));
          mma_bf16(sa[0], xa[kk], f[0], f[1]);
          mma_bf16(sa[1], xa[kk], f[2], f[3]);
        }
        // register r of an A fragment: row jrow[r & 1], columns i0 + 8·(r >> 1) + {0, 1}
        unsigned w[4], a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int hf = r & 1, j = jrow[hf];
          float wv[2], mv[2];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int i = i0 + 8 * (r >> 1) + e2;
            const float dec = (i >= j && i < d.L) ? exp2_fast(csS[i] - csj[hf]) : 0.f;
            const float cbv = cb0[static_cast<long long>(i) * d.Lp + j];
            wv[e2] = sa[r >> 1][2 * hf + e2] * dtj[hf] * dec;
            mv[e2] = cbv * dec;
            if (i > j) lose[hf] += wv[e2] * cbv;
          }
          w[r] = pack_bf16(wv[0], wv[1]);
          a[r] = pack_bf16(mv[0], mv[1]);
        }
        // dB_j += Σ_i bf16(W'_ji)·C_i; dxd_j += Σ_i bf16(CB_ij·e^{cs_i − cs_j})·dy_i
#pragma unroll
        for (int q = 0; q < NT / 16; ++q) {
          unsigned f[4];
          ldsm_x4_trans(f, a_rows(Cs, LDN, 16 * ib, 16 * q, lane));
          mma_bf16(dbacc[2 * q], w, f[0], f[1]);
          mma_bf16(dbacc[2 * q + 1], w, f[2], f[3]);
        }
#pragma unroll
        for (int q = 0; q < PT / 16; ++q) {
          unsigned f[4];
          ldsm_x4_trans(f, a_rows(Ds, LDP, 16 * ib, 16 * q, lane));
          mma_bf16(dxd[2 * q], a, f[0], f[1]);
          mma_bf16(dxd[2 * q + 1], a, f[2], f[3]);
        }
      }
    }

    // dx = Δ·dxd; r_j = x_j·dxd_j
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < PT / 8; ++c) {
      const int p = 8 * c + 2 * tig;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = jrow[hf];
        rsum[hf] += bf16_at(Xs, (rl + 8 * hf) * LDP + p) * dxd[c][2 * hf] +
                    bf16_at(Xs, (rl + 8 * hf) * LDP + p + 1) * dxd[c][2 * hf + 1];
        if (p < d.P && j < nval)
          *reinterpret_cast<unsigned*>(dx + ((s0 + j) * d.H + h) * d.P + p) =
              pack_bf16(dxd[c][2 * hf] * dtj[hf], dxd[c][2 * hf + 1] * dtj[hf]);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float rs = quad_sum(rsum[hf]), ls = quad_sum(lose[hf]);
      if (tig == 0 && jrow[hf] < d.L) {
        r_out[bhk * d.L + jrow[hf]] = rs;
        q_out[bhk * d.L + jrow[hf]] = ls;
      }
    }
  }
  const long long part = static_cast<long long>(hg) * d.B * d.S;
#pragma unroll
  for (int c = 0; c < NT / 8; ++c) {
    const int n = 8 * c + 2 * tig;
    if (n >= d.N) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (jrow[hf] < nval)
        *reinterpret_cast<float2*>(db_part + ((part + s0 + jrow[hf]) * d.G + g) * d.N + n) =
            make_float2(dbacc[c][2 * hf], dbacc[c][2 * hf + 1]);
  }
}

// ------------------------------------------------- (f) backward by rows i
template <int PT, int NT>
__global__ void __launch_bounds__(kThreads) ssd_bwd_i(
    const bf16* __restrict__ x, const float* __restrict__ dt, const bf16* __restrict__ bm,
    const bf16* __restrict__ cm, const float* __restrict__ cb, const float* __restrict__ cs,
    const bf16* __restrict__ E16, const float* __restrict__ dy, const bf16* __restrict__ dy16,
    float* __restrict__ u_out, float* __restrict__ dc_part, Dims d, int hpb) {
  constexpr int LDP = PT + 8, LDN = NT + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem);
  bf16* Es = Cs + kTile * LDN;
  bf16* Ds = Es + PT * LDN;
  bf16* Bs2 = Ds + kTile * LDP;  // two buffers each of B and x rows j
  bf16* Xs2 = Bs2 + 2 * kTile * LDN;
  float* csS = reinterpret_cast<float*>(Xs2 + 2 * kTile * LDP);
  float* dtS = csS + d.Lp;

  const int nhg = d.H / d.G / hpb;
  const int t = blockIdx.x, k = blockIdx.y;
  const int b = blockIdx.z / (d.G * nhg), g = blockIdx.z / nhg % d.G, hg = blockIdx.z % nhg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tig = lane & 3;
  const long long s0 = static_cast<long long>(b) * d.S + k * d.L;
  const int nval = valid_rows(d, k, 0, d.Lp);
  const int tval = valid_rows(d, k, t * kTile, kTile);
  const int rl = 16 * warp + (lane >> 2);
  const int irow[2] = {t * kTile + rl, t * kTile + rl + 8};
  const float* cb0 = cb + (static_cast<long long>(b * d.G + g) * d.K + k) * d.Lp * d.Lp;

  copy_async<NT>(Cs, cm + (s0 + t * kTile) * d.cs + g * d.N, d.cs, kTile, tval, d.N);
  float dcacc[NT / 8][4] = {};
  for (int e = 0; e < hpb; ++e) {
    const int h = g * (d.H / d.G) + hg * hpb + e;
    const long long bhk = bhk_of(d, b, h, k);
    __syncthreads();
    for (int i = threadIdx.x; i < d.Lp; i += kThreads) {
      csS[i] = i < d.L ? cs[bhk * d.L + i] * kLog2e : 0.f;
      dtS[i] = i < nval ? dt[(s0 + i) * d.H + h] : 0.f;
    }
    const float* dyt = dy + ((s0 + t * kTile) * d.H + h) * d.P;
    copy_async<PT>(Ds, dy16 + ((s0 + t * kTile) * d.H + h) * d.P,
                   static_cast<long long>(d.H) * d.P, kTile, tval, d.P);
    copy_async<NT>(Es, E16 + bhk * d.P * d.N, d.N, PT, d.P, d.N);
    landed();
    __syncthreads();

    float csi[2], ecs[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      csi[hf] = csS[irow[hf]];
      ecs[hf] = irow[hf] < d.L ? exp2_fast(csi[hf]) : 0.f;
    }
    auto fetch = [&](int u, int bi) {
      const int uval = valid_rows(d, k, u * kTile, kTile);
      copy_async<PT>(Xs2 + bi * kTile * LDP, x + (s0 + u * kTile) * d.xs + h * d.P, d.xs, kTile,
                     uval, d.P);
      copy_async<NT>(Bs2 + bi * kTile * LDN, bm + (s0 + u * kTile) * d.bs + g * d.N, d.bs, kTile,
                     uval, d.N);
      attn::cp_async_commit();
    };
    fetch(0, 0);  // in flight while E's part runs
    unsigned da[PT / 16][4];
#pragma unroll
    for (int kk = 0; kk < PT / 16; ++kk) ldsm_x4(da[kk], a_rows(Ds, LDP, 16 * warp, 16 * kk, lane));
    // dy_i in f32 at this thread's rows and column pairs, read once
    float2 dyv[2][PT / 8];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int c = 0; c < PT / 8; ++c) {
        const int p = 8 * c + 2 * tig;
        dyv[hf][c] = (rl + 8 * hf < tval && p < d.P)
                         ? *reinterpret_cast<const float2*>(
                               dyt + static_cast<long long>(rl + 8 * hf) * d.H * d.P + p)
                         : make_float2(0.f, 0.f);
      }
    // dcs_i gains dy_i·y_off_i, y_off_i = e^{cs_i}·C_i·E_kᵀ (as the forward
    // forms it)
    float gain[2] = {0.f, 0.f};
    {
      float yo[PT / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < NT / 16; ++kk) {
        unsigned a[4];
        ldsm_x4(a, a_rows(Cs, LDN, 16 * warp, 16 * kk, lane));
#pragma unroll
        for (int q = 0; q < PT / 16; ++q) {
          unsigned f[4];
          ldsm_x4(f, k_rows(Es, LDN, 16 * q, 16 * kk, lane));
          mma_bf16(yo[2 * q], a, f[0], f[1]);
          mma_bf16(yo[2 * q + 1], a, f[2], f[3]);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int c = 0; c < PT / 8; ++c)
          gain[hf] += ecs[hf] * (dyv[hf][c].x * yo[c][2 * hf] + dyv[hf][c].y * yo[c][2 * hf + 1]);
    }
    // dC_i += e^{cs_i}·dy_i·E_k, the A operand bf16(e^{cs_i}·dy_i)
#pragma unroll
    for (int kk = 0; kk < PT / 16; ++kk) {
      const unsigned a[4] = {
          pack_bf16(dyv[0][2 * kk].x * ecs[0], dyv[0][2 * kk].y * ecs[0]),
          pack_bf16(dyv[1][2 * kk].x * ecs[1], dyv[1][2 * kk].y * ecs[1]),
          pack_bf16(dyv[0][2 * kk + 1].x * ecs[0], dyv[0][2 * kk + 1].y * ecs[0]),
          pack_bf16(dyv[1][2 * kk + 1].x * ecs[1], dyv[1][2 * kk + 1].y * ecs[1])};
#pragma unroll
      for (int q = 0; q < NT / 16; ++q) {
        unsigned f[4];
        ldsm_x4_trans(f, a_rows(Es, LDN, 16 * kk, 16 * q, lane));
        mma_bf16(dcacc[2 * q], a, f[0], f[1]);
        mma_bf16(dcacc[2 * q + 1], a, f[2], f[3]);
      }
    }
    for (int u = 0; u <= t; ++u) {
      const int bi = u & 1;
      __syncthreads();  // the other buffers' last reads are done
      if (u < t) {
        fetch(u + 1, bi ^ 1);
        attn::cp_async_wait<1>();
      } else {
        attn::cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* Xs = Xs2 + bi * kTile * LDP;
      const bf16* Bs = Bs2 + bi * kTile * LDN;
      const int jbs = u < t ? 4 : warp + 1;
      for (int jb = 0; jb < jbs; ++jb) {
        const int j0 = u * kTile + 16 * jb + 2 * tig;
        float sa[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < PT / 16; ++kk) {
          unsigned f[4];
          ldsm_x4(f, k_rows(Xs, LDP, 16 * jb, 16 * kk, lane));
          mma_bf16(sa[0], da[kk], f[0], f[1]);
          mma_bf16(sa[1], da[kk], f[2], f[3]);
        }
        // register r: row irow[r & 1], columns j0 + 8·(r >> 1) + {0, 1}
        unsigned w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int hf = r & 1, i = irow[hf], jj = j0 + 8 * (r >> 1);
          const float2 cbv =
              *reinterpret_cast<const float2*>(cb0 + static_cast<long long>(i) * d.Lp + jj);
          float wv[2];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int j = jj + e2;
            wv[e2] = (j <= i && i < d.L)
                         ? sa[r >> 1][2 * hf + e2] * dtS[j] * exp2_fast(csi[hf] - csS[j]) : 0.f;
            if (j < i) gain[hf] += wv[e2] * (e2 ? cbv.y : cbv.x);
          }
          w[r] = pack_bf16(wv[0], wv[1]);
        }
#pragma unroll
        for (int q = 0; q < NT / 16; ++q) {
          unsigned f[4];
          ldsm_x4_trans(f, a_rows(Bs, LDN, 16 * jb, 16 * q, lane));
          mma_bf16(dcacc[2 * q], w, f[0], f[1]);
          mma_bf16(dcacc[2 * q + 1], w, f[2], f[3]);
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float gs = quad_sum(gain[hf]);
      if (tig == 0 && irow[hf] < d.L) u_out[bhk * d.L + irow[hf]] = gs;
    }
  }
  const long long part = static_cast<long long>(hg) * d.B * d.S;
#pragma unroll
  for (int c = 0; c < NT / 8; ++c) {
    const int n = 8 * c + 2 * tig;
    if (n >= d.N) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (irow[hf] < nval)
        *reinterpret_cast<float2*>(dc_part + ((part + s0 + irow[hf]) * d.G + g) * d.N + n) =
            make_float2(dcacc[c][2 * hf], dcacc[c][2 * hf + 1]);
  }
}

// ------------------------------------------------------- (g) dΔ and dA
__global__ void __launch_bounds__(kThreads) ssd_bwd_dt(
    const float* __restrict__ dt, const float* __restrict__ A, const float* __restrict__ r,
    const float* __restrict__ u, const float* __restrict__ q, const float* __restrict__ dots,
    int nslices,
    float* __restrict__ ddt, float* __restrict__ dA, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* v = reinterpret_cast<float*>(smem);
  __shared__ float red[4];
  const int h = blockIdx.x;
  const float a_h = A[h];
  float part = 0.f;
  for (int b = 0; b < d.B; ++b) {
    for (int k = 0; k < d.K; ++k) {
      const long long bhk = bhk_of(d, b, h, k);
      const long long s0 = static_cast<long long>(b) * d.S + k * d.L;
      const int nval = valid_rows(d, k, 0, d.L);
      float dot = 0.f;
      for (int sl = 0; sl < nslices; ++sl) dot += dots[bhk * nslices + sl];
      __syncthreads();
      for (int i = threadIdx.x; i < d.L; i += kThreads) {
        float c = 0.f;
        if (i < nval) {
          c = u[bhk * d.L + i] - q[bhk * d.L + i];
          if (i == d.L - 1) c += dot;
        }
        v[i] = c;
      }
      __syncthreads();
      if (threadIdx.x < 32) warp_scan(v, d.L, true);
      __syncthreads();
      for (int i = threadIdx.x; i < nval; i += kThreads) {
        const float dti = dt[(s0 + i) * d.H + h];
        ddt[(s0 + i) * d.H + h] = r[bhk * d.L + i] + a_h * v[i];
        part += dti * v[i];
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x == 0) dA[h] = (red[0] + red[1]) + (red[2] + red[3]);
}

// --------------------------------------------------- (h) dB and dC, bf16
__global__ void ssd_bwd_sum(const float* __restrict__ db_part, const float* __restrict__ dc_part,
                            int parts, long long count, bf16* __restrict__ db,
                            bf16* __restrict__ dc) {
  const float* src = blockIdx.y == 0 ? db_part : dc_part;
  bf16* dst = blockIdx.y == 0 ? db : dc;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < count;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < parts; ++q) s += src[q * count + e];
    dst[e] = __float2bfloat16(s);
  }
}

// ------------------------------------------------- the inputs' row layout
// The mixer's x, B and C are views of the depthwise conv's (Bt, C, S)
// output, a token apart along S and S apart along the channels: a block
// turns a 64-token × 64-channel tile of (Bt, S, W) with any strides into
// rows of W contiguous channels, through shared memory (reads along the
// source's tokens, writes along the rows). VEC: eight tokens a 16-byte
// read and eight channels a 16-byte write (the wrapper checks the
// alignment), else one element at a time.
template <bool VEC>
__global__ void __launch_bounds__(256) ssd_pack(const bf16* __restrict__ src, long long sb,
                                                long long ss, long long sw, int S, int W,
                                                bf16* __restrict__ dst) {
  __shared__ bf16 tile[kTile][kTile + 2];
  const int s0 = blockIdx.x * kTile, w0 = blockIdx.y * kTile, b = blockIdx.z;
  const bf16 zero = __float2bfloat16(0.f);
  const bf16* base = src + b * sb;
  if (VEC) {
    for (int e = threadIdx.x; e < kTile * kTile / 8; e += 256) {
      const int c = e / (kTile / 8), tk = 8 * (e % (kTile / 8)), s = s0 + tk, w = w0 + c;
      if (w < W && s + 8 <= S) {
        const uint4 u = *reinterpret_cast<const uint4*>(base + s + w * sw);
        const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int q = 0; q < 8; ++q) tile[tk + q][c] = v[q];
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          tile[tk + q][c] = (w < W && s + q < S) ? base[s + q + w * sw] : zero;
      }
    }
  } else {
    for (int e = threadIdx.x; e < kTile * kTile; e += 256) {
      const int c = e / kTile, tk = e % kTile, s = s0 + tk, w = w0 + c;
      tile[tk][c] = (s < S && w < W) ? base[s * ss + w * sw] : zero;
    }
  }
  __syncthreads();
  if (VEC) {
    for (int e = threadIdx.x; e < kTile * kTile / 8; e += 256) {
      const int tk = e / (kTile / 8), c = 8 * (e % (kTile / 8)), s = s0 + tk, w = w0 + c;
      if (s >= S || w >= W) continue;
      uint4 u;
      bf16* v = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = tile[tk][c + q];
      *reinterpret_cast<uint4*>(dst + (static_cast<long long>(b) * S + s) * W + w) = u;
    }
  } else {
    for (int e = threadIdx.x; e < kTile * kTile; e += 256) {
      const int tk = e / kTile, c = e % kTile, s = s0 + tk, w = w0 + c;
      if (s < S && w < W) dst[(static_cast<long long>(b) * S + s) * W + w] = tile[tk][c];
    }
  }
}

// ------------------------------------------------------------------ host
Dims dims(int B, int S, int H, int P, int G, int N, int L, long long xs, long long bs,
          long long cs) {
  Dims d;
  d.B = B, d.S = S, d.H = H, d.P = P, d.G = G, d.N = N, d.L = L;
  d.K = (S + L - 1) / L;
  d.T = (L + kTile - 1) / kTile;
  d.Lp = d.T * kTile;
  d.Lr = (L + 15) / 16 * 16;
  d.xs = xs, d.bs = bs, d.cs = cs;
  return d;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int carry_slices(const Dims& d) { return (d.P * d.N + kCarrySlice - 1) / kCarrySlice; }

constexpr size_t tile_bytes(int rows, int width) {
  return static_cast<size_t>(rows) * (width + 8) * 2;
}

template <int PT, int NT>
int fwd(const bf16* x, const float* dt, const float* A, const bf16* bm, const bf16* cm, float* y,
        float* cs, float* cb, float* E, bf16* E16, float* own, const Dims& d, cudaStream_t st) {
  constexpr int NW = NT;  // one state tile a head: x staged once
  cudaError_t err;
  {
    const size_t smem = 2 * tile_bytes(kTile, NT);
    if ((err = allow_smem(ssd_cb<NT>, smem)) != cudaSuccess) return err;
    ssd_cb<NT><<<dim3(d.T * (d.T + 1) / 2, d.K, d.B * d.G), kThreads, smem, st>>>(bm, cm, cb, d);
  }
  {
    const size_t smem = tile_bytes(kTile, PT) + tile_bytes(kTile, NW) + 2 * d.Lr * sizeof(float);
    if ((err = allow_smem(ssd_chunk_state<PT, NW, false>, smem)) != cudaSuccess) return err;
    ssd_chunk_state<PT, NW, false><<<dim3(NT / NW, d.K, d.B * d.H), kThreads, smem, st>>>(
        x, dt, A, bm, d.bs, nullptr, cs, own, nullptr, d);
  }
  ssd_carry<false><<<dim3(carry_slices(d), d.B * d.H), kThreads, 0, st>>>(cs, own, nullptr, E,
                                                                        E16, nullptr, d);
  {
    const size_t smem = tile_bytes(PT, NT) + tile_bytes(kTile, NT > PT ? NT : PT) +
                        2 * d.Lp * sizeof(float);
    if ((err = allow_smem(ssd_out<PT, NT>, smem)) != cudaSuccess) return err;
    ssd_out<PT, NT><<<dim3(d.T, d.K, d.B * d.H), kThreads, smem, st>>>(x, dt, cm, cb, cs, E16, y,
                                                                         d);
  }
  return cudaGetLastError();
}

template <int PT, int NT>
int bwd(const bf16* x, const float* dt, const float* A, const bf16* bm, const bf16* cm,
        const float* cs, const float* cb, const float* E, const bf16* E16, const float* dy,
        bf16* dx, float* ddt, float* dA, bf16* db, bf16* dc, bf16* gst, float* own, bf16* dy16,
        float* dots, float* r, float* u, float* q, float* db_part, float* dc_part, const Dims& d,
        int hpb, cudaStream_t st) {
  constexpr int NW = NT < 64 ? NT : 64;  // two blocks a head at N 128: more in flight
  const int nhg = d.H / d.G / hpb;
  cudaError_t err;
  {
    const size_t smem = tile_bytes(kTile, PT) + tile_bytes(kTile, NW) + 2 * d.Lr * sizeof(float);
    if ((err = allow_smem(ssd_chunk_state<PT, NW, true>, smem)) != cudaSuccess) return err;
    ssd_chunk_state<PT, NW, true><<<dim3(NT / NW, d.K, d.B * d.H), kThreads, smem, st>>>(
        x, dt, A, cm, d.cs, dy, const_cast<float*>(cs), own, dy16, d);
  }
  ssd_carry<true><<<dim3(carry_slices(d), d.B * d.H), kThreads, 0, st>>>(cs, own, E, nullptr, gst,
                                                                       dots, d);
  const dim3 grid(d.T, d.K, d.B * d.G * nhg);
  {
    const size_t smem = 3 * tile_bytes(kTile, NT) + tile_bytes(PT, NT) + 3 * tile_bytes(kTile, PT) +
                        2 * d.Lp * sizeof(float);
    if ((err = allow_smem(ssd_bwd_j<PT, NT>, smem)) != cudaSuccess) return err;
    ssd_bwd_j<PT, NT><<<grid, kThreads, smem, st>>>(x, dt, bm, cm, cb, cs, gst, dy16, dx, r, q,
                                                   db_part, d, hpb);
  }
  {
    const size_t smem = 3 * tile_bytes(kTile, NT) + tile_bytes(PT, NT) + 3 * tile_bytes(kTile, PT) +
                        2 * d.Lp * sizeof(float);
    if ((err = allow_smem(ssd_bwd_i<PT, NT>, smem)) != cudaSuccess) return err;
    ssd_bwd_i<PT, NT><<<grid, kThreads, smem, st>>>(x, dt, bm, cm, cb, cs, E16, dy, dy16, u,
                                                   dc_part, d, hpb);
  }
  ssd_bwd_dt<<<d.H, kThreads, d.L * sizeof(float), st>>>(dt, A, r, u, q, dots, carry_slices(d),
                                                          ddt, dA, d);
  {
    const long long count = static_cast<long long>(d.B) * d.S * d.G * d.N;
    const long long want = (count + 255) / 256;
    const int blocks = static_cast<int>(want < 4096 ? want : 4096);
    ssd_bwd_sum<<<dim3(blocks, 2), 256, 0, st>>>(db_part, dc_part, nhg, count, db, dc);
  }
  return cudaGetLastError();
}

// P ≤ 16 or ≤ 64; N ≤ 16, ≤ 64 or ≤ 128 (the wrapper checks).
#define SSD_DISPATCH(CALL)                                         \
  if (P <= 16) {                                                   \
    if (N <= 16) return CALL(16, 16);                              \
    if (N <= 64) return CALL(16, 64);                              \
    return CALL(16, 128);                                          \
  }                                                                \
  if (N <= 16) return CALL(64, 16);                                \
  if (N <= 64) return CALL(64, 64);                                \
  return CALL(64, 128);

}  // namespace

extern "C" int ssd_pack_bf16(const void* src, long long sb, long long ss, long long sw, int B,
                             int S, int W, void* dst, void* stream) {
  const dim3 grid((S + kTile - 1) / kTile, (W + kTile - 1) / kTile, B);
  const bool vec = ss == 1 && sb % 8 == 0 && sw % 8 == 0 && W % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto s_in = static_cast<const bf16*>(src);
  auto d_out = static_cast<bf16*>(dst);
  if (vec) ssd_pack<true><<<grid, 256, 0, st>>>(s_in, sb, ss, sw, S, W, d_out);
  else ssd_pack<false><<<grid, 256, 0, st>>>(s_in, sb, ss, sw, S, W, d_out);
  return cudaGetLastError();
}

extern "C" int ssd_fwd_bf16(const void* x, const void* dt, const void* A, const void* bm,
                            const void* cm, void* y, void* cs, void* cb, void* E, void* E16,
                            void* own, int B, int S,
                            int H, int P, int G, int N, int L, long long xs, long long bs,
                            long long cst, void* stream) {
  const Dims d = dims(B, S, H, P, G, N, L, xs, bs, cst);
  auto st = static_cast<cudaStream_t>(stream);
#define SSD_FWD(PT_, NT_)                                                                      \
  fwd<PT_, NT_>(static_cast<const bf16*>(x), static_cast<const float*>(dt),                    \
                static_cast<const float*>(A), static_cast<const bf16*>(bm),                    \
                static_cast<const bf16*>(cm), static_cast<float*>(y), static_cast<float*>(cs), \
                static_cast<float*>(cb), static_cast<float*>(E), static_cast<bf16*>(E16),     \
                static_cast<float*>(own), d, st)
  SSD_DISPATCH(SSD_FWD)
#undef SSD_FWD
}

extern "C" int ssd_bwd_bf16(const void* x, const void* dt, const void* A, const void* bm,
                            const void* cm, const void* cs, const void* cb, const void* E,
                            const void* E16, const void* dy, void* dx, void* ddt, void* dA,
                            void* db, void* dc, void* gst, void* own, void* dy16, void* dots,
                            void* r, void* u, void* q, void* db_part, void* dc_part, int B,
                            int S, int H, int P, int G, int N, int L, long long xs,
                            long long bs, long long cst, int hpb, void* stream) {
  const Dims d = dims(B, S, H, P, G, N, L, xs, bs, cst);
  auto st = static_cast<cudaStream_t>(stream);
#define SSD_BWD(PT_, NT_)                                                                       \
  bwd<PT_, NT_>(static_cast<const bf16*>(x), static_cast<const float*>(dt),                     \
                static_cast<const float*>(A), static_cast<const bf16*>(bm),                     \
                static_cast<const bf16*>(cm), static_cast<const float*>(cs),                    \
                static_cast<const float*>(cb), static_cast<const float*>(E),                    \
                static_cast<const bf16*>(E16), static_cast<const float*>(dy),                   \
                static_cast<bf16*>(dx), static_cast<float*>(ddt), static_cast<float*>(dA),      \
                static_cast<bf16*>(db), static_cast<bf16*>(dc), static_cast<bf16*>(gst),        \
                static_cast<float*>(own), static_cast<bf16*>(dy16), static_cast<float*>(dots),  \
                static_cast<float*>(r),                                                         \
                static_cast<float*>(u), static_cast<float*>(q), static_cast<float*>(db_part),   \
                static_cast<float*>(dc_part), d, hpb, st)
  SSD_DISPATCH(SSD_BWD)
#undef SSD_BWD
}
