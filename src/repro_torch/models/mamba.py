"""Mamba-1 block (selective state-space model) of the port — falcon-mamba-7b.

Forward (prefill):  x → in_proj → (u, z);  u → causal conv1d → SiLU →
selective scan (h_t = Ā_t h_{t-1} + B̄_t u_t, y_t = C_t·h_t + D·u_t) →
y·SiLU(z) → out_proj.

Discretization (ZOH on A, Euler on B, as in the Mamba paper):
    Ā_t = exp(Δ_t · A),   B̄_t u_t = Δ_t · B_t · u_t

The scan runs in the hand-written CUDA kernel (``impl="kernel"``,
``repro_torch.kernels.mamba_scan``) or as a loop over time (``impl="torch"``,
the kernel's plain version). Either way the prefill's final state is the
scan's own: the JAX package recomputes it with a second scan over the same
inputs (``model.py::_mamba_prefill``), which a loop over S steps per layer
would make dearer than the prefill itself.

Cast points, as in the JAX package: u and z stay in the compute dtype
through the conv and the SiLU, and ``x_proj`` runs in it; Δ is
softplus(Δ_in @ dt_proj_w, in the compute dtype, → f32 + dt_proj_b); B, C
and A = −(n+1)·exp(a_log) are f32 and the scan is f32; the D skip is added
in f32, the result cast to the compute dtype and gated by SiLU(z) there.

Decode: a single-token state update — the decode cache is (conv window,
ssm state), both O(1) in sequence length.

On a mesh the scan (kernel or plain) runs on each rank's shards, sharded
over batch and the inner channels and whole over time: every channel's
recurrence is its own.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.kernel import mamba_scan_kernel
from repro_torch.kernels.mamba_scan.plain import mamba_scan_plain
from repro_torch.models.common import NO_MESH, ParamModule, ShardCtx

__all__ = ["mamba_params", "mamba_fwd", "mamba_decode", "init_mamba_cache", "_causal_conv"]


def mamba_params(cfg) -> ParamModule:
    d = cfg.d_model
    m = cfg.mamba
    di, ds, dc, dtr = m.d_inner, m.d_state, m.d_conv, cfg.dt_rank
    p = ParamModule()
    # S4D-real initialization for A: A[n] = -(n+1), stored as log(-A).
    p.declare("in_proj", (d, 2 * di), scale=d**-0.5, logical_axes=("fsdp", "inner"))
    p.declare("conv_w", (dc, di), scale=dc**-0.5, logical_axes=("conv", "inner"))
    p.declare("conv_b", (di,), init="zeros", logical_axes=("inner",))
    p.declare("x_proj", (di, dtr + 2 * ds), scale=di**-0.5, logical_axes=("inner", None))
    p.declare("dt_proj_w", (dtr, di), scale=dtr**-0.5, logical_axes=(None, "inner"))
    p.declare("dt_proj_b", (di,), init="constant", scale=-4.6,
              logical_axes=("inner",))  # softplus^-1(0.01)
    p.declare("a_log", (di, ds), init="constant", scale=0.0, logical_axes=("inner", "state"))
    p.declare("d_skip", (di,), init="ones", logical_axes=("inner",))
    p.declare("out_proj", (di, d), scale=di**-0.5, logical_axes=("inner", "fsdp"))
    return p


def _ssm_inputs(u: torch.Tensor, p: ParamModule, cfg):
    """u: (B,S,di) post-conv activations → (Δ, B_t, C_t, A), all f32."""
    ds, dtr = cfg.mamba.d_state, cfg.dt_rank
    proj = u @ p.x_proj.to(u.dtype)
    dt_in, b_in, c_in = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = F.softplus((dt_in @ p.dt_proj_w.to(u.dtype)).float() + p.dt_proj_b.float())
    # A = -(n+1)·exp(a_log): S4D-real with a learnable per-(channel,state) scale
    n_idx = torch.arange(1, ds + 1, dtype=torch.float32, device=u.device)
    a = -(n_idx[None, :] * torch.exp(p.a_log.float()))  # (di, ds)
    return dt, b_in.float().contiguous(), c_in.float().contiguous(), a


def _causal_conv(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, state=None):
    """Depthwise causal conv over time. u: (B,S,di), w: (dc,di).
    state: (B, dc-1, di) trailing context for decode; returns (out, new_state)."""
    dc = w.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], dc - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)  # (B, S+dc-1, di)
    out = sum(
        full[:, i: i + u.shape[1], :] * w[i].to(u.dtype) for i in range(dc)
    ) + bias.to(u.dtype)
    new_state = full[:, -(dc - 1):, :] if dc > 1 else torch.zeros_like(pad)
    return out, new_state


def _gated_out(y, u, z, p):
    """y (f32) + D·u in f32 → compute dtype, gated by SiLU(z), → out_proj."""
    cdt = z.dtype
    y = (y + p.d_skip.float() * u.float()).to(cdt)
    return (y * F.silu(z)) @ p.out_proj.to(cdt)


def mamba_fwd(
    x: torch.Tensor, p: ParamModule, cfg, impl: str = "kernel", ctx: ShardCtx = NO_MESH
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill forward. Returns (out (B,S,D), decode cache {"conv": the last
    dc−1 pre-conv inputs, "ssm": the state after the last step (B, di, ds)
    f32})."""
    di = cfg.mamba.d_inner
    uz = x @ p.in_proj.to(x.dtype)
    u_in, z = uz[..., :di], uz[..., di:]
    u_in = ctx.constrain(u_in, ("batch", "seq", "inner"))
    u, _ = _causal_conv(u_in, p.conv_w, p.conv_b)
    u = F.silu(u)
    dt, b_t, c_t, a = _ssm_inputs(u, p, cfg)
    if impl == "kernel":
        scan = mamba_scan_kernel
    elif impl == "torch":
        scan = mamba_scan_plain
    else:
        raise ValueError(f"unknown mamba impl {impl!r} (kernel or torch)")
    chan, bsd = ("batch", None, "inner"), ("batch", None, None)
    y, h_last = ctx.local_call(
        scan, [(u.float(), chan), (dt, chan), (a, ("inner", None)), (b_t, bsd), (c_t, bsd)],
        [(chan, dt.shape), (("batch", "inner", None), (dt.shape[0], di, a.shape[1]))])
    dc = cfg.mamba.d_conv
    # a copy: a view would keep the whole (B, S, 2·di) projection alive
    conv = u_in[:, -(dc - 1):, :].clone()
    out = ctx.constrain(_gated_out(y, u, z, p), ("batch", "seq", "embed"))
    return out, {"conv": conv, "ssm": h_last}


# ---------------------------------------------------------------------------
# Decode (O(1) state)
# ---------------------------------------------------------------------------
def init_mamba_cache(cfg, batch: int, dtype, device) -> Dict[str, torch.Tensor]:
    m = cfg.mamba
    return {
        "conv": torch.zeros((batch, m.d_conv - 1, m.d_inner), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, m.d_inner, m.d_state), dtype=torch.float32, device=device),
    }


def mamba_decode(
    x: torch.Tensor, p: ParamModule, cfg, cache: Dict[str, torch.Tensor],
    ctx: ShardCtx = NO_MESH,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B,1,D) → (out (B,1,D), new cache)."""
    di = cfg.mamba.d_inner
    uz = x @ p.in_proj.to(x.dtype)
    u, z = uz[..., :di], uz[..., di:]
    u, conv_state = _causal_conv(u, p.conv_w, p.conv_b, cache["conv"])
    u = F.silu(u)
    dt, b_t, c_t, a = _ssm_inputs(u, p, cfg)

    a_bar = torch.exp(dt[:, 0, :, None] * a[None])
    h = a_bar * cache["ssm"] + (dt[:, 0] * u[:, 0].float())[:, :, None] * b_t[:, 0][:, None, :]
    y = torch.einsum("bis,bs->bi", h, c_t[:, 0])[:, None, :]  # (B,1,di)
    out = ctx.constrain(_gated_out(y, u, z, p), ("batch", None, "embed"))
    return out, {"conv": conv_state, "ssm": h}
