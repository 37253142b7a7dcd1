"""RG-LRU recurrent block (Griffin / RecurrentGemma) of the port —
recurrentgemma-9b.

    x → (linear branch: W_x → conv1d → RG-LRU) ⊙ GeLU(W_y branch) → W_out

RG-LRU recurrence (per channel):
    r_t = σ(W_a ξ_t + b_a)                 recurrence gate
    i_t = σ(W_i ξ_t + b_i)                 input gate
    a_t = exp(−c·softplus(Λ)·r_t)          decay in (0,1)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ ξ_t)

The scan runs in the hand-written CUDA kernel (``impl="kernel"``,
``repro_torch.kernels.rglru_scan``) or as a loop over time (``impl="torch"``,
the kernel's plain version). Either way the prefill's final recurrent state
is the scan's own last row: the JAX package recomputes it with a second
scan over the same ``a`` and ``gated`` (``model.py::_rglru_prefill``), which
a loop over S steps per layer would make dearer than the prefill itself.
Decode is a single gated state update.

On a mesh the scan (kernel or plain) runs on each rank's shards, sharded
over batch and channels and whole over time.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan.kernel import rglru_scan_kernel
from repro_torch.kernels.rglru_scan.plain import rglru_scan_plain
from repro_torch.models.common import NO_MESH, ParamModule, ShardCtx
from repro_torch.models.mamba import _causal_conv

__all__ = ["rglru_params", "rglru_fwd", "rglru_decode", "init_rglru_cache"]


def rglru_params(cfg) -> ParamModule:
    d = cfg.d_model
    r = cfg.rglru
    di, dc = r.d_inner, r.conv_width
    p = ParamModule()
    p.declare("w_x", (d, di), scale=d**-0.5, logical_axes=("fsdp", "inner"))
    p.declare("w_y", (d, di), scale=d**-0.5, logical_axes=("fsdp", "inner"))
    p.declare("conv_w", (dc, di), scale=dc**-0.5, logical_axes=("conv", "inner"))
    p.declare("conv_b", (di,), init="zeros", logical_axes=("inner",))
    p.declare("w_a", (di, di), scale=di**-0.5, logical_axes=("inner", "fsdp"))
    p.declare("b_a", (di,), init="zeros", logical_axes=("inner",))
    p.declare("w_i", (di, di), scale=di**-0.5, logical_axes=("fsdp", "inner"))
    p.declare("b_i", (di,), init="zeros", logical_axes=("inner",))
    # Λ init so a ≈ 0.9..0.999 at r=0.5 (Griffin's stable range)
    p.declare("lam", (di,), init="constant", scale=0.65, logical_axes=("inner",))
    p.declare("w_out", (di, d), scale=di**-0.5, logical_axes=("inner", "embed"))
    return p


def _gates(xi: torch.Tensor, p: ParamModule, cfg):
    """xi: (B,S,di) → decay a_t and gated input, both fp32."""
    xif = xi.float()
    r_gate = torch.sigmoid(xif @ p.w_a.float() + p.b_a.float())
    i_gate = torch.sigmoid(xif @ p.w_i.float() + p.b_i.float())
    log_a = -cfg.rglru.c * F.softplus(p.lam.float()) * r_gate
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i_gate * xif)
    return a, gated


def rglru_fwd(
    x: torch.Tensor, p: ParamModule, cfg, impl: str = "kernel", ctx: ShardCtx = NO_MESH
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill forward. Returns (out (B,S,D), decode cache {"conv": the last
    dc−1 pre-conv inputs, "h": the state after the last step (f32)})."""
    cdt = x.dtype
    xi_in = ctx.constrain(x @ p.w_x.to(cdt), ("batch", "seq", "inner"))
    xi, _ = _causal_conv(xi_in, p.conv_w, p.conv_b)
    y_branch = F.gelu(x @ p.w_y.to(cdt), approximate="tanh")  # jax.nn.gelu's default

    a, gated = _gates(xi, p, cfg)
    if impl == "kernel":
        scan = rglru_scan_kernel
    elif impl == "torch":
        scan = rglru_scan_plain
    else:
        raise ValueError(f"unknown rglru impl {impl!r} (kernel or torch)")
    chan = ("batch", None, "inner")
    h, h_last = ctx.local_call(scan, [(a, chan), (gated, chan)],
                               [(chan, a.shape), (("batch", "inner"), (a.shape[0], a.shape[2]))])

    out = ctx.constrain((h.to(cdt) * y_branch) @ p.w_out.to(cdt), ("batch", "seq", "embed"))
    dc = cfg.rglru.conv_width
    # a copy: a view would keep the whole (B, S, di) projection alive
    return out, {"conv": xi_in[:, -(dc - 1):, :].clone(), "h": h_last}


# ---------------------------------------------------------------------------
# Decode (O(1) state)
# ---------------------------------------------------------------------------
def init_rglru_cache(cfg, batch: int, dtype, device) -> Dict[str, torch.Tensor]:
    r = cfg.rglru
    return {
        "conv": torch.zeros((batch, r.conv_width - 1, r.d_inner), dtype=dtype, device=device),
        "h": torch.zeros((batch, r.d_inner), dtype=torch.float32, device=device),
    }


def rglru_decode(
    x: torch.Tensor, p: ParamModule, cfg, cache: Dict[str, torch.Tensor],
    ctx: ShardCtx = NO_MESH,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    cdt = x.dtype
    xi = x @ p.w_x.to(cdt)
    xi, conv_state = _causal_conv(xi, p.conv_w, p.conv_b, cache["conv"])
    y_branch = F.gelu(x @ p.w_y.to(cdt), approximate="tanh")

    a, gated = _gates(xi, p, cfg)
    h = a[:, 0] * cache["h"] + gated[:, 0]  # (B, di)

    out = ctx.constrain((h[:, None, :].to(cdt) * y_branch) @ p.w_out.to(cdt),
                        ("batch", None, "embed"))
    return out, {"conv": conv_state, "h": h}
