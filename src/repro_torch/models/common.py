"""Shared model machinery of the port: parameter declaration and seeded
initialisation, norms, soft-capping and RoPE.

Parameters live in ``ParamModule``s (``torch.nn.Module``s that declare each
parameter with its initialisation rule, as the JAX package's
``Builder.param`` does). A model is built on the ``meta`` device — shapes
only, nothing allocated — and materialised on its device by
``Model.init(seed)`` or by ``convert.load_lm_params``. The JAX package's
``spec`` mode and ``ShardCtx`` have no counterpart: the port runs on one
card, and its sharding is ROADMAP A13.

Dtype policy, as in the JAX package: parameters are stored in
``param_dtype`` (float32) and cast to ``compute_dtype`` (bf16) at every use.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch
from torch import nn

__all__ = [
    "INITS",
    "ParamModule",
    "fill_param",
    "rms_norm",
    "softcap",
    "rope_freqs",
    "apply_rope",
]

# the JAX Builder's rules (src/repro/models/common.py ``Builder.param``)
INITS = ("normal", "zeros", "ones", "uniform", "constant")
_SQRT2 = math.sqrt(2.0)
# uniform bounds of a standard normal truncated to [-2, 2]: erf(±2/√2)
_TN_LO = math.erf(-2.0 / _SQRT2)
_TN_HI = math.erf(2.0 / _SQRT2)


class ParamModule(nn.Module):
    """A module whose parameters are declared with the JAX ``Builder``'s
    initialisation rules (``normal`` — a standard normal truncated to
    [−2, 2], times ``scale`` — ``uniform`` on [−scale, scale], ``zeros``,
    ``ones`` and ``constant``). Parameters are created on the ``meta``
    device without gradients; ``training.train_step.train_state_of`` turns
    them on for training."""

    def __init__(self) -> None:
        super().__init__()
        self.inits: Dict[str, Tuple[str, float]] = {}

    def declare(self, name: str, shape: Tuple[int, ...], init: str = "normal",
                scale: float = 1.0, dtype: torch.dtype = torch.float32) -> None:
        if init not in INITS:
            raise ValueError(f"unknown init {init!r}")
        t = torch.empty(shape, dtype=dtype, device="meta")
        self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.inits[name] = (init, float(scale))


def _path_seed(seed: int, path: str) -> int:
    digest = hashlib.blake2b(f"{seed}/{path}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") & ((1 << 63) - 1)


@torch.no_grad()
def fill_param(p: torch.Tensor, init: str, scale: float, seed: int, path: str) -> None:
    """Fill ``p`` in place by its rule, from a ``torch.Generator`` on ``p``'s
    device seeded by (``seed``, the parameter's path): the same seed gives
    the same weights on the same device, whatever the order of filling.
    The truncated normal is the inverse-CDF construction ``jax.random``
    uses (uniform on [erf(−2/√2), erf(2/√2)] → √2·erf⁻¹), computed in
    float32 and cast to the parameter's dtype; the bits differ from JAX's.
    A rule the JAX package does not know raises."""
    if init == "zeros":
        p.zero_()
        return
    if init == "ones":
        p.fill_(1.0)
        return
    if init == "constant":
        p.fill_(scale)
        return
    if init not in ("normal", "uniform"):
        raise ValueError(f"unknown init {init!r}")
    gen = torch.Generator(device=p.device)
    gen.manual_seed(_path_seed(seed, path))
    out = p if p.dtype == torch.float32 else torch.empty_like(p, dtype=torch.float32)
    if init == "uniform":
        out.uniform_(-1.0, 1.0, generator=gen).mul_(scale)
    else:
        out.uniform_(_TN_LO, _TN_HI, generator=gen)
        out.erfinv_().mul_(_SQRT2).clamp_(-2.0, 2.0).mul_(scale)
    if out is not p:
        p.copy_(out)


# ---------------------------------------------------------------------------
# Normalization / elementwise
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, output in x.dtype. Gemma-style (1+γ)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-style soft capping: cap·tanh(x/cap)."""
    return (cap * torch.tanh(x / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies for the rotary dims (first ``fraction`` of the
    head); shape (rot_dim/2,), float32."""
    rot = int(head_dim * fraction) // 2 * 2
    return 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotary embedding over the leading ``rot_dim`` of the head (half-split
    rotation); supports partial rotary (e.g. Minitron's 50%).
    x (..., seq, heads, head_dim), positions (..., seq)."""
    rot = 2 * inv_freq.shape[0]
    angles = positions[..., None].float() * inv_freq  # (..., seq, rot/2)
    cos = torch.cos(angles)[..., None, :]  # (..., seq, 1, rot/2)
    sin = torch.sin(angles)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    xf1, xf2 = x_rot[..., : rot // 2].float(), x_rot[..., rot // 2:].float()
    out1 = xf1 * cos - xf2 * sin
    out2 = xf2 * cos + xf1 * sin
    rotated = torch.cat([out1, out2], dim=-1).to(x.dtype)
    return torch.cat([rotated, x_pass], dim=-1) if x_pass.shape[-1] else rotated
