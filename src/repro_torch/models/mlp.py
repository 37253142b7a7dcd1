"""Feed-forward block of the port: the dense MLP (SwiGLU / GELU /
squared-ReLU). The JAX package's MoE block (``moe_params``/``moe_fwd``) is
not ported yet: a MoE config raises (ROADMAP A12)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamModule

__all__ = ["mlp_params", "mlp_fwd"]


def mlp_params(cfg) -> ParamModule:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the MoE block is not ported yet (ROADMAP A12)"
        )
    d, f = cfg.d_model, cfg.d_ff
    p = ParamModule()
    p.declare("w1", (d, f), scale=d**-0.5)
    p.declare("w2", (f, d), scale=f**-0.5)
    if cfg.mlp == "swiglu":
        p.declare("w3", (d, f), scale=d**-0.5)
    return p


def mlp_fwd(x: torch.Tensor, p: ParamModule, cfg) -> torch.Tensor:
    cdt = x.dtype
    h = x @ p.w1.to(cdt)
    if cfg.mlp == "swiglu":
        h = F.silu(h) * (x @ p.w3.to(cdt))
    elif cfg.mlp == "gelu":
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(f"unknown mlp kind {cfg.mlp!r}")
    return h @ p.w2.to(cdt)
