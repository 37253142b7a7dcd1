"""AdamW + LR schedules of the port (no ``torch.optim``): the JAX package's
``repro.training.optimizer`` on the port's parameter dicts.

The optimizer is the substrate AMT *tunes over* — its hyperparameters
(learning rate, warmup fraction, weight decay, β₂, clip norm) form the default
search space of the tuning launcher.

Parameters, gradients and moments are dicts ``{name: tensor}`` with the
names of ``Model.named_parameters()``. The arithmetic is the JAX package's,
in float32 (the step counter turned to float32 before β**t, the cosine
schedule in float32); ``moment_dtype="bfloat16"`` keeps first moments in
bf16. Unlike the JAX package's pure function, ``adamw_update`` writes the
new parameters and moments into the tensors it is given — the PyTorch idiom,
which keeps one copy of a 1e9-parameter state on the card instead of two.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_schedule", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"  # "cosine" | "linear" | "constant"
    moment_dtype: str = "float32"  # "bfloat16" halves m memory
    grad_accum_dtype: str = "float32"  # "bfloat16" halves the accumulator


def lr_schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Warmup + cosine/linear decay to min_lr_ratio, float32."""
    step_f = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step_f + 1.0) / max(1.0, cfg.warmup_steps), max=1.0)
    frac = torch.clamp(
        (step_f - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps),
        0.0,
        1.0,
    )
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1.0 + torch.cos(math.pi * frac)
        )
    elif cfg.schedule == "linear":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * (1.0 - frac)
    else:
        decay = 1.0
    return cfg.learning_rate * warm * decay


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """√(Σ over tensors of Σ x²), float32. The JAX package sums its leaves
    in sorted-key order over stacked periods; the port's order is the
    parameters' own, so the two differ in the last float32 bits."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig) -> Dict[str, Any]:
    """{"m": zeros in ``moment_dtype``, "v": float32 zeros, "step": int32 0},
    on the parameters' device."""
    mdt = getattr(torch, cfg.moment_dtype)
    some = next(iter(params.values()))
    return {
        "m": {k: torch.zeros_like(p, dtype=mdt) for k, p in params.items()},
        "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=some.device),
    }


@torch.no_grad()
def adamw_update(
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    opt_state: Dict[str, Any],
    cfg: AdamWConfig,
) -> Tuple[Mapping[str, torch.Tensor], Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping and decoupled weight decay,
    written into ``params`` and ``opt_state`` in place. Returns (params,
    opt_state, metrics {"lr", "grad_norm"}) — the same objects."""
    step = opt_state["step"]
    lr = lr_schedule(step, cfg)

    gnorm = global_norm(grads)
    # a tensor numerator: Python's c / t would compute (1/t)·c
    scale = torch.clamp(gnorm.new_full((), cfg.clip_norm) / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - cfg.beta1**t
    bc2 = 1.0 - cfg.beta2**t

    for name, p in params.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        gf = grads[name].float() * scale
        m_new = cfg.beta1 * m.float() + (1 - cfg.beta1) * gf
        v_new = cfg.beta2 * v + (1 - cfg.beta2) * gf * gf
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        pf = p.float()
        p.copy_(pf - lr * (update + cfg.weight_decay * pf))
        m.copy_(m_new)
        v.copy_(v_new)
    step.add_(1)
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
