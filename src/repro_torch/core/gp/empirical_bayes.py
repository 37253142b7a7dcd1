"""Empirical-Bayes GPHP estimation (paper §4.2): maximize the log marginal
likelihood (plus the weak prior, i.e. MAP-II) under the stability box bounds.

The paper implements *both* empirical Bayes and slice sampling and observes
slice sampling overfits less early on; we expose both. Empirical Bayes here is
multi-restart Adam in a sigmoid-reparameterized unconstrained space:

    packed(z) = lower + (upper − lower) · sigmoid(z)

which keeps iterates strictly inside the box. All restarts run at once: the
objective takes the (R, D) stack of restarts and returns (R,), and one
``torch.autograd.grad`` of its sum gives every restart's gradient. The best
final point wins.

The restart inits come from the reference's threefry stream
(``core/prng.py::normal``), and Adam's bias corrections are float32 as the
reference's step counter is (``jnp.arange(num_steps, dtype=float32)``), so
the iterates follow the JAX package's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.gp.params import GPHyperBounds

__all__ = ["EmpiricalBayesConfig", "maximize_mll"]


class EmpiricalBayesConfig(NamedTuple):
    num_restarts: int = 4
    num_steps: int = 150
    learning_rate: float = 0.08
    init_spread: float = 1.0  # stddev of restart inits in z-space


def _to_box(z: torch.Tensor, lower: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    return lower + width * torch.sigmoid(z)


def _from_box(p: np.ndarray, bounds: GPHyperBounds) -> np.ndarray:
    u = np.clip((p - bounds.lower) / bounds.width, 1e-4, 1.0 - 1e-4)
    return np.log(u) - np.log1p(-u)


def _bias_corrections(num_steps: int, beta: float) -> np.ndarray:
    """1 − β^(i+1) for i < num_steps, in float32 as the reference computes
    it (β and the step counter are float32 there; the power rounds once
    from float64, which is what XLA's float32 power gives)."""
    steps = np.arange(num_steps, dtype=np.float32) + np.float32(1.0)
    powers = (np.float64(np.float32(beta)) ** steps.astype(np.float64)).astype(np.float32)
    return (np.float32(1.0) - powers).astype(np.float64)


def maximize_mll(
    objective: Callable[[torch.Tensor], torch.Tensor],
    init_packed: np.ndarray,
    bounds: GPHyperBounds,
    key: np.ndarray,
    cfg: EmpiricalBayesConfig = EmpiricalBayesConfig(),
    device=None,
) -> torch.Tensor:
    """Return the packed GPHP vector (D,) maximizing ``objective`` (e.g. the
    log posterior density), a map from an (R, D) stack of packed vectors to
    (R,) that autograd can differentiate and that is finite inside the box.
    Non-finite gradient entries are zeroed; the best restart is the first
    argmin of the final loss."""
    f64 = dict(dtype=torch.float64, device=device)
    lower = torch.as_tensor(bounds.lower, **f64)
    width = torch.as_tensor(bounds.width, **f64)
    z_center = _from_box(np.asarray(init_packed, dtype=np.float64), bounds)
    inits = z_center[None, :] + cfg.init_spread * prng.normal(
        key, (cfg.num_restarts, z_center.shape[0])
    )
    inits[0] = z_center  # first restart = warm init

    def loss(z: torch.Tensor) -> torch.Tensor:
        return -objective(_to_box(z, lower, width))

    c1 = _bias_corrections(cfg.num_steps, 0.9)
    c2 = _bias_corrections(cfg.num_steps, 0.999)
    z = torch.as_tensor(inits, **f64)
    m = torch.zeros_like(z)
    v = torch.zeros_like(z)
    for i in range(cfg.num_steps):
        zg = z.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(zg).sum(), zg)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * (g * g)
        mhat = m / float(c1[i])
        vhat = v / float(c2[i])
        z = z - cfg.learning_rate * mhat / (torch.sqrt(vhat) + 1e-8)
    with torch.no_grad():
        losses = loss(z)
    best = int(torch.argmin(losses))
    return _to_box(z[best], lower, width)
