"""GPHP fitting entry points.

``mcmc_gphps`` slice-samples the packed GPHP posterior. The host makes
every draw of the chain up front (``slice_sampler.chain_draws``); the chain
itself runs in ``repro_torch.kernels.slice_chain``: on a CUDA tensor one
kernel launch runs it whole — every evaluation's gram, factor and solve,
and every branch, a round of points side by side on a cluster of blocks —
with the gram in float32 for ``backend="kernel"`` and
float64 for ``"torch"``, and one read-back returns the kept samples. On a
CPU tensor its plain version runs the chain on the host. There is no
fallback: a failed build or launch raises.

``map_gphps`` is the MAP-II estimate (``empirical_bayes.maximize_mll``):
autograd through the torch composition of the log posterior density. It
runs on the float64 torch gram only. The reference cannot differentiate its
Pallas gram either (no reverse-mode rule), so ``backend="kernel"`` is
refused rather than quietly replaced by the torch gram.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import telemetry
from repro_torch.core.gp.empirical_bayes import EmpiricalBayesConfig, maximize_mll
from repro_torch.core.gp.gp import log_posterior_density
from repro_torch.core.gp.params import GPHyperBounds
from repro_torch.core.gp.slice_sampler import SliceSamplerConfig, chain_draws

__all__ = ["mcmc_gphps", "map_gphps"]


def mcmc_gphps(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    bounds: GPHyperBounds,
    z0: np.ndarray,
    key: np.ndarray,
    cfg: SliceSamplerConfig,
    backend: str = "torch",
) -> np.ndarray:
    """Slice-sample the packed GPHP posterior. Returns (num_kept, 3d+2)
    float64 numpy."""
    from repro_torch.kernels.slice_chain.ops import slice_chain

    z0 = np.asarray(z0, dtype=np.float64)
    with telemetry.span("gphp.draws"):
        draws = chain_draws(key, z0.shape[0], cfg)
    samples, counts, schedule = slice_chain(x, y, mask, bounds, z0, draws, cfg, backend)
    d = x.shape[-1]
    telemetry.event(
        "gphp.slice_chain", rows=int(x.shape[0]), evaluations=int(counts[0]),
        nan_factors=int(counts[1]), exhausted=int(counts[2]),
        in_box=int(counts[3]), made=int(schedule[0]), rounds=int(schedule[1]),
        width=int(schedule[2]), start_log_amplitude=float(z0[d]),
        start_log_noise=float(z0[d + 1]),
    )
    return samples


def check_map_backend(backend: str) -> None:
    """Refuse MAP-II on the kernel gram: its kernels have no backward."""
    if backend != "torch":
        raise ValueError(
            "gphp_method='map' needs gradients of the GP log posterior, and "
            f"fit_backend={backend!r} has none: the hand-written Matern "
            "kernels have no backward pass (the reference's Pallas gram has "
            "no reverse-mode rule either). Use fit_backend='torch'."
        )


def map_gphps(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    bounds: GPHyperBounds,
    z0: np.ndarray,
    key: np.ndarray,
    cfg: EmpiricalBayesConfig = EmpiricalBayesConfig(),
    backend: str = "torch",
) -> np.ndarray:
    """MAP-II (empirical Bayes) packed GPHP estimate. Returns (3d+2,)
    float64 numpy."""
    check_map_backend(backend)

    def log_prob(packed: torch.Tensor) -> torch.Tensor:
        return log_posterior_density(x, y, packed, bounds, mask, backend=backend)

    best = maximize_mll(log_prob, z0, bounds, key, cfg, device=x.device)
    return best.detach().cpu().numpy()
