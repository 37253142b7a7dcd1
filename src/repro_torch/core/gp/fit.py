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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import telemetry
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


def map_gphps(*args, **kwargs):
    """MAP-II (empirical Bayes) GPHP estimate — not ported yet."""
    raise NotImplementedError(
        "gphp_method='map' needs gp/empirical_bayes.py, which is not ported "
        "yet (ROADMAP queue A item 3)"
    )
