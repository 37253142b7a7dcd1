"""GPHP fitting entry points.

``mcmc_gphps`` slice-samples the packed GPHP posterior. The chain runs on the
host (``slice_sampler.py``); each target evaluation builds the masked gram,
factorizes it and solves on the data's device, and reads back one float.
The box test and the Gaussian prior are host arithmetic on the packed
vector, so a point outside the box costs no device work at all (the
reference computes the likelihood there and discards it; the value is −inf
either way).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gp.gp import log_marginal_likelihood
from repro_torch.core.gp.params import GPHyperBounds, GPHyperParams
from repro_torch.core.gp.slice_sampler import SliceSamplerConfig, slice_sample_chain

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
    d = x.shape[-1]
    prior_std = np.maximum(bounds.width / 4.0, 1e-6)
    center = bounds.center

    def log_prob(packed: np.ndarray) -> float:
        if not np.all((packed >= bounds.lower) & (packed <= bounds.upper)):
            return -float("inf")
        log_prior = -0.5 * float(np.sum(((packed - center) / prior_std) ** 2))
        vec = torch.as_tensor(packed, dtype=x.dtype).to(x.device)
        params = GPHyperParams.unpack(vec, d)
        mll = log_marginal_likelihood(x, y, params, mask, backend=backend)
        return float(mll) + log_prior

    return slice_sample_chain(log_prob, z0, key, cfg)


def map_gphps(*args, **kwargs):
    """MAP-II (empirical Bayes) GPHP estimate — not ported yet."""
    raise NotImplementedError(
        "gphp_method='map' needs gp/empirical_bayes.py, which is not ported "
        "yet (ROADMAP queue A item 3)"
    )
