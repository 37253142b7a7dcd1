"""Slice sampling of GP hyperparameters (paper §4.2).

"In AMT, we implement slice sampling ... In our implementation we use one
chain of 300 samples, with 250 samples as burn-in and thinning every 5
samples, resulting in an effective sample size of 10. We fix upper and lower
bounds on the GPHPs for numerical stability, and use a random (normalised)
direction, as opposed to a coordinate-wise strategy, to go from our
multivariate problem (θ ∈ R^k) to the standard univariate formulation of
slice sampling."

Implementation: Neal (2003) univariate slice sampling with stepping-out and
shrinkage, applied along a fresh random unit direction per iteration. The
chain state lives on the host as float64 numpy; each target evaluation
``log_prob(z) -> float`` may run on the card (a gram, a Cholesky, a solve)
and is read back, because every stepping-out and shrinkage step branches on
``g(t) > log_y``. The key stream is the JAX package's exactly
(``repro_torch.core.prng``): ``split(key, num_samples)`` per chain,
``split(key, 4)`` per update and one split per shrink step, so the chain
visits the same points as the reference's. Box bounds are enforced by the
target returning −inf outside.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from repro_torch.core import prng

__all__ = ["SliceSamplerConfig", "slice_sample_chain", "PAPER_CONFIG", "FAST_CONFIG"]


class SliceSamplerConfig(NamedTuple):
    num_samples: int = 300  # total chain length (paper)
    burn_in: int = 250  # discarded prefix (paper)
    thin: int = 5  # keep every 5th after burn-in (paper) -> 10 effective
    step_size: float = 0.5  # initial bracket width w (packed log-space units)
    max_stepout: int = 8  # stepping-out doublings per side
    max_shrink: int = 32  # shrinkage iterations before giving up (stay put)

    @property
    def num_kept(self) -> int:
        return max(1, (self.num_samples - self.burn_in) // self.thin)


PAPER_CONFIG = SliceSamplerConfig()
# Cheaper config for inner-loop-heavy benchmarks (e.g. 50-seed studies).
FAST_CONFIG = SliceSamplerConfig(num_samples=60, burn_in=30, thin=3)


def _one_direction_update(
    log_prob: Callable[[np.ndarray], float],
    z: np.ndarray,
    key: np.ndarray,
    cfg: SliceSamplerConfig,
) -> np.ndarray:
    """One slice-sampling update of z along a random unit direction."""
    k_dir, k_lvl, k_init, k_shrink = prng.split(key, 4)

    direction = prng.normal(k_dir, z.shape)
    direction = direction / max(float(np.linalg.norm(direction)), 1e-12)

    def g(t: float) -> float:
        return log_prob(z + t * direction)

    # log slice level: log_y = g(0) − Exp(1)
    log_y = g(0.0) - float(prng.exponential(k_lvl))

    # --- stepping out -----------------------------------------------------
    r = float(prng.uniform(k_init))
    lo = -cfg.step_size * r
    hi = lo + cfg.step_size

    def expand(side_sign: float, t: float) -> float:
        i = 0
        while i < cfg.max_stepout and g(t) > log_y:
            t = t + side_sign * cfg.step_size
            i += 1
        return t

    lo = expand(-1.0, lo)
    hi = expand(+1.0, hi)

    # --- shrinkage --------------------------------------------------------
    key = k_shrink
    t_new, accepted = 0.0, False
    for _ in range(cfg.max_shrink):
        key, sub = prng.split(key)
        t_new = float(prng.uniform(sub, (), lo, hi))
        accepted = g(t_new) > log_y
        if accepted:
            break
        if t_new < 0.0:
            lo = t_new
        else:
            hi = t_new
    t_fin = t_new if accepted else 0.0  # exhausted -> stay put
    return z + t_fin * direction


def slice_sample_chain(
    log_prob: Callable[[np.ndarray], float],
    z0: np.ndarray,
    key: np.ndarray,
    cfg: SliceSamplerConfig = PAPER_CONFIG,
) -> np.ndarray:
    """Run the chain; return the kept samples, shape (cfg.num_kept, dim).

    ``log_prob`` maps a float64 (dim,) vector to a float (see
    ``fit.mcmc_gphps``). ``z0`` must lie inside the support.
    """
    z = np.asarray(z0, dtype=np.float64)
    buf = np.zeros((cfg.num_samples, z.shape[0]), dtype=np.float64)
    keys = prng.split(key, cfg.num_samples)
    for i in range(cfg.num_samples):
        z = _one_direction_update(log_prob, z, keys[i], cfg)
        buf[i] = z
    keep_idx = cfg.burn_in + cfg.thin * np.arange(cfg.num_kept)
    keep_idx = np.minimum(keep_idx, cfg.num_samples - 1)
    return buf[keep_idx]
