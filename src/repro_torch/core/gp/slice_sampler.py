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
key stream is the JAX package's exactly (``repro_torch.core.prng``):
``split(key, num_samples)`` per chain, ``split(key, 4)`` per update and one
split per shrink step, so the chain visits the same points as the
reference's. Box bounds are enforced by the target returning −inf outside.

No draw depends on the chain's state: a shrink point is
``max(lo, u·(hi − lo) + lo)`` of a unit draw u. So ``chain_draws`` makes
every draw of a chain up front, in one table (batched threefry calls), and
a chain reads its draws from it. ``run_chain`` runs the chain on the host
against a ``log_prob(z) -> float``; the CUDA kernel
``repro_torch.kernels.slice_chain`` runs the same chain on the same table
in one launch (``fit.mcmc_gphps`` routes a refit there on the card).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core import prng

__all__ = [
    "SliceSamplerConfig",
    "ChainDraws",
    "chain_draws",
    "run_chain",
    "keep_rows",
    "slice_sample_chain",
    "PAPER_CONFIG",
    "FAST_CONFIG",
]


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


class ChainDraws(NamedTuple):
    """Every random draw of one chain, float64, one row per update."""

    directions: np.ndarray  # (T, dim) unit directions
    levels: np.ndarray  # (T,) Exp(1) draws: log_y = g(0) − level
    offsets: np.ndarray  # (T,) U[0, 1) draws r: the bracket starts at −w·r
    shrink: np.ndarray  # (T, max_shrink) unit uniforms of the shrink key chain


def chain_draws(key: np.ndarray, dim: int, cfg: SliceSamplerConfig) -> ChainDraws:
    """The draws a chain of ``cfg.num_samples`` updates in ``dim``
    dimensions takes from ``key``, as the reference's chain takes them:
    ``split(key, T)``; per update ``k_dir, k_lvl, k_init, k_shrink =
    split(k, 4)``; ``normal(k_dir, (dim,))`` normalised, ``exponential
    (k_lvl)``, ``uniform(k_init)``; and ``max_shrink`` times ``k_shrink,
    sub = split(k_shrink)``, then the unit draw of ``sub``. Each step is
    one threefry call over all T updates' keys."""
    keys = prng.split(key, cfg.num_samples)
    sub = prng.split_each(keys, 4)
    normals = prng.normal_each(sub[:, 0], dim)
    directions = np.empty_like(normals)
    for i, row in enumerate(normals):
        directions[i] = row / max(float(np.linalg.norm(row)), 1e-12)
    levels = prng.exponential_each(sub[:, 1])
    offsets = prng.unit_uniform_each(sub[:, 2])
    shrink = np.empty((cfg.num_samples, cfg.max_shrink), dtype=np.float64)
    k = sub[:, 3]
    for j in range(cfg.max_shrink):
        pair = prng.split_each(k)
        k = pair[:, 0]
        shrink[:, j] = prng.unit_uniform_each(pair[:, 1])
    return ChainDraws(directions, levels, offsets, shrink)


def _one_direction_update(
    log_prob: Callable[[np.ndarray], float],
    z: np.ndarray,
    draws: ChainDraws,
    i: int,
    cfg: SliceSamplerConfig,
) -> Tuple[np.ndarray, bool]:
    """Update i of z along its direction; returns (z, whether the shrink
    found a point)."""
    direction = draws.directions[i]

    def g(t: float) -> float:
        return log_prob(z + t * direction)

    # log slice level: log_y = g(0) − Exp(1)
    log_y = g(0.0) - float(draws.levels[i])

    # --- stepping out -----------------------------------------------------
    lo = -cfg.step_size * float(draws.offsets[i])
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
    t_new, accepted = 0.0, False
    for u in draws.shrink[i]:
        # prng.uniform(sub, (), lo, hi) of the unit draw u
        t_new = float(np.maximum(lo, u * (hi - lo) + lo))
        accepted = g(t_new) > log_y
        if accepted:
            break
        if t_new < 0.0:
            lo = t_new
        else:
            hi = t_new
    t_fin = t_new if accepted else 0.0  # exhausted -> stay put
    return z + t_fin * direction, accepted


def keep_rows(cfg: SliceSamplerConfig) -> np.ndarray:
    """Indices of the kept updates: burn_in + thin·k, clipped to the chain."""
    keep_idx = cfg.burn_in + cfg.thin * np.arange(cfg.num_kept)
    return np.minimum(keep_idx, cfg.num_samples - 1)


def run_chain(
    log_prob: Callable[[np.ndarray], float],
    z0: np.ndarray,
    draws: ChainDraws,
    cfg: SliceSamplerConfig,
    trace: Optional[List[Tuple[int, float]]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run the chain on the host on a draw table.

    Returns the kept samples, (cfg.num_kept, dim), and the chain's counts
    ``[evaluations, NaN values, exhausted shrinks, evaluations in the box]``
    as float64. With ``trace``, appends (update, g) for every evaluation in
    order."""
    z = np.asarray(z0, dtype=np.float64)
    counts = np.zeros(4)
    update = 0

    def counted(p: np.ndarray) -> float:
        value = log_prob(p)
        counts[0] += 1
        counts[1] += value != value
        counts[3] += value != -np.inf
        if trace is not None:
            trace.append((update, value))
        return value

    buf = np.zeros((cfg.num_samples, z.shape[0]), dtype=np.float64)
    for update in range(cfg.num_samples):
        z, accepted = _one_direction_update(counted, z, draws, update, cfg)
        counts[2] += not accepted
        buf[update] = z
    return buf[keep_rows(cfg)], counts


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
    dim = np.asarray(z0).shape[0]
    return run_chain(log_prob, z0, chain_draws(key, dim, cfg), cfg)[0]
