"""Plain version of the slice-chain kernel: the chain on the host.

The same function as ``csrc/slice_chain.cu`` on the same inputs — the
bucket-padded (x, y, mask) and one float64 table of the box, the start and
the chain's draws (``pack_table``). It runs ``slice_sampler.run_chain`` on
the host; each evaluation tests the box and adds the Gaussian prior on the
host, builds the masked gram, factorizes it and solves on the data's device
(``gp.log_marginal_likelihood``) and reads back one float. The gram type
names the gram: float32 is the kernel backend's masked gram — the plain
version on a CPU tensor, one ``matern52_operand`` launch on a CUDA tensor,
whose gram entries the chain kernel's in-block gram repeats bit for bit —
and float64 is ``matern52_ard``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.gp.gp import log_marginal_likelihood
from repro_torch.core.gp.params import GPHyperBounds, GPHyperParams
from repro_torch.core.gp.slice_sampler import ChainDraws, SliceSamplerConfig, run_chain

__all__ = [
    "GRAM_BACKEND", "pack_table", "unpack_table", "table_size", "max_evaluations",
    "host_log_density", "slice_chain_plain",
]

# gram type -> the gram backend of gp.log_marginal_likelihood
GRAM_BACKEND = {torch.float32: "kernel", torch.float64: "torch"}


def table_size(dim: int, cfg: SliceSamplerConfig) -> int:
    """Length of the table: box (4·dim), z0 (dim), directions (T·dim),
    levels (T), offsets (T), shrink draws (T·max_shrink)."""
    T = cfg.num_samples
    return 5 * dim + T * dim + 2 * T + T * cfg.max_shrink


def max_evaluations(cfg: SliceSamplerConfig) -> int:
    """Most log-density evaluations a chain can make: per update g(0), up to
    max_stepout per side and max_shrink shrink points."""
    return cfg.num_samples * (1 + 2 * cfg.max_stepout + cfg.max_shrink)


def pack_table(
    bounds: GPHyperBounds, z0: np.ndarray, draws: ChainDraws
) -> np.ndarray:
    """The kernel's one float64 input table (layout in ``table_size``)."""
    prior_std = np.maximum(bounds.width / 4.0, 1e-6)
    return np.concatenate([
        bounds.lower, bounds.upper, bounds.center, prior_std,
        np.asarray(z0, dtype=np.float64), draws.directions.ravel(),
        draws.levels, draws.offsets, draws.shrink.ravel(),
    ]).astype(np.float64)


def unpack_table(table: np.ndarray, dim: int, cfg: SliceSamplerConfig):
    """(lower, upper, center, prior_std, z0, draws) of a packed table."""
    T = cfg.num_samples
    box = table[: 5 * dim].reshape(5, dim)
    rest = table[5 * dim:]
    directions = rest[: T * dim].reshape(T, dim)
    levels = rest[T * dim: T * dim + T]
    offsets = rest[T * dim + T: T * dim + 2 * T]
    shrink = rest[T * dim + 2 * T:].reshape(T, cfg.max_shrink)
    return (*box, ChainDraws(directions, levels, offsets, shrink))


def host_log_density(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    box: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    gram: torch.dtype,
) -> Callable[[np.ndarray], float]:
    """The chain's target on the host: packed (3d+2,) float64 → float. −inf
    outside the box (lower, upper) with no device work; else the Gaussian
    prior (center, prior_std) plus the log marginal likelihood of the live
    rows, with the gram of type ``gram``, on x's device."""
    d = x.shape[-1]
    lower, upper, center, prior_std = box
    backend = GRAM_BACKEND[gram]

    def log_prob(packed: np.ndarray) -> float:
        if not np.all((packed >= lower) & (packed <= upper)):
            return -float("inf")
        log_prior = -0.5 * float(np.sum(((packed - center) / prior_std) ** 2))
        vec = torch.as_tensor(packed, dtype=x.dtype).to(x.device)
        params = GPHyperParams.unpack(vec, d)
        mll = log_marginal_likelihood(x, y, params, mask, backend=backend)
        return float(mll) + log_prior

    return log_prob


def slice_chain_plain(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    table: torch.Tensor,
    cfg: SliceSamplerConfig,
    gram: torch.dtype,
    trace: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(kept samples (num_kept, 3d+2), counts [evaluations, NaN log
    densities, exhausted shrinks, evaluations in the box], and with
    ``trace`` the (evaluations, 2) rows (update, g)), float64 on x's
    device."""
    dim = GPHyperParams.packed_size(x.shape[-1])
    lower, upper, center, prior_std, z0, draws = unpack_table(
        table.detach().cpu().numpy(), dim, cfg
    )
    log_prob = host_log_density(x, y, mask, (lower, upper, center, prior_std), gram)
    rows: Optional[List[Tuple[int, float]]] = [] if trace else None
    kept, counts = run_chain(log_prob, z0, draws, cfg, trace=rows)
    f64 = dict(dtype=torch.float64, device=x.device)
    return (
        torch.as_tensor(kept, **f64),
        torch.as_tensor(counts, **f64),
        torch.as_tensor(np.asarray(rows, dtype=np.float64).reshape(-1, 2), **f64)
        if trace else None,
    )
