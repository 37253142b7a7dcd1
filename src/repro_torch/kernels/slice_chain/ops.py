"""Dispatcher of the slice-chain kernel: the draw table and the read-back.

``slice_chain`` packs the box, the start and the chain's draws into one
float64 table, uploads it once, runs the chain (one launch on the card) and
reads back the kept samples, the counts and how the chain was run in one
copy; the upload (``gphp.upload``, waited for with telemetry on) and the
launch through the read-back (``gphp.chain``) are spans. The gram type
follows the fit backend's name: ``"kernel"`` builds the gram in float32 as
the Matérn kernels do, ``"torch"`` in float64 as ``matern52_ard`` does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import telemetry
from repro_torch.core.gp.params import GPHyperBounds
from repro_torch.core.gp.slice_sampler import ChainDraws, SliceSamplerConfig
from repro_torch.kernels.slice_chain.kernel import slice_chain_kernel
from repro_torch.kernels.slice_chain.plain import GRAM_BACKEND, pack_table

__all__ = ["slice_chain", "GRAM_TYPE"]

# fit backend -> the gram's type
GRAM_TYPE = {backend: dtype for dtype, backend in GRAM_BACKEND.items()}


def slice_chain(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    bounds: GPHyperBounds,
    z0: np.ndarray,
    draws: ChainDraws,
    cfg: SliceSamplerConfig,
    backend: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(kept samples (num_kept, 3d+2), counts [evaluations, NaN log
    densities, exhausted shrinks, evaluations in the box], schedule
    [evaluations made, rounds, cluster width]) as float64 numpy."""
    if backend not in GRAM_TYPE:
        raise ValueError(f"unknown fit backend {backend!r}")
    with telemetry.device_span("gphp.upload", x.device):
        table = torch.as_tensor(pack_table(bounds, z0, draws)).to(x.device)
    with telemetry.span("gphp.chain"):
        kept, counts, _, schedule = slice_chain_kernel(
            x.contiguous(), y.contiguous(), mask.contiguous(), table, cfg,
            GRAM_TYPE[backend], schedule=True,
        )
        K, dim = kept.shape
        host = torch.cat([kept.reshape(-1), counts, schedule]).cpu().numpy()
    return host[: K * dim].reshape(K, dim), host[K * dim: -3], host[-3:]
