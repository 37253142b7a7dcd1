"""GP hyperparameter (GPHP) containers, bounds and packing (paper §4.2).

The GPHPs θ are (for a d-dimensional encoded input space):

  * ``log_lengthscale`` — (d,) ARD lengthscales of the Matérn-5/2 kernel,
  * ``log_amplitude``   — () signal std (observations are normalized, so ≈1),
  * ``log_noise``       — () observation noise std σ₀,
  * ``log_warp_a/b``    — (d,) Kumaraswamy warping shapes (identity=0 on
    non-warpable dims, e.g. one-hot categoricals).

Following the paper, we "fix upper and lower bounds on the GPHPs for numerical
stability": the slice sampler operates on the packed log-space vector under
box bounds, with a weak Gaussian prior centered on the middle of each box.

Fields are float64 tensors; a leading (S,) axis carries MCMC draws. Bounds
are float64 numpy: the slice-sampling chain runs on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["GPHyperParams", "GPHyperBounds", "default_bounds", "default_params"]


class GPHyperParams(NamedTuple):
    """GP hyperparameters in log space. Fields may carry a leading sample
    axis (S,) when representing MCMC draws."""

    log_lengthscale: torch.Tensor  # (..., d)
    log_amplitude: torch.Tensor  # (...,)
    log_noise: torch.Tensor  # (...,)
    log_warp_a: torch.Tensor  # (..., d)
    log_warp_b: torch.Tensor  # (..., d)

    @property
    def dim(self) -> int:
        return self.log_lengthscale.shape[-1]

    def pack(self) -> torch.Tensor:
        """Flatten to (..., 3d + 2)."""
        return torch.cat(
            [
                self.log_lengthscale,
                self.log_amplitude[..., None],
                self.log_noise[..., None],
                self.log_warp_a,
                self.log_warp_b,
            ],
            dim=-1,
        )

    @staticmethod
    def unpack(vec: torch.Tensor, d: int) -> "GPHyperParams":
        return GPHyperParams(
            log_lengthscale=vec[..., :d],
            log_amplitude=vec[..., d],
            log_noise=vec[..., d + 1],
            log_warp_a=vec[..., d + 2 : 2 * d + 2],
            log_warp_b=vec[..., 2 * d + 2 : 3 * d + 2],
        )

    @staticmethod
    def packed_size(d: int) -> int:
        return 3 * d + 2


class GPHyperBounds(NamedTuple):
    """Box bounds for the packed log-space GPHP vector (float64 numpy)."""

    lower: np.ndarray  # (3d + 2,)
    upper: np.ndarray  # (3d + 2,)

    @property
    def center(self) -> np.ndarray:
        return 0.5 * (self.lower + self.upper)

    @property
    def width(self) -> np.ndarray:
        return self.upper - self.lower


def default_bounds(d: int, warp_mask: np.ndarray | None = None) -> GPHyperBounds:
    """Default numerical-stability bounds (inputs live in the unit cube,
    observations are standardized).

    warp_mask: boolean (d,) — dims where Kumaraswamy warping is active.
    Non-warpable dims get pinned to identity (a = b = 1 ⇒ log = 0).
    """
    if warp_mask is None:
        warp_mask = np.ones(d, dtype=bool)
    warp_mask = np.asarray(warp_mask, dtype=bool)

    lo_ls, hi_ls = np.log(0.01), np.log(30.0)
    lo_amp, hi_amp = np.log(0.05), np.log(20.0)
    lo_noise, hi_noise = np.log(1e-4), np.log(1.0)
    lo_w, hi_w = np.log(0.25), np.log(4.0)

    lower = np.concatenate(
        [
            np.full(d, lo_ls),
            [lo_amp, lo_noise],
            np.where(warp_mask, lo_w, -1e-6),
            np.where(warp_mask, lo_w, -1e-6),
        ]
    )
    upper = np.concatenate(
        [
            np.full(d, hi_ls),
            [hi_amp, hi_noise],
            np.where(warp_mask, hi_w, 1e-6),
            np.where(warp_mask, hi_w, 1e-6),
        ]
    )
    return GPHyperBounds(
        lower=lower.astype(np.float64), upper=upper.astype(np.float64)
    )


def default_params(d: int, device=None) -> GPHyperParams:
    """A sane starting point: unit lengthscales/amplitude, small noise,
    identity warping."""
    f64 = dict(dtype=torch.float64, device=device)
    return GPHyperParams(
        log_lengthscale=torch.zeros(d, **f64),
        log_amplitude=torch.tensor(0.0, **f64),
        log_noise=torch.tensor(np.log(1e-2), **f64),
        log_warp_a=torch.zeros(d, **f64),
        log_warp_b=torch.zeros(d, **f64),
    )
