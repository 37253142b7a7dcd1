from repro_torch.core.gp.params import GPHyperParams, GPHyperBounds, default_bounds
from repro_torch.core.gp.gp import GPPosterior, fit_gp, log_marginal_likelihood, predict
from repro_torch.core.gp.incremental import (
    cholesky_append_row,
    grow_posterior,
    posterior_append,
    refresh_alpha,
)
from repro_torch.core.gp.kernels import matern52_ard
from repro_torch.core.gp.warping import kumaraswamy_cdf, warp_inputs

__all__ = [
    "GPHyperParams",
    "GPHyperBounds",
    "default_bounds",
    "GPPosterior",
    "fit_gp",
    "log_marginal_likelihood",
    "predict",
    "cholesky_append_row",
    "grow_posterior",
    "posterior_append",
    "refresh_alpha",
    "matern52_ard",
    "kumaraswamy_cdf",
    "warp_inputs",
]
