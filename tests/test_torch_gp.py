"""The port's GP layer against the JAX package's, on the same numpy inputs.

Tolerances: elementwise maps (warp, gram, EI/LCB) agree to 1e-12; values
that go through a factorization (Cholesky, solves, L⁻¹, LML, predictions,
rank-1 appends) to 1e-9 relative — LAPACK and XLA order their sums
differently, and the factors amplify that by the gram's condition number.
The slice-sampled GPHPs with the same key agree to 1e-9: the chain takes
the same branches and differs only by the rounding of its targets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acquisition as JA
from repro.core.gp import fit as Jfit
from repro.core.gp import gp as JG
from repro.core.gp import incremental as JI
from repro.core.gp import kernels as JK
from repro.core.gp import params as JP
from repro.core.gp import warping as JW
from repro.core.gp.slice_sampler import SliceSamplerConfig as JSC
from repro_torch import convert
from repro_torch.core import acquisition as TA
from repro_torch.core import prng
from repro_torch.core.gp import fit as Tfit
from repro_torch.core.gp import gp as TG
from repro_torch.core.gp import incremental as TI
from repro_torch.core.gp import kernels as TK
from repro_torch.core.gp import params as TP
from repro_torch.core.gp import warping as TW
from repro_torch.core.gp.slice_sampler import SliceSamplerConfig as TSC

TINY = dict(num_samples=12, burn_in=6, thin=2)


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def packed_draws(d, S, seed):
    rng = np.random.default_rng(seed)
    base = np.asarray(JP.default_params(d).pack())
    draws = base + 0.2 * rng.standard_normal((max(S, 1), 3 * d + 2))
    return draws if S else draws[0]


def data(bucket, n_live, d, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((bucket, d))
    y = np.zeros(bucket)
    x[:n_live] = rng.random((n_live, d))
    y[:n_live] = rng.standard_normal(n_live)
    mask = np.zeros(bucket, dtype=bool)
    mask[:n_live] = True
    return x, y, mask


def both_posteriors(bucket, n_live, d, S, with_inverse=True, seed=0):
    x, y, mask = data(bucket, n_live, d, seed)
    packed = packed_draws(d, S, seed + 1)
    jp = JP.GPHyperParams.unpack(jnp.asarray(packed), d)
    tp = convert.params_from_numpy(packed, d, device="cpu")
    fit_j = JG.fit_posterior_batch if S else JG.fit_gp
    fit_t = TG.fit_posterior_batch if S else TG.fit_gp
    jpost = fit_j(jnp.asarray(x), jnp.asarray(y), jp, jnp.asarray(mask),
                  with_inverse=with_inverse)
    tpost = fit_t(t(x), t(y), tp, t(mask, torch.bool), with_inverse=with_inverse)
    return jpost, tpost, (x, y, mask)


def assert_post_close(tpost, jpost, rtol=1e-9):
    got = convert.posterior_to_numpy(tpost)
    want = convert.posterior_to_numpy(jpost)
    for key in ("x_train", "mask", "params"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("chol", "alpha", "chol_inv"):
        if want[key] is None:
            assert got[key] is None
            continue
        scale = max(1.0, np.abs(want[key]).max())
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("d", [1, 4])
def test_warp_and_gram(d):
    rng = np.random.default_rng(d)
    x1, x2 = rng.random((9, d)), rng.random((5, d))
    packed = packed_draws(d, 0, 7)
    packed[2 * d + 2 :] = np.where(np.arange(d) % 2 == 0, 0.0, packed[2 * d + 2 :])
    packed[d + 2 : 2 * d + 2] = np.where(np.arange(d) % 2 == 0, 0.0, packed[d + 2 : 2 * d + 2])
    jp = JP.GPHyperParams.unpack(jnp.asarray(packed), d)
    tp = convert.params_from_numpy(packed, d, device="cpu")
    np.testing.assert_allclose(
        TW.warp_inputs(t(x1), tp.log_warp_a, tp.log_warp_b).numpy(),
        np.asarray(JW.warp_inputs(jnp.asarray(x1), jp.log_warp_a, jp.log_warp_b)),
        rtol=0, atol=1e-12,
    )
    for warp in (True, False):
        np.testing.assert_allclose(
            TK.matern52_ard(t(x1), t(x2), tp, warp=warp).numpy(),
            np.asarray(JK.matern52_ard(jnp.asarray(x1), jnp.asarray(x2), jp, warp=warp)),
            rtol=0, atol=1e-12,
        )
    # sampled parameters: a leading batch axis stands in for vmap
    draws = packed_draws(d, 3, 8)
    tb = convert.params_from_numpy(draws, d, device="cpu")
    got = TK.matern52_ard(t(x1), t(x2), tb).numpy()
    for s in range(3):
        js = JP.GPHyperParams.unpack(jnp.asarray(draws[s]), d)
        np.testing.assert_allclose(
            got[s], np.asarray(JK.matern52_ard(jnp.asarray(x1), jnp.asarray(x2), js)),
            rtol=0, atol=1e-12,
        )
    # the cross row is one row of the gram (the kernel is symmetric)
    np.testing.assert_allclose(
        TK.gram_cross(t(x2[0]), t(x1), tb).numpy(), got[:, :, 0], rtol=0, atol=1e-12
    )


def test_ei_lcb():
    rng = np.random.default_rng(0)
    mu, var = rng.standard_normal((4, 50)), rng.random((4, 50)) * 2
    var[0, :5] = 0.0
    np.testing.assert_allclose(
        TA.expected_improvement(t(mu), t(var), -0.3).numpy(),
        np.asarray(JA.expected_improvement(jnp.asarray(mu), jnp.asarray(var), -0.3)),
        rtol=0, atol=1e-12,
    )
    np.testing.assert_allclose(
        TA.lcb(t(mu), t(var), 1.7).numpy(),
        np.asarray(JA.lcb(jnp.asarray(mu), jnp.asarray(var), 1.7)),
        rtol=0, atol=1e-12,
    )
    np.testing.assert_array_equal(
        TA.integrate_over_samples(t(mu)).numpy(), mu.mean(axis=0)
    )


@pytest.mark.parametrize("bucket,n_live,S", [(8, 5, 0), (8, 8, 3), (64, 41, 4)])
def test_factorization_lml_predict(bucket, n_live, S):
    d = 3
    jpost, tpost, (x, y, mask) = both_posteriors(bucket, n_live, d, S)
    assert_post_close(tpost, jpost)
    xs = np.random.default_rng(5).random((17, d))
    tmu, tvar = TG.predict(tpost, t(xs))
    jmu, jvar = JG.predict(jpost, jnp.asarray(xs))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), rtol=1e-9, atol=1e-12)
    packed = packed_draws(d, 0, 11)
    got = TG.log_marginal_likelihood(
        t(x), t(y), convert.params_from_numpy(packed, d, device="cpu"), t(mask, torch.bool)
    )
    want = JG.log_marginal_likelihood(
        jnp.asarray(x), jnp.asarray(y), JP.GPHyperParams.unpack(jnp.asarray(packed), d),
        jnp.asarray(mask),
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-9)


def test_log_posterior_density_and_bounds():
    d = 2
    x, y, mask = data(8, 6, d)
    jb = JP.default_bounds(d, np.array([True, False]))
    tb = TP.default_bounds(d, np.array([True, False]))
    np.testing.assert_array_equal(tb.lower, np.asarray(jb.lower))
    np.testing.assert_array_equal(tb.upper, np.asarray(jb.upper))
    inside = np.clip(packed_draws(d, 0, 2), tb.lower + 1e-3, tb.upper - 1e-3)
    outside = inside.copy()
    outside[0] = 10.0
    for z in (inside, outside):
        got = float(TG.log_posterior_density(t(x), t(y), t(z), tb, t(mask, torch.bool)))
        want = float(JG.log_posterior_density(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jb, jnp.asarray(mask)))
        if np.isinf(want):
            assert got == want
        else:
            np.testing.assert_allclose(got, want, rtol=1e-9)


def test_failed_cholesky_is_nan_not_an_exception():
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    assert torch.isnan(TG.cholesky(bad)).all()


@pytest.mark.parametrize("with_inverse", [False, True])
@pytest.mark.parametrize("S", [0, 3])
def test_posterior_append_matches_refit_and_reference(with_inverse, S):
    """Append rows 5 and 6 onto a 5-row factor (growing 8 → 16 on the way
    is not needed here); compare with the JAX append and with a refit."""
    d = 3
    jpost, tpost, (x, y, mask) = both_posteriors(8, 5, d, S, with_inverse)
    rng = np.random.default_rng(9)
    new = rng.random((2, d))
    for row in new:
        jpost = JI.posterior_append(jpost, jnp.asarray(row))
        tpost = TI.posterior_append(tpost, t(row))
    y2 = y.copy()
    y2[5:7] = rng.standard_normal(2)
    jpost = JI.refresh_alpha(jpost, jnp.asarray(y2))
    tpost = TI.refresh_alpha(tpost, t(y2))
    assert_post_close(tpost, jpost)
    # the appended factor is the factor of the grown data
    x2 = x.copy()
    x2[5:7] = new
    m2 = mask.copy()
    m2[5:7] = True
    fit = TG.fit_posterior_batch if S else TG.fit_gp
    ref = fit(t(x2), t(y2), tpost.params, t(m2, torch.bool), with_inverse=with_inverse)
    assert_post_close(tpost, ref)


def test_grow_block_append_and_delete():
    d, S = 2, 2
    jpost, tpost, (x, y, mask) = both_posteriors(8, 6, d, S, True)
    jpost, tpost = JI.grow_posterior(jpost, 16), TI.grow_posterior(tpost, 16)
    assert_post_close(tpost, jpost)
    block = np.random.default_rng(4).random((3, d))
    jpost = JI.posterior_append_block(jpost, jnp.asarray(block))
    tpost = TI.posterior_append_block(tpost, t(block))
    assert_post_close(tpost, jpost)
    jpost, tpost = JI.posterior_delete(jpost, 2), TI.posterior_delete(tpost, 2)
    assert_post_close(tpost, jpost)


@pytest.mark.parametrize("seed", [0, 3])
def test_mcmc_gphps_same_key_same_samples(seed):
    d = 2
    x, y, mask = data(8, 7, d, seed)
    jb = JP.default_bounds(d)
    tb = TP.default_bounds(d)
    z0 = np.clip(np.asarray(JP.default_params(d).pack()), tb.lower + 1e-4, tb.upper - 1e-4)
    key = jnp.asarray(np.asarray(prng.split(prng.PRNGKey(seed))[1]))
    want = np.asarray(Jfit.mcmc_gphps(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), jb, jnp.asarray(z0),
        key, JSC(**TINY)))
    got = Tfit.mcmc_gphps(t(x), t(y), t(mask, torch.bool), tb, z0,
                          np.asarray(key), TSC(**TINY))
    assert got.shape == want.shape == (3, 3 * d + 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_convert_defaults_to_the_card():
    """``params_from_numpy``/``posterior_from_numpy`` run on the card unless
    asked for the CPU, as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable")
    d = 3
    packed = packed_draws(d, 2, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy(packed, d)
    blob = convert.posterior_to_numpy(
        TG.fit_posterior_batch(*[t(a) for a in data(8, 5, d)[:2]],
                               convert.params_from_numpy(packed, d, device="cpu"),
                               t(data(8, 5, d)[2], torch.bool))
    )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.posterior_from_numpy(blob)
    post = convert.posterior_from_numpy(blob, device="cpu")
    assert post.chol.device.type == "cpu" and post.chol_inv is None
