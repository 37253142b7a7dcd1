"""The port's Matérn-5/2 gram and cross-row dispatchers on the CPU (their
plain versions) against the JAX package's oracles (``matern52_gram_ref``,
``matern52_cross_ref``) and Pallas ops (interpret mode), in float32 at 2e-5:
the reference's own tolerance (``tests/test_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gp import params as JP
from repro.kernels.matern52.ops import matern52_cross as j_cross
from repro.kernels.matern52.ops import matern52_gram as j_gram
from repro.kernels.matern52.ref import matern52_cross_ref, matern52_gram_ref
from repro_torch import convert
from repro_torch.kernels.matern52.ops import matern52_cross, matern52_gram


def _params(d, S, seed):
    rng = np.random.default_rng(seed)
    base = np.asarray(JP.default_params(d).pack())
    packed = base + 0.3 * rng.standard_normal((S, 3 * d + 2))
    if S == 1:
        packed = packed[0]
    return packed


@pytest.mark.parametrize("n,m,d", [(8, 8, 2), (37, 130, 5), (130, 64, 12)])
@pytest.mark.parametrize("warp", [True, False])
def test_gram_plain_matches_ref_and_pallas(n, m, d, warp):
    rng = np.random.default_rng(n + m)
    x1, x2 = rng.random((n, d)), rng.random((m, d))
    packed = _params(d, 1, d)
    jp = JP.GPHyperParams.unpack(jnp.asarray(packed), d)
    tp = convert.params_from_numpy(packed, d, device="cpu")
    got = matern52_gram(torch.as_tensor(x1), torch.as_tensor(x2), tp, warp=warp)
    assert got.dtype == torch.float64 and got.shape == (n, m)
    ref = np.asarray(matern52_gram_ref(jnp.asarray(x1), jnp.asarray(x2), jp, warp=warp))
    pal = np.asarray(j_gram(jnp.asarray(x1), jnp.asarray(x2), jp, warp=warp))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), pal, rtol=0, atol=2e-5)


def test_gram_and_cross_batched_over_samples():
    d, S = 4, 3
    rng = np.random.default_rng(1)
    x1 = rng.random((20, d))
    packed = _params(d, S, 2)
    tp = convert.params_from_numpy(packed, d, device="cpu")
    got = matern52_gram(torch.as_tensor(x1), torch.as_tensor(x1), tp).numpy()
    row = matern52_cross(torch.as_tensor(x1[3]), torch.as_tensor(x1), tp).numpy()
    assert got.shape == (S, 20, 20) and row.shape == (S, 20)
    for s in range(S):
        jp = JP.GPHyperParams.unpack(jnp.asarray(packed[s]), d)
        ref = np.asarray(matern52_gram_ref(jnp.asarray(x1), jnp.asarray(x1), jp))
        np.testing.assert_allclose(got[s], ref, rtol=0, atol=2e-5)
        np.testing.assert_allclose(row[s], ref[3], rtol=0, atol=2e-5)


@pytest.mark.parametrize("m,d", [(8, 2), (200, 7)])
def test_cross_plain_matches_ref_and_pallas(m, d):
    rng = np.random.default_rng(m)
    xn, xt = rng.random(d), rng.random((m, d))
    packed = _params(d, 1, m)
    jp = JP.GPHyperParams.unpack(jnp.asarray(packed), d)
    tp = convert.params_from_numpy(packed, d, device="cpu")
    got = matern52_cross(torch.as_tensor(xn), torch.as_tensor(xt), tp).numpy()
    ref = np.asarray(matern52_cross_ref(jnp.asarray(xn), jnp.asarray(xt), jp))
    pal = np.asarray(j_cross(jnp.asarray(xn), jnp.asarray(xt), jp))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, pal, rtol=0, atol=2e-5)
