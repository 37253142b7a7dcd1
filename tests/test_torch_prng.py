"""The port's threefry key stream (``repro_torch.core.prng``) against
``jax.random`` as this tree configures it (threefry2x32, partitionable).

Keys, splits and raw bits are integer arithmetic: bit-exact. ``uniform``
builds floats from the bits exactly as JAX does: exact. ``normal`` and
``exponential`` apply a transcendental, and XLA's CPU ``erf_inv`` and
``log1p`` are polynomial approximations that sit tens of ulp from the
correctly rounded value, where torch's/numpy's are within a few ulp; so
those are held to 256 ulp, not to 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.core import prng

SEEDS = [0, 1, 42, 2**33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_bit_exact(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 4, 300])
def test_split_bit_exact(seed, num):
    key = prng.PRNGKey(seed)
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    got = prng.split(key, num)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    # nested: split a split key, as the engine's chains do
    np.testing.assert_array_equal(
        prng.split(got[num - 1], 4), np.asarray(jax.random.split(want[num - 1], 4))
    )


@pytest.mark.parametrize("shape", [(), (7,), (3, 4)])
def test_random_bits_bit_exact(shape):
    jkey = jax.random.split(jax.random.PRNGKey(3), 3)[2]
    want = np.asarray(jax.random.bits(jkey, shape, dtype=jnp.uint64))
    np.testing.assert_array_equal(prng.random_bits(np.asarray(jkey), shape), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (7,), (3, 4)])
def test_uniform_exact(seed, shape):
    jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
    key = np.asarray(jkey)
    np.testing.assert_array_equal(
        prng.uniform(key, shape), np.asarray(jax.random.uniform(jkey, shape))
    )
    np.testing.assert_array_equal(
        prng.uniform(key, shape, -0.3, 0.7),
        np.asarray(jax.random.uniform(jkey, shape, minval=-0.3, maxval=0.7)),
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (14,), (10, 8), (200_000,)])
def test_normal_and_exponential_close(seed, shape):
    jkey = jax.random.split(jax.random.PRNGKey(seed))[0]
    key = np.asarray(jkey)
    want = np.asarray(jax.random.normal(jkey, shape))
    if want.size >= 100_000:
        assert np.abs(want).max() > 4.0  # the far tail is reached
    np.testing.assert_array_max_ulp(prng.normal(key, shape), want, maxulp=4)
    np.testing.assert_array_max_ulp(
        prng.exponential(key, shape),
        np.asarray(jax.random.exponential(jkey, shape)),
        maxulp=4,
    )


def test_draws_are_float64():
    key = prng.PRNGKey(0)
    assert prng.uniform(key, (3,)).dtype == np.float64
    assert prng.normal(key, (3,)).dtype == np.float64
    assert prng.exponential(key, (3,)).dtype == np.float64
