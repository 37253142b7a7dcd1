"""The slice-sampling chain's draw table, the slice-chain kernel's plain
version and the refit route against the JAX package, on the CPU.

* ``chain_draws`` equals the draws the chain takes update by update
  (``prng.split`` / ``normal`` / ``exponential`` / ``uniform``) bit for bit,
  and its keys and unit shrink draws equal ``jax.random``'s (XLA's CPU
  backend fuses the scaled draw u·(hi − lo) + lo into one rounding, so the
  reference's shrink points may sit an ulp from numpy's: one reason the
  chains are held at 1e-9, not bit for bit);
* the kernel rounds the chain's host arithmetic one operation at a time
  (``__dmul_rn`` / ``__dadd_rn``): a numpy emulation of that equals
  ``prng.uniform`` and numpy's ``z + t·direction`` bit for bit, where a
  fused multiply-add would not;
* ``kernels/slice_chain`` on CPU tensors runs its plain version and counts
  no launch;
* ``fit.mcmc_gphps`` equals the JAX package's to 1e-9 (the chain takes the
  same branches and its points differ only by the rounding of its targets):
  ``"xla"`` against ``"torch"`` (float64 grams); and ``backend="pallas"``
  (interpret mode) against the port's ``"kernel"`` (float32 grams, which
  the two packages round differently) up to the first branch their targets
  decide differently, the port's chain on the reference's target equalling
  the reference's chain;
* where the float32 gram is indefinite the log density is NaN, and a chain
  started there stays put, as the JAX chain does.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gp import fit as Jfit
from repro.core.gp import gp as JG
from repro.core.gp import params as JP
from repro.core.gp.slice_sampler import SliceSamplerConfig as JSC
from repro_torch import kernels as K
from repro_torch.core import prng
from repro_torch.core.gp import fit as Tfit
from repro_torch.core.gp import params as TP
from repro_torch.core.gp.slice_sampler import SliceSamplerConfig as TSC
from repro_torch.core.gp.slice_sampler import chain_draws, keep_rows, run_chain
from repro_torch.kernels.slice_chain.kernel import slice_chain_kernel
from repro_torch.kernels.slice_chain.plain import (
    host_log_density,
    max_evaluations,
    pack_table,
    slice_chain_plain,
)

TINY = dict(num_samples=12, burn_in=6, thin=2)
FAST = dict(num_samples=60, burn_in=30, thin=3)


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def data(bucket, n_live, d, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((bucket, d))
    y = np.zeros(bucket)
    x[:n_live] = rng.random((n_live, d))
    y[:n_live] = rng.standard_normal(n_live)
    y[:n_live] = (y[:n_live] - y[:n_live].mean()) / y[:n_live].std()
    return x, y, np.arange(bucket) < n_live


def start(d):
    b = TP.default_bounds(d)
    return np.clip(TP.default_params(d).pack().numpy(), b.lower + 1e-4, b.upper - 1e-4)


@pytest.mark.parametrize("dim", [5, 20])
def test_chain_draws_equal_the_per_update_draws(dim):
    cfg = TSC(num_samples=40, burn_in=20, thin=4)
    key = prng.split(prng.PRNGKey(dim))[1]
    draws = chain_draws(key, dim, cfg)
    assert draws.directions.shape == (40, dim) and draws.shrink.shape == (40, 32)
    jkeys = jax.random.split(jnp.asarray(key), 40)
    for i, k in enumerate(prng.split(key, 40)):
        k_dir, k_lvl, k_init, k_shrink = prng.split(k, 4)
        direction = prng.normal(k_dir, (dim,))
        direction = direction / max(float(np.linalg.norm(direction)), 1e-12)
        assert np.array_equal(draws.directions[i], direction)
        assert draws.levels[i] == prng.exponential(k_lvl)
        assert draws.offsets[i] == prng.uniform(k_init)
        jk_shrink = jax.random.split(jkeys[i], 4)[3]
        for j in range(cfg.max_shrink):
            k_shrink, sub = prng.split(k_shrink)
            jk_shrink, jsub = jax.random.split(jk_shrink)
            assert draws.shrink[i, j] == prng.uniform(sub)
            assert draws.shrink[i, j] == float(jax.random.uniform(jsub))
        assert np.array_equal(k_shrink, np.asarray(jk_shrink))


def _fma(a: float, b: float, c: float) -> float:
    """a·b + c rounded once, as a fused multiply-add rounds it."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def test_kernel_rounding_emulation_is_numpys():
    """The kernel computes max(lo, u·(hi − lo) + lo) and z + t·d as
    __dadd_rn(__dmul_rn(·, ·), ·): each product and sum rounded on its own.
    Emulated so in numpy, that is prng.uniform and numpy's z + t·d bit for
    bit; one rounding (an FMA, which nvcc would otherwise emit) is not."""
    rng = np.random.default_rng(0)
    cfg = TSC(num_samples=64)
    draws = chain_draws(prng.PRNGKey(3), 8, cfg)
    keys = prng.split(prng.PRNGKey(3), 64)
    fused_differs = 0
    for i in range(64):
        k_shrink = prng.split(keys[i], 4)[3]
        for j in range(cfg.max_shrink):
            k_shrink, sub = prng.split(k_shrink)
            lo = -float(rng.random()) * 2.0
            hi = lo + float(rng.random()) * 3.0
            u = float(draws.shrink[i, j])
            x = np.add(np.multiply(u, np.subtract(hi, lo)), lo)
            emulated = lo if lo >= x else x
            assert emulated == prng.uniform(sub, (), lo, hi)
            fused_differs += _fma(u, hi - lo, lo) != x
    assert fused_differs > 0
    z = rng.standard_normal((64, 8))
    ts = rng.standard_normal(64) * 3.0
    fused_differs = 0
    for zi, ti, di in zip(z, ts, draws.directions):
        emulated = np.array([np.add(a, np.multiply(ti, b)) for a, b in zip(zi, di)])
        assert np.array_equal(emulated, zi + ti * di)
        fused_differs += sum(_fma(ti, b, a) != e for a, b, e in zip(zi, di, emulated))
    assert fused_differs > 0


@pytest.mark.parametrize("gram", [torch.float32, torch.float64])
def test_wrapper_on_cpu_runs_plain_and_counts_no_launch(gram):
    d = 2
    x, y, mask = data(8, 6, d, seed=1)
    cfg = TSC(**TINY)
    z0 = start(d)
    table = t(pack_table(TP.default_bounds(d), z0,
                         chain_draws(prng.PRNGKey(4), z0.shape[0], cfg)))
    args = (t(x), t(y), t(mask, torch.bool), table, cfg, gram)
    K.reset_launch_counts()
    kept, counts, rows = slice_chain_kernel(*args, trace=True)
    assert K.LAUNCHES == {name: 0 for name in K.KERNEL_NAMES}
    want, want_counts, _ = slice_chain_plain(*args)
    assert kept.shape == (cfg.num_kept, 3 * d + 2) and kept.dtype == torch.float64
    assert torch.equal(kept, want) and torch.equal(counts, want_counts)
    assert rows.shape == (int(counts[0]), 2) and int(counts[0]) <= max_evaluations(cfg)
    assert int(counts[3]) <= int(counts[0]) and int(counts[2]) <= cfg.num_samples
    with pytest.raises(TypeError):
        slice_chain_kernel(*args[:5], torch.bfloat16)
    with pytest.raises(ValueError):
        slice_chain_kernel(t(x), t(y), t(mask, torch.bool), table[:-1], cfg, gram)


def _jax_chain(x, y, mask, d, z0, key, cfg, backend):
    return np.asarray(Jfit.mcmc_gphps(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), JP.default_bounds(d),
        jnp.asarray(z0), jnp.asarray(key), JSC(**cfg), backend))


def _port_chain(x, y, mask, d, z0, key, cfg, backend):
    K.reset_launch_counts()
    got = Tfit.mcmc_gphps(t(x), t(y), t(mask, torch.bool), TP.default_bounds(d), z0,
                          key, TSC(**cfg), backend)
    assert K.LAUNCHES["slice_chain"] == 0
    assert got.shape == (TSC(**cfg).num_kept, 3 * d + 2)
    return got


CASES = [pytest.param(cfg, bucket, n_live, d, id=f"{name}-{bucket}-d{d}")
         for name, cfg in (("tiny", TINY), ("fast", FAST))
         for bucket, n_live in ((8, 6), (16, 13)) for d in (1, 6)]


@pytest.mark.parametrize("cfg,bucket,n_live,d", CASES)
def test_mcmc_gphps_f64_matches_jax_xla(cfg, bucket, n_live, d):
    """float64 grams on both sides (``"xla"``, ``"torch"``): the chains take
    the same branches, and the kept samples agree to 1e-9."""
    x, y, mask = data(bucket, n_live, d, seed=bucket + d)
    z0 = start(d)
    key = prng.split(prng.PRNGKey(bucket * 10 + d))[1]
    want = _jax_chain(x, y, mask, d, z0, key, cfg, "xla")
    got = _port_chain(x, y, mask, d, z0, key, cfg, "torch")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert not np.array_equal(got[-1], z0)  # the chain moved


def _first_divergence(ta, tb, levels):
    """First evaluation at which two chains' traces (update, g) decide a
    branch differently, as (evaluation, update), or None. Each update's
    first evaluation is g(0), which sets its slice level g(0) − level."""
    level_a = level_b = None
    for e, ((ua, ga), (ub, gb)) in enumerate(zip(ta, tb)):
        assert ua == ub
        if e == 0 or ta[e - 1][0] != ua:
            level_a, level_b = ga - levels[ua], gb - levels[ub]
        elif (ga > level_a) != (gb > level_b):
            return e, ua
    assert len(ta) == len(tb)
    return None


@pytest.mark.parametrize("cfg,bucket,n_live,d", CASES)
def test_mcmc_gphps_f32_follows_jax_pallas(cfg, bucket, n_live, d):
    """float32 grams (``"pallas"`` in interpret mode, the port's
    ``"kernel"``). The two grams round differently — the Pallas kernel forms
    ‖a‖² + ‖b‖² − 2a·b on the MXU, the port the difference form — and a
    nearly singular gram (d = 1: six points on a line, long lengthscales,
    amplitude² in the hundreds) turns that into log densities several units
    apart. So the test holds what the chain can be held to:

    * the port's chain on the reference's target (the JAX log density with
      the Pallas gram) is the reference's chain, to 1e-9;
    * ``mcmc_gphps`` is the port's chain on the port's float32 target;
    * the two agree to 1e-9 up to the first branch their targets decide
      differently — at the same point, with different target values — and
      where no branch differs, to 1e-9 throughout."""
    x, y, mask = data(bucket, n_live, d, seed=bucket + d)
    z0 = start(d)
    key = prng.split(prng.PRNGKey(bucket * 10 + d))[1]
    c = TSC(**cfg)
    want = _jax_chain(x, y, mask, d, z0, key, cfg, "pallas")
    got = _port_chain(x, y, mask, d, z0, key, cfg, "kernel")

    draws = chain_draws(key, z0.shape[0], c)
    jb = JP.default_bounds(d)
    jax_target = jax.jit(lambda p: JG.log_posterior_density(
        jnp.asarray(x), jnp.asarray(y), p, jb, jnp.asarray(mask), backend="pallas"))
    b = TP.default_bounds(d)
    port_target = host_log_density(
        t(x), t(y), t(mask, torch.bool),
        (b.lower, b.upper, b.center, np.maximum(b.width / 4.0, 1e-6)), torch.float32)
    runs = []
    for target in (lambda p: float(jax_target(jnp.asarray(p))), port_target):
        points, trace = [], []
        kept, _ = run_chain(lambda p: points.append(p) or target(p), z0, draws, c, trace)
        runs.append((kept, points, trace))
    (kept_a, points_a, trace_a), (kept_b, points_b, trace_b) = runs
    np.testing.assert_allclose(kept_a, want, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got, kept_b)

    first = _first_divergence(trace_a, trace_b, draws.levels)
    if first is None:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
        return
    e, update = first
    for pa, pb in zip(points_a[: e + 1], points_b[: e + 1]):
        np.testing.assert_array_equal(pa, pb)
    g0 = next(i for i, (u, _) in enumerate(trace_a) if u == update)
    assert trace_a[e][1] != trace_b[e][1] or trace_a[g0][1] != trace_b[g0][1]
    before = keep_rows(c) < update
    np.testing.assert_allclose(got[before], want[before], rtol=0, atol=1e-9)


def test_indefinite_gram_gives_nan_and_the_chain_stays_put():
    """Near-duplicate rows, a large amplitude and the smallest noise: the
    float32 gram's rounding (~1e-5 here) swamps the 2e-8 of noise on the
    diagonal, the factor fails and the log density is NaN — in the port's
    plain chain and in the JAX package's Pallas route alike. A chain that
    starts there compares NaN against every slice level, takes no point and
    keeps its start, as the JAX chain does."""
    d, bucket, n_live = 2, 16, 12
    rng = np.random.default_rng(5)
    x = np.zeros((bucket, d))
    base = rng.random((4, d))
    x[:n_live] = np.repeat(base, 3, axis=0) + 1e-4 * rng.random((n_live, d))
    y = np.zeros(bucket)
    y[:n_live] = rng.standard_normal(n_live)
    mask = np.arange(bucket) < n_live
    bounds = TP.default_bounds(d)
    z0 = start(d)
    z0[d] = bounds.upper[d] - 1e-4  # amplitude near 20
    z0[d + 1] = bounds.lower[d + 1] + 1e-4  # noise near 1e-4
    jargs = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(z0), JP.default_bounds(d),
             jnp.asarray(mask))
    assert np.isnan(float(JG.log_posterior_density(*jargs, backend="pallas")))
    cfg = TSC(**TINY)
    table = t(pack_table(bounds, z0, chain_draws(prng.PRNGKey(9), z0.shape[0], cfg)))
    kept, counts, rows = slice_chain_plain(t(x), t(y), t(mask, torch.bool), table, cfg,
                                           torch.float32, trace=True)
    assert np.isnan(float(rows[0, 1]))  # g(z0)
    assert int(counts[2]) == cfg.num_samples  # every shrink ran out
    assert int(counts[1]) >= cfg.num_samples
    np.testing.assert_array_equal(kept.numpy(), np.tile(z0, (cfg.num_kept, 1)))
    key = prng.split(prng.PRNGKey(11))[1]
    want = np.asarray(Jfit.mcmc_gphps(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), JP.default_bounds(d),
        jnp.asarray(z0), jnp.asarray(key), JSC(**TINY), "pallas"))
    got = Tfit.mcmc_gphps(t(x), t(y), t(mask, torch.bool), bounds, z0, key, cfg, "kernel")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.tile(z0, (cfg.num_kept, 1)))
