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
  started there stays put, as the JAX chain does;
* the kernel's speculative schedule — rounds of up to W points evaluated
  side by side (``csrc/slice_chain.cu``), emulated in numpy with its
  rounding — is the sequential chain: ``run_chain``'s kept samples, counts
  and trace bit for bit, for W = 1–16, on the port's log density and on
  synthetic targets that step out to ``max_stepout`` and run every shrink
  out; and it follows the JAX package's chain to 1e-9.
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


# ---------------------------------------------------------------------------
# The kernel's speculative schedule (csrc/slice_chain.cu), emulated in numpy.

DEPTH = 2  # stepping-out points a round takes from each open side (kDepth)


def _plan_round(width, need_g0, sides, shrink_state, point, u, cfg):
    """A round's slots, as plan_round makes them: g(0) if unknown; the next
    DEPTH points of each open side; then the shrink proposals of each
    bracket those points can end on (or of the known bracket), one a bracket
    in turn. Slots are (kind, key, t): kind "g0", "L", "R" (key: the point's
    index) or "S" (key: the bracket's stops (a, b))."""
    slots = [("g0", 0, 0.0)] if need_g0 else []
    stops = []
    for s, (open_, k) in enumerate(sides):
        if not open_:
            stops.append([k])
            continue
        a = min(DEPTH, cfg.max_stepout - k, width - len(slots))
        slots += [("LR"[s], k + i, point(s, k + i)) for i in range(a)]
        stops.append([k + i for i in range(a)])
    if not (stops[0] and stops[1]):
        return slots
    if shrink_state is not None:
        brackets = [[(stops[0][0], stops[1][0]), shrink_state]]
    else:
        brackets = [[(a, b), (point(0, a), point(1, b), 0)] for a in stops[0] for b in stops[1]]
    while len(slots) < width:
        added = False
        for br in brackets:
            (lo, hi, j) = br[1]
            if len(slots) >= width or j >= cfg.max_shrink:
                continue
            x = np.add(np.multiply(u[j], np.subtract(hi, lo)), lo)  # unfused, as __dadd_rn
            t_j = lo if lo >= x else x
            slots.append(("S", br[0], t_j))
            br[1] = (t_j, hi, j + 1) if t_j < 0.0 else (lo, t_j, j + 1)
            added = True
        if not added:
            break
    return slots


def _speculative_chain(log_prob, z0, draws, cfg, width):
    """The chain as the kernel runs it: each round evaluates its slots (in
    the kernel, side by side), then reads the values in the sequential
    chain's order — stepping out stops at a side's first g ≤ log_y, the
    shrink takes the first g > log_y of the bracket the sides stopped on
    (or runs out), every other value is thrown away. g(0) is carried from
    the point the last update accepted. Returns (kept, counts, trace, points
    evaluated, rounds)."""
    step = cfg.step_size
    z = np.asarray(z0, dtype=np.float64)
    counts = np.zeros(4)
    trace = []
    made = rounds = 0
    buf = np.zeros((cfg.num_samples, z.shape[0]))
    g0 = None
    for it in range(cfg.num_samples):
        direction = draws.directions[it]
        lo0 = np.multiply(-step, draws.offsets[it])
        seqs = ([lo0], [np.add(lo0, step)])

        def point(s, k):
            while len(seqs[s]) <= k:
                seqs[s].append(np.add(seqs[s][-1], step if s else -step))
            return seqs[s][k]

        sides = [[cfg.max_stepout > 0, 0], [cfg.max_stepout > 0, 0]]
        logged = ([], [], [])
        shrink_state = None
        log_y = None if g0 is None else np.subtract(g0, draws.levels[it])
        t_fin = None
        while True:
            slots = _plan_round(width, log_y is None, sides, shrink_state, point,
                                draws.shrink[it], cfg)
            values = [log_prob(z + t_j * direction) for _, _, t_j in slots]
            made += len(slots)
            rounds += 1
            known = shrink_state is not None
            shrinks = []
            for (kind, key, t_j), v in zip(slots, values):
                if kind == "g0":
                    g0, log_y = v, np.subtract(v, draws.levels[it])
                elif kind in "LR":
                    side = sides["LR".index(kind)]
                    if not side[0]:
                        continue  # past this side's stop
                    logged["LR".index(kind)].append(v)
                    if v > log_y:
                        side[1] += 1
                        side[0] = side[1] < cfg.max_stepout
                    else:
                        side[0] = False
                else:
                    shrinks.append((key, t_j, v))
            if sides[0][0] or sides[1][0]:
                continue
            stopped = (sides[0][1], sides[1][1])
            if not known:
                shrink_state = (point(0, stopped[0]), point(1, stopped[1]), 0)
            lo, hi, j = shrink_state
            for key, t_j, v in shrinks:
                if key != stopped:
                    continue  # assumed another bracket
                logged[2].append(v)
                j += 1
                if v > log_y:
                    t_fin = t_j
                    break
                lo, hi = (t_j, hi) if t_j < 0.0 else (lo, t_j)
            shrink_state = (lo, hi, j)
            if t_fin is not None or j >= cfg.max_shrink:
                break
        for v in (g0, *logged[0], *logged[1], *logged[2]):
            trace.append((it, v))
            counts += (1, v != v, 0, v != -np.inf)
        if t_fin is None:
            counts[2] += 1
            t_fin = 0.0
        else:
            g0 = logged[2][-1]
        z = z + t_fin * direction
        buf[it] = z
    return buf[keep_rows(cfg)], counts, trace, made, rounds


def _flat_target(dim, nan_center=None):
    """−inf outside [−6, 6]^dim; inside a slow quadratic, so stepping out
    runs to max_stepout, with NaN on thin stripes (Σp mod 0.37 < 0.02) and,
    with ``nan_center``, NaN in the unit ball around it."""
    def log_prob(p):
        if np.any(np.abs(p) > 6.0):
            return -np.inf
        if nan_center is not None and np.sum((p - nan_center) ** 2) < 1.0:
            return np.nan
        if np.mod(np.sum(p), 0.37) < 0.02:
            return np.nan
        return -1e-3 * float(np.sum(p * p))
    return log_prob


def _schedule_target(name):
    """(log_prob, z0, draws, cfg) of a named case."""
    if name.startswith("host"):
        d = 2
        x, y, mask = data(8, 6, d, seed=21)
        cfg = TSC(**FAST)
        z0 = start(d)
        b = TP.default_bounds(d)
        gram = torch.float64 if name == "host-f64" else torch.float32
        log_prob = host_log_density(t(x), t(y), t(mask, torch.bool),
                                    (b.lower, b.upper, b.center, np.maximum(b.width / 4.0, 1e-6)),
                                    gram)
        return log_prob, z0, chain_draws(prng.PRNGKey(22), z0.shape[0], cfg), cfg
    dim = 4
    cfg = TSC(num_samples=40, burn_in=20, thin=4)
    z0 = np.full(dim, 0.5)
    target = _flat_target(dim, z0 if name == "stuck" else None)
    return target, z0, chain_draws(prng.PRNGKey(23), dim, cfg), cfg


@pytest.mark.parametrize("width", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", ["host-f64", "host-f32", "flat", "stuck"])
def test_speculative_schedule_is_the_sequential_chain(name, width):
    """The kernel's rounds give run_chain's kept samples, four counts and
    logical trace bit for bit, at every width: on the port's log density
    (float64 and float32 grams), on a flat target whose stepping out runs
    to max_stepout with NaN stripes, and on a chain that starts on NaN and
    runs every shrink out (ROADMAP C10's stuck chain). At W = 1 the kernel
    evaluates the sequential chain's points alone, g(0) once."""
    log_prob, z0, draws, cfg = _schedule_target(name)
    want_trace = []
    want, want_counts = run_chain(log_prob, z0, draws, cfg, want_trace)
    got, counts, trace, made, rounds = _speculative_chain(log_prob, z0, draws, cfg, width)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(np.asarray(trace), np.asarray(want_trace))
    evaluations = int(counts[0])
    assert rounds <= made <= rounds * width
    if width == 1:
        assert made == rounds == evaluations - (cfg.num_samples - 1)
    else:
        assert rounds < evaluations - (cfg.num_samples - 1)
    steps = np.bincount([u for u, _ in want_trace], minlength=cfg.num_samples)
    if name == "flat":  # some update stepped out to max_stepout on a side
        assert steps.max() >= 1 + cfg.max_stepout + 1
        assert counts[1] > 0 and counts[2] == 0
    if name == "stuck":  # every shrink ran out; the chain never moved
        assert counts[2] == cfg.num_samples
        np.testing.assert_array_equal(got, np.tile(z0, (cfg.num_kept, 1)))
        assert np.all(steps == 1 + 2 + cfg.max_shrink)


def test_speculative_schedule_follows_jax_xla():
    """The kernel's schedule on the port's float64 target, on the JAX
    chain's key, keeps the JAX package's samples (``"xla"``) to 1e-9, as the
    port's sequential chain does."""
    d, bucket, n_live = 6, 8, 6
    x, y, mask = data(bucket, n_live, d, seed=bucket + d)
    z0 = start(d)
    key = prng.split(prng.PRNGKey(bucket * 10 + d))[1]
    want = _jax_chain(x, y, mask, d, z0, key, FAST, "xla")
    cfg = TSC(**FAST)
    b = TP.default_bounds(d)
    log_prob = host_log_density(t(x), t(y), t(mask, torch.bool),
                                (b.lower, b.upper, b.center, np.maximum(b.width / 4.0, 1e-6)),
                                torch.float64)
    got, counts, _, made, rounds = _speculative_chain(
        log_prob, z0, chain_draws(key, z0.shape[0], cfg), cfg, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert not np.array_equal(got[-1], z0)
    assert rounds < counts[0] - (cfg.num_samples - 1) < made


def test_wrapper_schedule_on_cpu_is_one_point_a_round():
    """With ``schedule=True`` the wrapper also says how the chain ran: the
    plain version on CPU tensors evaluates one point a round, each of them
    the chain's own, so [points evaluated, rounds, width] is [evaluations,
    evaluations, 1] — and the first three results are those without it."""
    d = 2
    x, y, mask = data(8, 6, d, seed=2)
    cfg = TSC(**TINY)
    z0 = start(d)
    table = t(pack_table(TP.default_bounds(d), z0,
                         chain_draws(prng.PRNGKey(5), z0.shape[0], cfg)))
    args = (t(x), t(y), t(mask, torch.bool), table, cfg, torch.float64)
    kept, counts, rows, schedule = slice_chain_kernel(*args, trace=True, schedule=True)
    want, want_counts, want_rows = slice_chain_kernel(*args, trace=True)
    assert torch.equal(kept, want) and torch.equal(counts, want_counts)
    assert torch.equal(rows, want_rows)
    assert schedule.tolist() == [float(counts[0]), float(counts[0]), 1.0]
