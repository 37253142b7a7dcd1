"""Runs with the timed path broken underneath come out not correct: an
answer altered where the engine produces it, a refit or a step that leaves
its state unchanged, a GPHP chain short of a sweep or on a tempered
target, a shared pool that hands out stale draws, observations the engine
drops, half of a training batch left out. (One card: no exchange between
chips to leave out.)"""

import numpy as np
import pytest

from amt_bench import harness
from bench_sizes import ENGINE, ENGINE_CONF, LM, ONE_JOB, tiny_lm


#: the engine's traffic: the shared8 cell as it is, and as one job alone
TRAFFIC = {"one_job": ONE_JOB, "shared8": {}}


def _engine_run(traffic):
    from amt_bench import run

    result, _ = run.run_cell("amt-xgb6.shared8", 99, 3.0, False, device="cpu",
                             overrides={**ENGINE, **TRAFFIC[traffic]}, conf_overrides=ENGINE_CONF)
    return result


def _altered_answer(monkeypatch):
    from repro_torch.core.suggest import BOSuggester

    original = BOSuggester._first_unseen

    def altered(self, cands, x_all, pend_np, picks):
        config, vec = original(self, cands, x_all, pend_np, picks)
        vec = self.space.round_trip(np.where(np.arange(len(vec)) == 0, 1.0 - vec, vec))
        return self.space.decode(vec), vec

    monkeypatch.setattr(BOSuggester, "_first_unseen", altered)


def _refit_unchanged(monkeypatch):
    from repro_torch.core.suggest import BOSuggester

    original = BOSuggester._fit_gphps

    def stale(self, *args, **kwargs):
        if self.cache.samples is not None:
            return np.array(self.cache.samples)
        return original(self, *args, **kwargs)

    monkeypatch.setattr(BOSuggester, "_fit_gphps", stale)


def _chain_short_of_sweeps(monkeypatch):
    from repro_torch.core import suggest

    original = suggest.mcmc_gphps

    def short(x, y, mask, bounds, z0, key, cfg, backend="torch"):
        return original(x, y, mask, bounds, z0, key, cfg._replace(burn_in=cfg.burn_in - 1),
                        backend)

    monkeypatch.setattr(suggest, "mcmc_gphps", short)


def _chain_on_tempered_target(monkeypatch):
    """The chain samples the marginal likelihood raised to the power 1/2."""
    from repro_torch.kernels.slice_chain import plain

    original = plain.log_marginal_likelihood

    def tempered(*args, **kwargs):
        return 0.5 * original(*args, **kwargs)

    monkeypatch.setattr(plain, "log_marginal_likelihood", tempered)


def _pool_stale(monkeypatch):
    """The shared pool keeps handing out the first draws it was given."""
    from repro_torch.core.service import GPHPSamplePool

    original = GPHPSamplePool.publish

    def publish(self, samples, chain_state):
        first = self.samples
        original(self, samples, chain_state)
        if first is not None:
            self.samples = first

    monkeypatch.setattr(GPHPSamplePool, "publish", publish)


def _drops_observations(monkeypatch):
    from repro_torch.core.history import ObservationStore

    original = ObservationStore.push

    def push(self, config, y, *args, **kwargs):
        if self.num_observations == 4:  # the fifth observation is lost
            self._lost = getattr(self, "_lost", 0) + 1
            if self._lost == 1:
                return False
        return original(self, config, y, *args, **kwargs)

    monkeypatch.setattr(ObservationStore, "push", push)


@pytest.mark.parametrize("traffic", sorted(TRAFFIC))
def test_engine_sound_run_is_correct(traffic):
    assert _engine_run(traffic)["correct"] is True


@pytest.mark.parametrize("traffic,fault", [
    ("one_job", _altered_answer), ("one_job", _drops_observations),
    ("shared8", _altered_answer), ("shared8", _drops_observations),
])
def test_engine_fault_is_not_correct(traffic, fault, monkeypatch):
    fault(monkeypatch)
    assert _engine_run(traffic)["correct"] is False


@pytest.mark.parametrize("traffic,fault", [
    ("one_job", _refit_unchanged), ("one_job", _chain_short_of_sweeps),
    ("one_job", _chain_on_tempered_target),
    ("shared8", _refit_unchanged), ("shared8", _chain_short_of_sweeps),
    ("shared8", _chain_on_tempered_target), ("shared8", _pool_stale),
])
def test_engine_gphp_fault_fails_gphp_gap(traffic, fault, monkeypatch):
    """A refit or a pool that supplies the wrong GPHP samples is caught by
    the chain's own number, whatever the EI at the picks reads."""
    fault(monkeypatch)
    result = _engine_run(traffic)
    gap = result["checks"]["gphp_gap"]
    assert result["correct"] is False and gap["value"] > gap["limit"], gap


def _train_checks(cell):
    import torch

    _, wl, conf = harness.cell_files(cell)
    runner = harness.load_module("runners", "train")
    c = runner.Cell(tiny_lm(conf), {**wl, **LM}, 5, torch.device("cpu"))
    c.setup()
    record = c.window(0.5)
    checks = c.check()
    return record["failed"] == 0 and all(v <= lim for _, v, lim, _ in checks), checks


@pytest.mark.parametrize("cell", ["granite-moe-1b-a400m.train32k",
                                  "granite-moe-1b-a400m.train16k"])
def test_train_sound_run_is_correct(cell):
    ok, checks = _train_checks(cell)
    assert ok, checks


def test_train_step_that_leaves_its_state_unchanged(monkeypatch):
    from repro_torch.training import train_step

    monkeypatch.setattr(train_step, "adamw_update",
                        lambda params, grads, opt, cfg: (params, opt, {"lr": 0.0, "grad_norm": 0.0}))
    ok, checks = _train_checks("granite-moe-1b-a400m.train16k")
    assert not ok and dict((c[0], c[1]) for c in checks)["change_gap"] == pytest.approx(1.0)


def test_train_half_the_batch(monkeypatch):
    from repro_torch.models import model as M

    monkeypatch.setattr(M.Model, "loss_fn", M.Model.loss_fn)
    harness.load_module("runners", "train").FAULTS["half_batch"]()
    ok, checks = _train_checks("granite-moe-1b-a400m.train16k")
    assert not ok, checks
