"""The port's tuning launcher (``repro_torch.launch.train``) against the JAX
package's (``repro.launch.train``), on the CPU at ``tiny()`` widths.

* ``build_objective`` on the same hyperparameters, from the same weights
  (the JAX package's ``Model.init`` carried across), reports the same
  eval-loss curve within 1e-5, for a dense arch and a MoE arch.
* A ``Tuner`` twin — ``RandomSuggester``, ``ThreadBackend(max_workers=1)``,
  the median rule — gives the reference's configurations exactly and its
  objectives and reported curves within 1e-5.
* A BO job of the port alone (the launcher's ``BOConfig(num_init=3).fast()``,
  two trials in flight, the median rule) completes with finite values and
  a best eval loss below ln(vocabulary).
* ``python -m repro_torch.launch.train --device cpu --trials 3 --steps 4``
  runs, and the CLI's flags are the reference's plus ``--device``.
"""

import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core as J
from repro.configs import get_config as j_get_config
from repro.configs import tiny as j_tiny
from repro.core.scheduler import ThreadBackend as JThread
from repro.launch import train as j_train
from repro.models import build_model as j_build_model
import repro_torch.core as T
from repro_torch import convert
from repro_torch.core.scheduler import ThreadBackend
from repro_torch.launch import train
from repro_torch.training.train_step import train_state_of

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP = {"learning_rate": 3e-3, "weight_decay": 0.01, "warmup_frac": 0.2,
      "beta2": 0.98, "clip_norm": 1.0}
STEPS, EVERY = 6, 2


@pytest.fixture
def jax_weights(monkeypatch):
    """Every trial of the port's objective starts from the weights the
    reference's starts from (its ``Model.init(PRNGKey(0))``), carried
    across with ``convert.load_lm_params``."""

    def use(arch):
        params = jax.tree.map(np.asarray, j_build_model(j_tiny(j_get_config(arch))).init(
            jax.random.PRNGKey(0)))
        monkeypatch.setattr(train, "init_train_state", lambda model, seed, opt: train_state_of(
            convert.load_lm_params(model, params), opt))

    return use


def _curve(objective, hp):
    reports = []
    final = objective(hp, lambda v: reports.append(v) or True)
    return final, reports


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-1b-a400m"])
def test_objective_curve_matches_reference(arch, jax_weights):
    jax_weights(arch)
    j_obj = j_train.build_objective(arch, STEPS, EVERY, full_config=False)
    obj = train.build_objective(arch, STEPS, EVERY, full_config=False, device="cpu")
    j_final, j_reports = _curve(j_obj, HP)
    final, reports = _curve(obj, HP)
    assert len(reports) == len(j_reports) == STEPS // EVERY
    np.testing.assert_allclose(reports, j_reports, rtol=0, atol=1e-5)
    assert abs(final - j_final) <= 1e-5
    assert reports[-1] < reports[0]  # the trial learns


def test_tuner_twin_random_suggester(jax_weights):
    arch = "qwen2.5-3b"
    jax_weights(arch)
    space, j_space = train.default_search_space(), j_train.default_search_space()
    assert [p.name for p in space.parameters] == [p.name for p in j_space.parameters]
    job = dict(max_trials=4, max_parallel=1)
    j_backend, backend = JThread(max_workers=1), ThreadBackend(max_workers=1)
    try:
        j_res = J.Tuner(j_space, j_train.build_objective(arch, STEPS, EVERY, False),
                        J.RandomSuggester(j_space, seed=3), j_backend,
                        J.TuningJobConfig(**job), stopping_rule=J.MedianRule()).run()
        res = T.Tuner(space, train.build_objective(arch, STEPS, EVERY, False, device="cpu"),
                      T.RandomSuggester(space, seed=3), backend,
                      T.TuningJobConfig(**job), stopping_rule=T.MedianRule()).run()
    finally:
        j_backend.shutdown()
        backend.shutdown()
    assert len(res.trials) == len(j_res.trials) == 4
    for t, jt in zip(res.trials, j_res.trials):
        assert t.config == jt.config
        assert t.state == jt.state
        assert abs(t.objective - jt.objective) <= 1e-5
        np.testing.assert_allclose(t.curve, jt.curve, rtol=0, atol=1e-5)
    assert res.num_failed_attempts == j_res.num_failed_attempts == 0


def test_bo_job_with_median_rule_completes():
    space = train.default_search_space()
    backend = ThreadBackend(max_workers=2)
    try:
        tuner = T.Tuner(
            space, train.build_objective("granite-moe-1b-a400m", 16, 4, False, device="cpu"),
            T.BOSuggester(space, T.BOConfig(num_init=3).fast(), seed=0, device="cpu"),
            backend, T.TuningJobConfig(max_trials=6, max_parallel=2),
            stopping_rule=T.MedianRule())
        res = tuner.run()
    finally:
        backend.shutdown()
    assert len(res.trials) == 6 and res.num_failed_attempts == 0
    assert all(t.state in ("COMPLETED", "STOPPED") for t in res.trials)
    assert all(math.isfinite(v) for t in res.trials for v in t.curve)
    # better than a uniform guess over the vocabulary
    assert res.best_objective < math.log(j_tiny(j_get_config("granite-moe-1b-a400m")).vocab_size)


def test_cli_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--trials", "3", "--steps", "4", "--checkpoint", str(tmp_path / "tuner.json")],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "trials         : 3 (stopped 0, failed attempts 0)" in out.stdout
    assert (tmp_path / "tuner.json").exists()


def test_cli_flags_are_the_references_plus_device(monkeypatch):
    seen = {}
    monkeypatch.setattr(j_train, "run_tuning_job", lambda a: seen.setdefault("jax", vars(a)))
    monkeypatch.setattr(train, "run_tuning_job", lambda a: seen.setdefault("torch", vars(a)))
    monkeypatch.setattr(sys, "argv", ["train"])
    j_train.main()
    train.main()
    mine, theirs = dict(seen["torch"]), dict(seen["jax"])
    assert mine.pop("device") is None
    assert mine.pop("checkpoint") != theirs.pop("checkpoint")  # under TMPDIR
    assert mine == theirs
