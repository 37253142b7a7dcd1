"""The traffic is a function of the seed: identical for one seed, different
for two."""

import numpy as np
import torch

from amt_bench import harness
from amt_bench.runners import engine
from amt_bench.inputs.lm import SyntheticLMDataset, make_weights
from amt_bench.reference import bo_decision as R

_, _, CONF = harness.cell_files("amt-xgb6.shared8")
SPACE = CONF["space"]


def test_derived_seeds():
    assert harness.derive_seed(2**31 + 7, 3) == harness.derive_seed(2**31 + 7, 3)
    assert harness.derive_seed(2**31 + 7, 3) != harness.derive_seed(2**31 + 8, 3)
    assert harness.derive_seed(5, 0) != harness.derive_seed(5, 1)
    assert 0 <= harness.derive_seed(-1, 2**40) < 2**31


def test_engine_objective_and_cold_start():
    x = R.decode(SPACE, np.full(len(SPACE), 0.3))
    a = engine.make_objective(CONF["objective"], SPACE, 11)
    b = engine.make_objective(CONF["objective"], SPACE, 11)
    c = engine.make_objective(CONF["objective"], SPACE, 12)
    assert a(x) == b(x) and a(x) != c(x)
    assert np.array_equal(R.cold_start(SPACE, 11, 6), R.cold_start(SPACE, 11, 6))
    assert not np.array_equal(R.cold_start(SPACE, 11, 6), R.cold_start(SPACE, 12, 6))


def test_cold_start_is_the_programs():
    from repro_torch.core import BOConfig, BOSuggester
    from repro_torch.core.history import ObservationStore
    from amt_bench.runners.engine import Cell

    cell = Cell(CONF, {}, 0, torch.device("cpu"))
    space = cell._space()
    store = ObservationStore(space)
    sugg = BOSuggester(space, BOConfig(), seed=12345, store=store, device="cpu")
    got = [R.encode(SPACE, c) for c in sugg.suggest_batch(3)]
    assert np.array_equal(np.array(got), R.cold_start(SPACE, 12345, 3))


def test_lm_batches_and_weights():
    a, b, c = (SyntheticLMDataset(97, 16, 4, seed=s) for s in (3, 3, 4))
    assert np.array_equal(a.batch(2)["inputs"], b.batch(2)["inputs"])
    assert not np.array_equal(a.batch(2)["inputs"], c.batch(2)["inputs"])
    assert not np.array_equal(a.batch(2)["inputs"], a.batch(3)["inputs"])
    assert np.array_equal(a.batch(0)["inputs"][:, 1:], a.batch(0)["labels"][:, :-1])
    model = {"vocab_size": 97, "d_model": 8, "num_layers": 1, "num_heads": 2,
             "num_kv_heads": 1, "head_dim": 4, "moe": {"num_experts": 2, "d_expert": 4}}
    f1, _ = make_weights(model, 9, "cpu")
    f2, w2 = make_weights(model, 9, "cpu")
    f3, _ = make_weights(model, 10, "cpu")
    assert torch.equal(f1, f2) and not torch.equal(f1, f3)
    assert float(w2["blocks.0.ln1"].abs().sum()) == 0.0
