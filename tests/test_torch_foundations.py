"""The port's numpy foundations against the JAX package's: search space,
Sobol stream, observation store (with warm-start parents), trial records.

These modules are copies with rewritten imports, so the twins demand exact
equality on the same inputs.
"""

import math

import numpy as np
import pytest

import repro.core as J
from repro.core.sobol import SobolSequence as JSobol
import repro_torch.core as T
from repro_torch.core.sobol import SobolSequence as TSobol
from repro_torch.core.trial import Trial as TTrial


def _space(C):
    return C.SearchSpace([
        C.Continuous("lr", 1e-5, 1.0, scaling="log"),
        C.Continuous("mom", 0.5, 0.999, scaling="reverse_log"),
        C.Continuous("drop", 0.0, 0.5),
        C.Integer("layers", 1, 12),
        C.Integer("width", 16, 1024, scaling="log"),
        C.Categorical("act", ["relu", "gelu", "tanh"]),
    ])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_space_encode_decode_round_trip(seed):
    js, ts = _space(J), _space(T)
    assert ts.encoded_dim == js.encoded_dim
    np.testing.assert_array_equal(ts.warpable_dims(), js.warpable_dims())
    assert ts.to_spec() == js.to_spec()
    configs = js.sample(np.random.default_rng(seed), 20)
    assert ts.sample(np.random.default_rng(seed), 20) == configs
    np.testing.assert_array_equal(ts.encode_batch(configs), js.encode_batch(configs))
    vecs = np.random.default_rng(seed + 10).random((20, js.encoded_dim))
    for v in vecs:
        np.testing.assert_array_equal(ts.round_trip(v), js.round_trip(v))
        assert ts.decode(v) == js.decode(v)


@pytest.mark.parametrize("dim", [1, 3, 7])
@pytest.mark.parametrize("shift_seed", [None, 5])
def test_sobol_stream_equal(dim, shift_seed):
    def make(cls):
        rng = None if shift_seed is None else np.random.default_rng(shift_seed)
        return cls(dim, shift_rng=rng)

    js, ts = make(JSobol), make(TSobol)
    for n in (1, 7, 64):
        np.testing.assert_array_equal(ts.next(n), js.next(n))


@pytest.mark.parametrize("with_parents", [False, True])
def test_observation_store_standardization_equal(with_parents):
    js_space, ts_space = _space(J), _space(T)
    rng = np.random.default_rng(3)
    parents = [(c, float(rng.standard_normal())) for c in js_space.sample(rng, 6)]
    own = [(c, float(rng.random() * 10)) for c in js_space.sample(rng, 11)]

    def build(C, space):
        pool = None
        if with_parents:
            pool = C.WarmStartPool()
            pool.add_parent(parents, name="parent")
        store = C.ObservationStore(space, warm_start=pool)
        for i, (c, y) in enumerate(own):
            store.push(c, y, key=i)
        store.push(own[0][0], math.inf)  # dropped: non-finite
        store.mark_pending(99, own[1][0])
        return store

    js, ts = build(J, js_space), build(T, ts_space)
    assert ts.num_observations == js.num_observations
    assert ts.num_parents == js.num_parents
    for a, b in zip(ts.standardized(), js.standardized()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(ts.pending_encoded(), js.pending_encoded())
    assert ts.fingerprint() == js.fingerprint()
    # the state blob of either package loads into the other
    t2 = T.ObservationStore(ts_space, warm_start=None)
    t2.load_state_dict(js.state_dict())
    assert t2.state_dict() == js.state_dict()


def test_trial_json_round_trip():
    t = TTrial(trial_id=3, config={"a": 1.5}, submit_time=2.0)
    t.curve = [3.0, 2.0]
    assert TTrial.from_json(t.to_json()).to_json() == t.to_json()
