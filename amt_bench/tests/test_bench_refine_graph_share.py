"""The reader of ``acq_refine_graph_share`` computes what its manifest row
says, on synthetic counters."""

import pytest

from amt_bench import harness
from amt_bench.harness import Tracer


def read(counters):
    tr = Tracer(profile_seconds=6.0, device_kind="cpu")
    tr.counters = counters
    return harness.load_module("metrics", "acq_refine_graph_share").read({"tracer": tr})


def test_replays_over_every_refinement():
    c = {"acq.refine.graph.replay": 95, "acq.refine.graph.capture": 2,
         "acq.refine.eager": 3, "suggest.gphp.adopt": 40}
    assert read(c) == pytest.approx(95.0)
    assert read({"acq.refine.graph.replay": 7}) == pytest.approx(100.0)
    assert read({"acq.refine.eager": 12}) == 0.0  # the eager body: 0, not nothing
    assert read({"acq.refine.graph.capture": 1}) == 0.0


def test_a_program_without_the_counters_reads_nothing():
    assert read({}) is None
    assert read({"suggest.gphp.adopt": 5, "suggest.gphp.refit": 1}) is None


def test_the_manifest_row():
    row = next(m for m in harness.manifest()["per_layer"]
               if m["name"] == "acq_refine_graph_share")
    assert row == {"name": "acq_refine_graph_share", "unit": "%", "better": "higher",
                   "source": "program_counter",
                   "layer": "anchor scoring + refinement (core/optimize_acq.py)",
                   "moves": "decision_p50_ms", "workloads": ["amt-xgb6.shared8"]}
