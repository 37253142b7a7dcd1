"""The readers compute what their names say, over all of the window."""

import re
import statistics

import numpy as np
import pytest

from amt_bench import harness
from amt_bench.harness import DeviceTrace


def read(name, rec):
    return harness.load_module("metrics", name).read(rec)


def test_p95_is_over_every_call_and_a_stall_moves_it():
    calls = [100.0 + (i % 7) for i in range(200)]
    rec = {"call_ms": calls}
    assert read("decision_p95_ms", rec) == pytest.approx(np.percentile(calls, 95))
    assert read("decision_p50_ms", rec) == statistics.median(calls)
    stalled = calls[:190] + [1000.0] * 15 + calls[190:]  # a stall holds up 15 calls
    assert read("decision_p95_ms", {"call_ms": stalled}) > 500.0
    assert read("decision_p50_ms", {"call_ms": stalled}) < 110.0
    # the median of the p95s of chunks would hide the stall
    chunks = [np.percentile(stalled[i:i + 43], 95) for i in range(0, 215, 43)]
    assert statistics.median(chunks) < 110.0


def test_tokens_per_second_is_all_tokens_over_the_whole_window():
    rec = {"steps": 19, "tokens": 19 * 32 * 1024, "window_s": 30.7}
    assert read("train_tokens_per_s", rec) == 19 * 32 * 1024 / 30.7


def test_frozen_model_flops():
    conf = harness.load_json(harness.BENCH / "configs" / "granite-moe-1b-a400m.json")
    mfu = harness.load_module("metrics", "train_mfu")
    assert mfu.step_flops(conf["model"], 16, 1024) == 44612764827648.0
    assert mfu.step_flops(conf["model"], 32, 1024) == 2 * 44612764827648.0
    rec = {"steps": 10, "window_s": 10.0, "conf": conf, "device_name": "NVIDIA H100 80GB HBM3",
           "workload": {"global_batch": 16, "seq_len": 1024}}
    assert read("train_mfu", rec) == pytest.approx(100 * 44612764827648.0 / 989e12)


def test_device_trace_busy_idle_and_gaps():
    ops = [("k1", 0.0, 10.0), ("k2", 5.0, 10.0), ("k3", 40.0, 10.0), ("k1", 100.0, 20.0)]
    dt = DeviceTrace(ops, window_s=200e-6)
    assert dt.busy_s() == pytest.approx(45e-6)
    assert dt.time_of(re.compile("k1")) == pytest.approx(30e-6)
    assert dt.top_ops(2)[0][0] == "k1"
    spans = [{"name": "suggest.gphp_fit", "t0": 60e-6, "t1": 90e-6},
             {"name": "suggest.decide", "t0": 0.0, "t1": 1.0}]
    dt.name_gaps(spans)
    assert dt.gaps[0] == ["suggest.gphp_fit", pytest.approx(50e-6)]
    assert dt.gaps[1] == ["suggest.decide", pytest.approx(25e-6)]


def test_acq_score_roofline_counts():
    roof = harness.load_module("metrics", "acq_score_roofline")
    peaks = {"hbm": 3.35e12, "f64": 34e12, "f64_tc": 67e12}
    # chip_smoke.py's main-shape bound: S=10, A=1024, n=64, d=6: 0.001276 ms
    assert roof.least_s(10, 1024, 64, 6, peaks) * 1e3 == pytest.approx(0.001276, rel=2e-3)
