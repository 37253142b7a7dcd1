"""The readers of the spans inside the decision (``acq_anchor_ms``,
``acq_refine_ms``, ``acq_refine_ops``, ``gphp_draws_ms``) compute what
their manifest rows say, on synthetic spans and a synthetic device trace."""

import pytest

from amt_bench import harness
from amt_bench.harness import DeviceTrace, Tracer
from bench_sizes import ENGINE, ENGINE_CONF

SPAN_METRICS = ("acq_anchor_ms", "acq_refine_ms", "gphp_draws_ms")
PROFILE = (100.0, 106.0)  # the profiled part, on the spans' clock (s)


def read(name, tracer):
    return harness.load_module("metrics", name).read({"tracer": tracer})


def span(name, t0, t1):
    return {"name": name, "t0": t0, "t1": t1, "dur": t1 - t0}


def tracer(spans, ops=None, to_mono=0.0):
    tr = Tracer(profile_seconds=6.0, device_kind="cpu")
    tr.spans = spans
    tr.prof_t = PROFILE
    if ops is not None:
        tr.device_trace = DeviceTrace(ops, window_s=PROFILE[1] - PROFILE[0])
        tr.device_trace.to_mono = to_mono
    return tr


def decision(t, anchors, refine, draws=None):
    """One GP decision's spans, its refinement from ``t`` on: a refit when
    ``draws`` is given, an adoption otherwise."""
    t_post = t - 0.02
    out = [span("suggest.posterior", t_post, t_post + 0.01)]
    if draws is not None:
        out += [span("suggest.gphp_fit", t_post, t_post + 0.009),
                span("gphp.draws", t_post, t_post + draws)]
    return out + [span("suggest.acq_opt", t - 0.01, t + refine + 0.01),
                  span("acq.anchors", t - 0.01, t - 0.01 + anchors),
                  span("acq.refine", t, t + refine)]


def test_span_readers_sum_outside_the_profile_over_gp_decisions():
    spans = (decision(10.0, 0.001, 0.100, draws=0.004) + decision(20.0, 0.002, 0.120)
             # inside the profiled part: left out
             + decision(102.0, 1.0, 1.0, draws=0.5)
             # across its edge: in neither part
             + [span("acq.refine", 99.5, 100.5)])
    tr = tracer(spans)
    assert read("acq_anchor_ms", tr) == pytest.approx(1.5)
    assert read("acq_refine_ms", tr) == pytest.approx(110.0)
    # the adoption counts 0
    assert read("gphp_draws_ms", tr) == pytest.approx(2.0)


def test_span_readers_without_a_gp_decision_read_nothing():
    spans = [span("suggest.decide", 1.0, 1.1), span("acq.anchors", 1.0, 1.01),
             span("acq.refine", 1.0, 1.05), span("gphp.draws", 1.0, 1.002)]
    for name in SPAN_METRICS:
        assert read(name, tracer(spans)) is None


def test_span_readers_on_a_program_without_the_spans():
    """A program whose stages are not spans: GP decisions and refits only."""
    spans = [span("suggest.posterior", 1.0, 1.01), span("suggest.gphp_fit", 1.0, 1.009),
             span("suggest.acq_opt", 1.01, 1.2)]
    for name in SPAN_METRICS:
        assert read(name, tracer(spans)) is None
    # a window of adoptions only has no draw table to time: 0, not nothing
    adopt = [span("suggest.posterior", 1.0, 1.01), span("acq.refine", 1.02, 1.1)]
    assert read("gphp_draws_ms", tracer(adopt)) == 0.0


def test_refine_ops_count_starts_inside_refine_spans_edges_included():
    # two GP decisions in the profiled part, refinement at [101, 101.5] and
    # [103, 103.25] on the spans' clock; the profiler's clock is 5 s behind
    spans = (decision(101.0, 0.005, 0.5) + decision(103.0, 0.005, 0.25)
             + decision(10.0, 0.001, 0.1))  # outside the profiled part: left out
    starts = [96.0, 96.25, 96.5,  # 101.0 (an edge), inside, 101.5 (an edge)
              95.9999, 96.5001,   # just outside
              97.5,               # between the spans
              98.0, 98.25,        # 103.0, 103.25: the second span's edges
              98.3]               # after it
    ops = [(f"k{i}", s * 1e6, 3.0) for i, s in enumerate(starts)]
    assert read("acq_refine_ops", tracer(spans, ops, to_mono=5.0)) == pytest.approx(5 / 2)
    # read without the clocks' offset, no start falls inside
    assert read("acq_refine_ops", tracer(spans, ops, to_mono=0.0)) == 0.0


def test_refine_ops_without_a_profile_or_a_gp_decision_read_nothing():
    spans = decision(101.0, 0.005, 0.5)
    assert read("acq_refine_ops", tracer(spans)) is None  # no profiled part
    ops = [("k", 96.1e6, 1.0)]
    no_gp = [span("suggest.decide", 101.0, 101.6), span("acq.refine", 101.0, 101.5)]
    assert read("acq_refine_ops", tracer(no_gp, ops, to_mono=5.0)) is None
    no_span = [s for s in spans if s["name"] != "acq.refine"]
    assert read("acq_refine_ops", tracer(no_span, ops, to_mono=5.0)) is None


def test_a_traced_cpu_run_reports_the_span_readers():
    """On the CPU the run has no profiled part: the three span readers read
    values and the device-trace reader nothing."""
    from amt_bench import run

    result, _ = run.run_cell("amt-xgb6.shared8", 2**31 + 977, 3.0, True, device="cpu",
                             overrides=ENGINE, conf_overrides=ENGINE_CONF)
    assert result["correct"] is True
    metrics = result["metrics"]
    for name in SPAN_METRICS:
        assert metrics[name]["value"] >= 0.0, name
    assert metrics["acq_refine_ms"]["value"] > 0.0
    assert metrics["acq_opt_ms"]["value"] >= (metrics["acq_anchor_ms"]["value"]
                                              + metrics["acq_refine_ms"]["value"])
    assert metrics["gphp_fit_ms"]["value"] >= metrics["gphp_draws_ms"]["value"]
    assert "acq_refine_ops" not in metrics
