"""Anchor scoring (``core/optimize_acq.py::_refine_and_rank``): the summed
``acq.anchors`` spans outside the profiled part over its GP decisions (ms),
each span the fused anchor sweep and its top-k, waited for on the card. A
program without the span reads nothing."""


def read(rec):
    spans = rec["tracer"].spans_outside_profile()
    decisions = sum(1 for s in spans if s["name"] == "suggest.posterior")
    stage = [s["dur"] for s in spans if s["name"] == "acq.anchors"]
    if not decisions or not stage:
        return None
    return sum(stage) * 1e3 / decisions
