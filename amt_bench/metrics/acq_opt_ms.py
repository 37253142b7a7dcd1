"""Anchor scoring and refinement (``core/optimize_acq.py``): the summed
``suggest.acq_opt`` spans of the window over its GP decisions (ms)."""


def read(rec):
    spans = rec["tracer"].spans_outside_profile()
    decisions = sum(1 for s in spans if s["name"] == "suggest.posterior")
    if not decisions:
        return None
    return sum(s["dur"] for s in spans if s["name"] == "suggest.acq_opt") * 1e3 / decisions
