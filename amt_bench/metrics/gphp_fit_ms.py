"""GPHP refit (``core/gp/fit.py`` -> ``kernels/slice_chain``): the summed
``suggest.gphp_fit`` spans of the window over its GP decisions (ms), so a
decision that adopts pooled samples counts 0."""


def read(rec):
    spans = rec["tracer"].spans_outside_profile()
    decisions = sum(1 for s in spans if s["name"] == "suggest.posterior")
    if not decisions:
        return None
    return sum(s["dur"] for s in spans if s["name"] == "suggest.gphp_fit") * 1e3 / decisions
