"""The refit's draw table (``core/gp/slice_sampler.py::chain_draws``, on the
host): the summed ``gphp.draws`` spans outside the profiled part over its GP
decisions (ms), so a decision that adopts pooled samples counts 0, as in
``gphp_fit_ms``. A window that refits under a program without the span
reads nothing."""


def read(rec):
    spans = rec["tracer"].spans_outside_profile()
    decisions = sum(1 for s in spans if s["name"] == "suggest.posterior")
    if not decisions:
        return None
    draws = [s["dur"] for s in spans if s["name"] == "gphp.draws"]
    if not draws and any(s["name"] == "suggest.gphp_fit" for s in spans):
        return None
    return sum(draws) * 1e3 / decisions
