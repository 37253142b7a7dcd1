"""Operations the refinement launches (``core/optimize_acq.py``): the device
operations of the profiled part (kernels, copies, fills) whose start, on the
spans' clock (``DeviceTrace.to_mono``), lies inside an ``acq.refine`` span,
edges included, over the profiled part's GP decisions. The span waits for
the card before it closes, so what it launched has started by then. A run
with no profiled part, or a program without the span, reads nothing."""

import bisect


def read(rec):
    tracer = rec["tracer"]
    dt = tracer.device_trace
    if dt is None:
        return None
    spans = tracer.spans_in_profile()
    decisions = sum(1 for s in spans if s["name"] == "suggest.posterior")
    refine = sorted((s["t0"], s["t1"]) for s in spans if s["name"] == "acq.refine")
    if not decisions or not refine:
        return None
    starts = [t0 for t0, _ in refine]
    inside = 0
    for _, start_us, _ in dt.ops:
        t = start_us / 1e6 + dt.to_mono
        i = bisect.bisect_right(starts, t) - 1  # the last span opened by t
        if i >= 0 and t <= refine[i][1]:
            inside += 1
    return inside / decisions
