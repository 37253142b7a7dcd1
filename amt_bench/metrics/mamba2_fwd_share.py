"""Mamba-2 mixer (``models/mamba2.py``): the mixers' share (%) of the device
time of the traced run's eager forward of one microbatch (the record's
``forward``): the device time of the operations that start inside a
``mamba2.mixer`` span (as ``ssd_roofline`` attributes them) over that of
all the forward's operations. A run with no device trace, or a program
without the span, reads nothing."""

from amt_bench import harness


def read(rec):
    fwd = rec.get("forward")
    if not fwd or fwd.get("trace") is None or not fwd["trace"].ops:
        return None
    spans = [s for s in fwd["spans"] if s["name"] == "mamba2.mixer"]
    if not spans:
        return None
    inside = harness.load_module("metrics", "ssd_roofline").device_s_inside(fwd["trace"], spans)
    total = sum(d for _, _, d in fwd["trace"].ops) / 1e6
    return 100.0 * inside / total
