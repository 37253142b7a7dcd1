"""Kernels (``kernels/acq_score``, ``csrc/acq_score.cu``): the least time of
the profiled part's ``acq_score`` launches over their device time (%).

Each GP decision's slot scores its anchors in one call and re-ranks the
refined points in a second; both score over the decision's live rows (its
observations, its trials in flight and the slot's earlier picks, all folded
in by the constant liar). The shapes come from the ``suggest.decide`` and
``suggest.acq_opt`` spans. A call's operations and bytes are those of
``chip_smoke.py`` (commit 34e7d4a), counted over the live rows and the
unpadded features: the lower-triangular product L⁻¹K*ᵀ at the FP64
tensor-core peak, the warp, distances, Matérn, μ and ‖v‖² at the FP64 peak,
and each input and output byte once. The least time is the larger of the
two bounds. Device time: the kernels of ``acq_score.cu`` and of the walk
they share (``acq_walk.cuh``)."""

import re

from amt_bench.peaks import peaks_of

KERNELS = re.compile(r"acq_score_kernel|combine_kernel|repro::walk::")


def least_s(S: int, A: int, nl: int, d: int, peaks: dict) -> float:
    nbytes = 8 * (A * d + nl * d + S * nl * (nl + 1) // 2 + S * nl + nl + 4 * S * d + S + S * A)
    tri = S * A * nl * (nl + 1)
    rest = S * A * nl * (3 * d + 14) + S * (A + nl) * d * 12
    return max(nbytes / peaks["hbm"], tri / peaks["f64_tc"] + rest / peaks["f64"])


def read(rec):
    tracer = rec["tracer"]
    dt = tracer.device_trace
    if dt is None:
        return None
    device_s = dt.time_of(KERNELS)
    if device_s <= 0:
        return None
    conf = rec["conf"]
    d = len(conf["space"])
    sl = conf["engine"]["slice"]
    S = max(1, (sl["num_samples"] - sl["burn_in"]) // sl["thin"])
    acq = conf["engine"]["acq"]
    peaks = peaks_of(rec["device_name"])
    spans = tracer.spans_in_profile()
    by_id = {s["span_id"]: s for s in spans}
    least = 0.0
    for s in spans:
        if s["name"] != "suggest.acq_opt":
            continue
        decide = by_id.get(s["parent_id"])
        if decide is None:
            continue
        a = decide["attrs"]
        nl = a["n"] + a["pending"] + s["attrs"]["slot"]
        least += least_s(S, acq["num_anchors"], nl, d, peaks)
        least += least_s(S, acq["num_refine"], nl, d, peaks)
    return 100.0 * least / device_s if least > 0 else None
