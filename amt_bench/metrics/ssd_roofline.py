"""Mamba-2 mixer (``models/mamba2.py``): the SSD scan's share of its
roofline (%) in the traced run's eager forward of one microbatch (the
record's ``forward``): the least time of the scan's work, summed over the
``mamba2.ssd`` spans (one a Mamba-2 layer), over the device time of the
operations that start inside them, edges included (the span waits for the
card as it opens and as it closes; starts are mapped onto the spans' clock
by ``DeviceTrace.to_mono``).

The work is frozen here, the same whatever implements the scan: for T
tokens of a layer with H heads of P channels, a state of N, G groups and
chunks of L (``mamba_chunk_size``), the chunked form's products — C·Bᵀ and
its product with Δx over the causal half of each chunk, 2·(L/2)·(G·N +
H·P) a token, the chunk states and their read-out, 2 · 2·H·P·N a token — at
the bf16 peak; and its bytes, each read or written once: x, B and C in
bf16, Δ in float32, A, and y in float32. The least time is the larger of
the two. A run with no device trace, or a program without the span, reads
nothing."""

import bisect

from amt_bench.peaks import peaks_of


def least_s(conf: dict, tokens: int, peaks: dict) -> float:
    h, p, n, g = (conf["mamba_n_heads"], conf["mamba_d_head"], conf["mamba_d_state"],
                  conf["mamba_n_groups"])
    half = conf["mamba_chunk_size"] / 2
    flops = tokens * (2 * half * (g * n + h * p) + 2 * 2 * h * p * n)
    nbytes = tokens * (2 * h * p + 4 * h + 2 * 2 * g * n + 4 * h * p) + 4 * h
    return max(flops / peaks["bf16"], nbytes / peaks["hbm"])


def device_s_inside(trace, spans) -> float:
    """Device seconds of the operations of ``trace`` that start inside one
    of ``spans`` (edges included)."""
    windows = sorted((s["t0"], s["t1"]) for s in spans)
    starts = [t0 for t0, _ in windows]
    inside = 0.0
    for _, start_us, dur_us in trace.ops:
        t = start_us / 1e6 + trace.to_mono
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= windows[i][1]:
            inside += dur_us / 1e6
    return inside


def read(rec):
    fwd = rec.get("forward")
    if not fwd or fwd.get("trace") is None:
        return None
    spans = [s for s in fwd["spans"] if s["name"] == "mamba2.ssd"]
    if not spans:
        return None
    device_s = device_s_inside(fwd["trace"], spans)
    if device_s <= 0:
        return None
    least = len(spans) * least_s(rec["conf"], fwd["tokens"], peaks_of(rec["device_name"]))
    return 100.0 * least / device_s
