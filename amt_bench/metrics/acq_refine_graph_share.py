"""Anchor scoring + refinement (``core/optimize_acq.py``): refinements
replayed from a CUDA graph over all refinements of the window, from the
counters ``acq.refine.graph.replay``, ``acq.refine.graph.capture`` (a
capture and its eager warm-ups) and ``acq.refine.eager`` (%). A program
without the counters reads nothing."""


def read(rec):
    c = rec["tracer"].counters
    replay = c.get("acq.refine.graph.replay", 0)
    total = replay + c.get("acq.refine.graph.capture", 0) + c.get("acq.refine.eager", 0)
    if total == 0:
        return None
    return 100.0 * replay / total
