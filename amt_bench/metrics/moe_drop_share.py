"""MoE experts (``models/mlp.py``): the share (%) of the (token, choice)
pairs routed to the experts held here that capacity drops, in the traced
run's eager forward of one microbatch (the record's ``forward``): the
counters ``moe.pairs_dropped`` over ``moe.pairs_held``, summed over the
layers. A program without the counters reads nothing."""


def read(rec):
    fwd = rec.get("forward")
    if not fwd:
        return None
    counters = fwd["counters"]
    held = counters.get("moe.pairs_held")
    if not held:
        return None
    return 100.0 * counters.get("moe.pairs_dropped", 0) / held
