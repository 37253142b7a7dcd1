"""Train entry: the card memory the process holds over the window
(``torch.cuda.max_memory_reserved()``, the peak reset at the end of set-up;
a captured step's activations live in the graph's private pool, which only
the reserved count sees), GB of 1e9 bytes."""


def read(rec):
    return rec["memory_peak_bytes"] / 1e9 if rec.get("memory_peak_bytes") else None
