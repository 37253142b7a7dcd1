"""95th percentile (ms) of every ``suggest_batch`` call in the window:
the order statistics of all calls (numpy's linear interpolation), not of
chunks."""

import numpy as np


def read(rec):
    return float(np.percentile(rec["call_ms"], 95)) if rec.get("call_ms") else None
