"""Median wall time (ms) of every ``suggest_batch`` call in the window."""

import statistics


def read(rec):
    return statistics.median(rec["call_ms"]) if rec.get("call_ms") else None
