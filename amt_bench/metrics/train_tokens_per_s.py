"""Tokens of every training step completed in the window over the window's
seconds (the last step waited for)."""


def read(rec):
    return rec["tokens"] / rec["window_s"] if rec.get("steps") else None
