"""Seconds from the process's start to the first timed call: imports,
kernel libraries loaded (or built), weights or warm-up."""


def read(rec):
    return rec["setup_s"]
