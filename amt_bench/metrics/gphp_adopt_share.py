"""Service (``core/service.py``: ``GPHPSamplePool``): adoptions over
adoptions plus refits, from the counters ``suggest.gphp.adopt`` and
``suggest.gphp.refit`` (%)."""


def read(rec):
    c = rec["tracer"].counters
    adopt, refit = c.get("suggest.gphp.adopt", 0), c.get("suggest.gphp.refit", 0)
    if adopt + refit == 0:
        return None
    return 100.0 * adopt / (adopt + refit)
