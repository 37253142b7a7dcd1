"""Device idle share (%) of the profiled part of an engine window:
1 - busy / wall, busy being the union of the device's operations in
``torch.profiler``."""


def read(rec):
    dt = rec["tracer"].device_trace
    if dt is None or not dt.ops or dt.window_s <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_s() / dt.window_s)
