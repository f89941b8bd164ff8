"""Percent of the traced window in which no operation ran on the device:
100 x (1 - the union of the device's intervals / the window)."""


def read(r):
    if r.trace is None or not r.trace.device or not r.trace.window_s:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
