"""The share of the traced window in which no operation ran on the device:
1 - (union of the device events' intervals) / (the window's host time)."""


def read(t):
    if not t.kernels or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
