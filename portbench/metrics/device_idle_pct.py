"""Share of the window with no kernel and no copy on the card: the window
less the union of the device's intervals, over the window."""


def read(trace):
    w = trace.window_s
    return 100.0 * (w - trace.busy_s()) / w if w > 0 else None
