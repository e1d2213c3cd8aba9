"""The device: 100 × (1 − busy / window) over the traced window, busy being
the union of its kernel and copy intervals in the ``torch.profiler``
trace."""


def read(rec):
    t = rec.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
