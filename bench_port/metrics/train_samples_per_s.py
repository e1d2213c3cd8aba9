"""All samples of all steps the window's epochs completed, over the window's
wall time (host clock, from the end of the warm-up epoch to the end of the
last epoch that fits in ``--seconds``)."""


def read(rec):
    if rec.window_s <= 0:
        return None
    return rec.window_samples / rec.window_s
