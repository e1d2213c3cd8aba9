"""The train loop: the card's idle between one dispatch's end and the next
one's start within an epoch (the host was late), timed by the program's
CUDA events around each dispatch while traced (``TrainingResult.dispatch``'s
``gap_s``), as a share of the traced window. ``device_idle_pct`` less this
share less the epochs' leads (``epoch_lead_ms``) is the idle inside the
dispatches. None without a trace or where the program does not report it."""


def read(rec):
    t = rec.trace
    gaps = [d.get("gap_s") for d in rec.dispatch]
    if t is None or t.window_s <= 0 or not gaps or None in gaps:
        return None
    return 100.0 * sum(gaps) / t.window_s
