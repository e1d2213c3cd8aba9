"""Host batches (``data/feed.py`` ``HostBatchIterator``, ``native/stage.py``):
``decode_time_s`` summed over the window's epochs, per step, measured on
the feed's thread and overlapped with the steps. Streaming cells only."""


def read(rec):
    steps = sum(h["steps"] for h in rec.epochs)
    if rec.path != "stream" or not steps:
        return None
    return 1e3 * sum(h["decode_time_s"] for h in rec.epochs) / steps
