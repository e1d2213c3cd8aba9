"""The device feed (``data/feed.py`` ``DeviceFeed``): the train loop's wait
for its next batch, ``feed_time_s`` summed over the window's epochs, per
step. Streaming cells only."""


def read(rec):
    steps = sum(h["steps"] for h in rec.epochs)
    if rec.path != "stream" or not steps:
        return None
    return 1e3 * sum(h["feed_time_s"] for h in rec.epochs) / steps
