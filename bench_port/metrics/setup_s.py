"""From the process's start to the end of the warm-up epoch (epoch 0: data,
model, weights, the resident copy or the feed's first pass, the eager step
and the capture), host clock."""


def read(rec):
    return rec.setup_s
