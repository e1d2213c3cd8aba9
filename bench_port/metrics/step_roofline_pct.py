"""The kernels under the step: the least time of the traced window's steps,
each ``max(FLOPs / peak, bytes / bandwidth)`` (``counts.py``, bytes counted
from the batch), over the device's busy time in the trace."""


def read(rec):
    t = rec.trace
    if t is None or rec.peaks is None or t.busy_s <= 0 \
            or not rec.traced_bytes:
        return None
    peak = rec.peaks["flops"][rec.config["compute_dtype"]]
    bandwidth = rec.peaks["bytes_per_s"]
    least = sum(max(rec.step_flops / peak, b / bandwidth)
                for b in rec.traced_bytes)
    return 100.0 * least / t.busy_s
