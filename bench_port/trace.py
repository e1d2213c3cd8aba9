"""The traced window: ``torch.profiler`` over the window's epochs, reduced to
the device's busy time, the device operations that took most time, and the
longest idle gaps labelled by what the host was doing.

Busy time is the union of the intervals of every device event (kernels,
copies, sets) that is not a user annotation. An idle gap is a stretch
between two busy intervals; its label is the innermost host event open at
the gap's middle (an ``aten::`` op, a CUDA runtime call, or the harness's
own ``bench:`` span), prefixed by the harness span open then, or
``python`` where the profiler recorded no host event.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import List, Tuple

import torch

#: the harness's span around each epoch callback in a traced window
CALLBACK_SPAN = "bench:epoch_callback"


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    device_events: int = 0


class Tracer:
    """Start at the window's start, stop at its end (both after the
    device has finished what was queued)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.window_s = 0.0
        self._t0 = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=activities)
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()

    def summary(self, top: int = 10) -> TraceSummary:
        events = list(self.prof.events())
        return reduce(events, self.window_s, top)


def _merge(spans):
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce(events, window_s: float, top: int = 10) -> TraceSummary:
    """Reduce a profiler's events (``FunctionEvent``s, times in us)."""
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events if e.device_type == cuda
              and not e.is_user_annotation]
    host = [e for e in events if e.device_type != cuda]
    busy = _merge((e.time_range.start, e.time_range.end) for e in device)
    busy_us = sum(e - s for s, e in busy)
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + (e.time_range.end - e.time_range.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:top]
    host_spans = sorted((e.time_range.start, e.time_range.end, e.name)
                        for e in host)
    starts = [s for s, _, _ in host_spans]
    labelled = []
    for length, s, e in gaps:
        mid = 0.5 * (s + e)
        open_ = [h for h in host_spans[:bisect.bisect_right(starts, mid)]
                 if h[1] >= mid]
        inner = min(open_, key=lambda h: h[1] - h[0])[2] if open_ \
            else "python"
        outer = "bench:window"
        if any(h[2] == CALLBACK_SPAN for h in open_):
            outer = CALLBACK_SPAN
        labelled.append((f"{outer} > {inner}", length / 1e6))
    return TraceSummary(busy_s=busy_us / 1e6, window_s=window_s,
                        device_ops=[(n, us / 1e6) for n, us in ops],
                        idle_gaps=labelled, device_events=len(device))
