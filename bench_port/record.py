"""What a run hands the metric readers."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from bench_port.trace import TraceSummary


@dataclass
class Record:
    workload: str
    config: Dict
    mix: Dict
    #: ``resident`` or ``stream``: the path the program's fit took
    path: str
    setup_s: float
    #: the window: its wall time, the samples its steps took, and each of
    #: its epochs' report and dispatch record
    window_s: float
    window_samples: int
    epochs: List[Dict] = field(default_factory=list)
    dispatch: List[Dict] = field(default_factory=list)
    peak_bytes: int = 0
    #: the traced window (``--trace 1``), its steps, each step's FLOPs and
    #: each traced step's bytes (``counts.py``), and the device's peaks
    trace: Optional[TraceSummary] = None
    traced_steps: int = 0
    step_flops: float = 0.0
    traced_bytes: List[float] = field(default_factory=list)
    peaks: Optional[Dict] = None
