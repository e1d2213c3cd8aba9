"""The step runner: a train or eval step body replayed as a CUDA graph — the
port's counterpart of the reference's jitted dispatches.

The reference never launches a step of the main path one operation at a
time: the resident epoch is one jitted ``lax.scan`` and the streaming path
chains ``steps_per_dispatch`` steps into one dispatch. On this card the
counterpart is a CUDA graph of the captured step. :class:`StepRunner`
holds a step body and its static inputs:

- the first call runs the body eagerly on its own inputs: the warm-up,
  which is a training step like any other (it makes the optimizer's state
  and the library workspaces);
- the second call copies its inputs into static buffers and captures the
  body on them with ``torch.cuda.graph`` (a private memory pool; capture
  executes nothing), then replays the graph, which runs that step;
- every later call copies its inputs into the static buffers and replays.

One graph holds one call of the body (one step, or one ``k``-step chain),
replayed once a call: the rolled form of the reference's scan. A call whose
inputs do not fit the static buffers (an epoch's shorter remainder stack, a
ragged tail) runs eagerly. On the CPU the same staging calls the body on
the static buffers directly, so everything but the capture itself runs in
the CPU tests. A capture that fails raises, naming the step and what CUDA
refused; nothing falls back to eager.

The body updates its state in place: the model and optimizer, and the
pass's sums in :class:`Accumulators`. An optimizer whose state a graph
would freeze is made capturable, or refused, by :func:`prepare_optimizer`.

In a training gang the step holds collectives (the gradient's all-reduce,
BatchNorm's statistics). Under ``nccl`` they are captured with the rest:
the fit's first step is eager, and the rank's process group made its
communicator when it joined, so both exist before the capture. Under
``gloo`` no collective can be captured (gloo runs them on the host), so
:func:`graphs_allowed` is false and the estimator calls the step or chain
directly, every step eager — decided from the backend before the fit's
first step, never by a capture that failed.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from raydp_tpu_torch import metrics as rdt_metrics
from raydp_tpu_torch import profiler


def graphs_allowed(in_gang: bool) -> bool:
    """Whether a fit's steps may be captured: not a gang's under ``gloo``,
    whose collectives run on the host."""
    import torch.distributed as dist

    return not (in_gang and dist.get_backend() == "gloo")


def prepare_optimizer(optimizer: torch.optim.Optimizer, graphed: bool) -> None:
    """Make ``optimizer`` safe to capture (called on CUDA before its first
    step, so its state is made on the device).

    - An optimizer with a ``capturable`` option (Adam and most others) gets
      it in every param group: its step counters and step sizes then live
      on the device. Eager steps run the same arithmetic, so eager and
      graphed fits agree.
    - ``torch.optim.Adagrad`` has none: it keeps its step counters on the
      host and derives its step size from them there. With ``lr_decay=0``
      the size is ``lr`` at every step, so a replayed update is right and
      :class:`StepRunner` advances the host counters by the replays;
      another ``lr_decay`` would freeze the size at capture, and raises.
    - ``torch.optim.SGD`` keeps no host state.
    - Any other optimizer raises, named, when the fit would capture
      (``graphed``)."""
    groups = optimizer.param_groups
    if all("capturable" in g for g in groups):
        for g in groups:
            g["capturable"] = True
        # the eager warm-up step is expected; torch would warn once that a
        # capturable optimizer steps outside a capture
        optimizer._warned_capturable_if_run_uncaptured = True
        return
    if not graphed or isinstance(optimizer, torch.optim.SGD):
        return
    name = type(optimizer).__name__
    if isinstance(optimizer, torch.optim.Adagrad):
        decays = sorted({g["lr_decay"] for g in groups if g["lr_decay"]})
        if decays:
            raise ValueError(
                f"{name}(lr_decay={decays[0]}) cannot be captured into a CUDA "
                f"graph: it computes each step size on the host from its "
                f"step counter, which a replay does not run; use "
                f"lr_decay=0 or an optimizer with a capturable option")
        return
    raise ValueError(
        f"{name} cannot be captured into a CUDA graph: it has no "
        f"'capturable' option, and the port does not know its host state; "
        f"use an optimizer with one (Adam, AdamW, RMSprop, ...), Adagrad "
        f"with lr_decay=0, or SGD")


def _host_step_counters(optimizer) -> List[torch.Tensor]:
    """The optimizer's step counters kept on the host for parameters on the
    card (Adagrad's): a replay does not advance them."""
    if optimizer is None:
        return []
    return [s["step"] for p, s in optimizer.state.items()
            if p.device.type == "cuda"
            and isinstance(s.get("step"), torch.Tensor)
            and s["step"].device.type == "cpu"]


class Accumulators:
    """A pass's sums on the device, updated in place so that a captured step
    adds into the same tensors at every replay: the loss sum, the row count
    (eval), and each metric's statistics."""

    def __init__(self, metrics: Sequence, device: torch.device,
                 count: bool = False):
        self.metrics = list(metrics)
        self.loss = torch.zeros((), dtype=torch.float32, device=device)
        self.count = torch.zeros((), dtype=torch.float32, device=device) \
            if count else None
        self.stats = tuple(
            {k: torch.tensor(np.asarray(v, np.float32), device=device)
             for k, v in m.init().items()} for m in self.metrics)

    def reset(self) -> None:
        """Back to the metrics' initial values (at a pass's start)."""
        self.loss.zero_()
        if self.count is not None:
            self.count.zero_()
        for m, s in zip(self.metrics, self.stats):
            for k, v in m.init().items():
                s[k].copy_(torch.as_tensor(np.asarray(v, np.float32)))

    def update(self, loss, stats, count=None) -> None:
        """Store a step's new sums (what the functional step returned)."""
        self.loss.copy_(loss)
        if count is not None:
            self.count.copy_(count)
        for s, new in zip(self.stats, stats):
            for k, t in s.items():
                t.copy_(new[k])


class StepRunner:
    """See the module docstring. ``body(inputs)`` runs one call's steps on
    ``inputs`` (a dict of tensors, maybe empty: a resident step reads its
    batch through :class:`~raydp_tpu_torch.data.feed.ResidentEpoch`'s
    static index state). ``label`` names the step in errors. ``optimizer``
    is the one the body steps (its host step counters advance with the
    replays). ``span``, when set, names the profiler span that times the
    capture, and the capture then publishes the step's activation bytes
    (``train_activation_bytes_per_process``: the bytes the graph's private
    memory pool reserves, the growth of ``torch.cuda.memory_reserved``
    across the capture, in whole allocator segments). ``quiesce``, a lock
    (the streaming feed's ``placement_lock``), is held through the capture
    so that no other thread of the process makes a CUDA call meanwhile.

    Counters: ``replays`` (calls served from the static buffers: graph
    replays on CUDA, direct calls on the CPU) and ``replayed_steps``, the
    optimizer steps they ran; ``eager_steps``, the steps of calls run on
    their own inputs (the warm-up, and calls of another shape);
    ``capture_s``, the capture's wall."""

    def __init__(self, body: Callable[[Dict[str, torch.Tensor]], None],
                 device: torch.device, label: str,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 span: Optional[str] = None, quiesce=None):
        self.body = body
        self.device = device
        self.label = label
        self.optimizer = optimizer
        self.span = span
        self.quiesce = quiesce
        self.graphed = device.type == "cuda"
        self.replays = 0
        self.replayed_steps = 0
        self.eager_steps = 0
        self.capture_s = 0.0
        self._static: Optional[Dict[str, torch.Tensor]] = None
        self._graph = None
        self._host_steps: List[torch.Tensor] = []
        self._pending_steps = 0

    def __call__(self, inputs: Dict[str, torch.Tensor],
                 n_steps: int = 1) -> None:
        """Run one call of the body; ``n_steps`` is how many optimizer
        steps it takes (the host step counters' advance per replay)."""
        if self._static is None:
            if self.eager_steps == 0:
                self.body(inputs)      # the warm-up: the fit's first step
                self.eager_steps += n_steps
                return
            self._static = {n: t.clone() for n, t in inputs.items()}
            if self.graphed:
                self._capture()
        elif not self._fits(inputs):
            self.body(inputs)
            self.eager_steps += n_steps
            return
        else:
            for n, t in inputs.items():
                self._static[n].copy_(t)
        if self._graph is not None:
            self._graph.replay()
            self._pending_steps += n_steps
        else:
            self.body(self._static)
        self.replays += 1
        self.replayed_steps += n_steps

    def _fits(self, inputs) -> bool:
        static = self._static
        return inputs.keys() == static.keys() and all(
            t.shape == static[n].shape and t.dtype == static[n].dtype
            for n, t in inputs.items())

    def _capture(self) -> None:
        # capture runs the body's host code once: a host step counter it
        # advances is restored, and advanced again by each replay instead
        self._host_steps = _host_step_counters(self.optimizer)
        saved = [t.clone() for t in self._host_steps]
        # what the capture allocates lands in the graph's own new pool: its
        # growth of the reserved bytes is that pool, the step's activations
        # and temporaries (the process's peak statistics stay untouched)
        before = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with profiler.trace(self.span, "training") if self.span \
                    else contextlib.nullcontext(), \
                    self.quiesce or contextlib.nullcontext():
                # thread-local: a benign CUDA call of another thread (the
                # runtime's, an allocator's release) does not void it
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    self.body(self._static)
        except RuntimeError as e:
            raise RuntimeError(
                f"CUDA graph capture of the {self.label} failed: {e}") from e
        self.capture_s = time.perf_counter() - t0
        for t, v in zip(self._host_steps, saved):
            t.copy_(v)
        if self.span:
            rdt_metrics.set_gauge(
                "train_activation_bytes_per_process",
                torch.cuda.memory_reserved(self.device) - before)
        self._graph = graph

    def flush(self) -> None:
        """Advance the host step counters by the optimizer steps the
        replays ran since the last flush (call before the optimizer's state
        is read: a checkpoint, the fit's end)."""
        if self._pending_steps:
            for t in self._host_steps:
                t.add_(self._pending_steps)
            self._pending_steps = 0
