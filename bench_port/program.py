"""How the benchmark drives the program: ``TorchEstimator.fit`` over an
in-process ``TableDataset``, with the seed's weights written into the
port's model, the first steps read out for the correctness check, and the
fit stopped at the end of the measured window.

- :func:`write_weights` draws every parameter from the seed in place
  (``reference/weights.py``, which the reference draws from too).
- :class:`Readout` reads the program's first steps while epoch 0, the
  warm-up, runs them (:func:`checked_steps`: through the first two replays
  of a one-step call, through the first replay of a chain, so the compared
  state always comes out of a replay): each step's loss (the tensor the
  estimator's loss returned, kept by reference), the predictions the loss
  got at step 1, every leaf's gradient norm as the optimizer gets it at
  step 1 (an optimizer pre-hook), and every leaf's change after the last
  checked step, against the seed's weights drawn again chunk by chunk. An
  eager step ends in the optimizer's post-hook; a call the step runner
  replays as a CUDA graph runs no Python, so while the readout is open it
  also wraps ``torch.cuda.CUDAGraph.replay`` to read after each replay
  (the loss of a chain's last step; its earlier steps' losses are not
  read). Hooks and wrapper are gone before the window opens, and add
  nothing to a graph (inside a capture they do nothing).
- :class:`Window` is the estimator's epoch callback: epoch 0's report ends
  the set-up; each later report ends an epoch of the window; the report of
  the last epoch that fits in ``seconds`` sets the fit's ``num_epochs`` to
  that epoch, so the loop ends after it without writing a checkpoint.
"""

from __future__ import annotations

import math
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench_port import spec
from bench_port.reference.common import Trajectory, moved_rows
from bench_port.reference.weights import Leaf, chunks, fill_chunk


def write_weights(model: torch.nn.Module, leaves: List[Leaf],
                  seed: int) -> Dict[str, torch.nn.Parameter]:
    """Draw the seed's weights into the model's parameters, which must be
    exactly the leaves, by name and shape."""
    params = dict(model.named_parameters())
    want = {leaf[0]: tuple(leaf[1]) for leaf in leaves}
    have = {n: tuple(p.shape) for n, p in params.items()}
    if want != have:
        raise ValueError(f"the program's parameters {have} are not the "
                         f"configuration's leaves {want}")
    with torch.no_grad():
        for index, leaf in enumerate(leaves):
            p = params[leaf[0]].data
            view = p if p.dim() else p.view(1)
            for c, start, stop in chunks(leaf[1]):
                fill_chunk(view[start:stop], leaf, index, c, seed)
    return params


#: epochs a traced run's window holds
TRACE_EPOCHS = 2


def chain_steps(mix: Dict) -> int:
    """Optimizer steps one call of the step runner takes in ``mix``."""
    return int(mix.get("steps_per_dispatch", 1))


def checked_steps(mix: Dict) -> int:
    """Steps the check follows: the step runner's first call runs eager,
    its second is captured and replayed; a one-step call is followed
    through its second replay, a chain of ``k`` through its first (``2k``
    steps)."""
    return max(3, 2 * chain_steps(mix))


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class Readout:
    """See the module docstring. ``steps``: the steps read
    (:func:`checked_steps`); ``steps_per_replay``: the optimizer steps one
    call of the step runner takes (:func:`chain_steps`)."""

    def __init__(self, params: Dict[str, torch.nn.Parameter],
                 leaves: List[Leaf], seed: int, steps: int,
                 steps_per_replay: int):
        self.params = params
        self.leaves = leaves
        self.seed = seed
        self.steps = steps
        self.steps_per_replay = steps_per_replay
        self.trajectory = Trajectory()
        self.error: Optional[str] = None
        self.done = False
        self._loss: Optional[torch.Tensor] = None
        self._taken = 0
        self._hooks = []
        self._replay = None

    def loss(self, base: Callable) -> Callable:
        """The estimator's loss: ``base``, keeping a detached view of what it
        returns (no device work; holding the loss itself would keep the
        step's autograd graph alive into the capture)."""

        def loss_fn(preds, labels, mask=None):
            value = base(preds, labels) if mask is None \
                else base(preds, labels, mask=mask)
            self._loss = value.detach()
            if self.trajectory.first_preds is None and not _capturing():
                self.trajectory.first_preds = preds.detach().clone()
            return value

        return loss_fn

    def attach(self, optimizer: torch.optim.Optimizer) -> None:
        self._hooks = [optimizer.register_step_pre_hook(self._pre),
                       optimizer.register_step_post_hook(self._post)]
        if torch.cuda.is_available():
            original = torch.cuda.CUDAGraph.replay
            readout = self

            def replay(graph):
                original(graph)
                readout._replayed()

            self._replay = original
            torch.cuda.CUDAGraph.replay = replay

    def close(self) -> None:
        """Remove the hooks and the wrapper (idempotent)."""
        for h in self._hooks:
            h.remove()
        self._hooks = []
        if self._replay is not None:
            torch.cuda.CUDAGraph.replay = self._replay
            self._replay = None
        if not self.done and self.error is None:
            self.error = (f"the fit's warm-up ran {self._taken} of the "
                          f"{self.steps} steps the check reads")
        self._loss = None

    def _pre(self, optimizer, args, kwargs) -> None:
        if self.done or _capturing() or self._taken:
            return
        self.trajectory.grad_norms = {
            n: float(p.grad.norm()) if p.grad is not None else 0.0
            for n, p in self.params.items()}

    def _post(self, optimizer, args, kwargs) -> None:
        if self.done or _capturing():
            return
        self._steps_ended(1)

    def _replayed(self) -> None:
        if self.done:
            return
        torch.cuda.synchronize()
        self._steps_ended(self.steps_per_replay)

    def _steps_ended(self, n: int) -> None:
        # a replayed chain runs no Python between its steps: only its last
        # step's loss is read
        self.trajectory.losses.extend([None] * (n - 1))
        self.trajectory.losses.append(float(self._loss))
        self._taken += n
        if self._taken > self.steps:
            self.error = (f"the fit's step runner ran past the {self.steps} "
                          f"checked steps (to step {self._taken})")
            self.close()
        elif self._taken == self.steps:
            self.trajectory.change_norms, self.trajectory.moved_rows = \
                self._changes()
            self.done = True
            self.close()

    @torch.no_grad()
    def _changes(self):
        """Each leaf's change norm and moved rows since the seed's
        weights."""
        norms, moved = {}, {}
        for index, leaf in enumerate(self.leaves):
            p = self.params[leaf[0]].detach()
            view = p if p.dim() else p.view(1)
            sq, rows = 0.0, 0
            for c, start, stop in chunks(leaf[1]):
                part = view[start:stop]
                start_value = fill_chunk(torch.empty_like(part), leaf, index,
                                         c, self.seed)
                sq += float(torch.linalg.vector_norm(part - start_value)) ** 2
                rows += moved_rows(part, start_value)
            norms[leaf[0]] = math.sqrt(sq)
            moved[leaf[0]] = rows
        return norms, moved


class Window:
    """See the module docstring. With a ``tracer``, the window is
    :data:`TRACE_EPOCHS` epochs (the tracer starts at its start and stops at
    its end)."""

    def __init__(self, estimator, seconds: float, readout: Readout,
                 tracer=None):
        self.estimator = estimator
        self.seconds = float(seconds)
        self.readout = readout
        self.tracer = tracer
        #: when the program's import and build began, when the fit was
        #: called, and when its warm-up epoch ended
        self.build_start: Optional[float] = None
        self.fit_start: Optional[float] = None
        self.setup_end: Optional[float] = None
        self.t0: Optional[float] = None
        #: ``(epoch, end time)`` of each epoch after the warm-up
        self.ends: List = []
        self.stopped = False

    def __call__(self, report: Dict) -> None:
        from bench_port.trace import CALLBACK_SPAN

        now = time.perf_counter()
        with torch.profiler.record_function(CALLBACK_SPAN):
            self._epoch_ended(int(report["epoch"]), now)

    def _epoch_ended(self, epoch: int, now: float) -> None:
        if self.stopped:
            raise RuntimeError(f"the fit ran epoch {epoch} after the window "
                               f"closed")
        if epoch == 0:
            self.readout.close()
            self.setup_end = now
            if self.seconds <= 0:
                self._stop(epoch)
                return
            if self.tracer is not None:
                self.tracer.start()
            self.t0 = time.perf_counter()
            return
        self.ends.append((epoch, now))
        times = [self.t0] + [t for _, t in self.ends]
        longest = max(b - a for a, b in zip(times[:-1], times[1:]))
        if self.tracer is not None:
            done = len(self.ends) >= TRACE_EPOCHS
        else:
            done = now - self.t0 + longest > self.seconds
        if done:
            if self.tracer is not None:
                self.tracer.stop()
            self._stop(epoch)

    def _stop(self, epoch: int) -> None:
        # the loop saves a checkpoint at num_epochs - 1, which it has passed
        self.estimator.num_epochs = epoch
        self.stopped = True

    def window(self):
        """``(epochs, seconds)``: the epochs that ended within ``seconds``
        of the window's start (at least one), and the time to the last's
        end."""
        inside = [(e, t) for e, t in self.ends
                  if t - self.t0 <= self.seconds] or self.ends[:1]
        if not inside:
            return [], 0.0
        return [e for e, _ in inside], inside[-1][1] - self.t0


def fit(config: Dict, mix: Dict, rows, seed: int, seconds: float,
        device: torch.device, model_module, leaves: List[Leaf],
        tracer=None):
    """Build the program, run the fit, and return ``(result, window,
    readout, model, optimizer)``."""
    t_build = time.perf_counter()
    from raydp_tpu_torch.data.dataset import TableDataset
    from raydp_tpu_torch.train.torch_estimator import (
        TorchEstimator, _resolve_loss,
    )

    model = model_module.build(config, device)
    params = write_weights(model, leaves, seed)
    chain = chain_steps(mix)
    readout = Readout(params, leaves, seed, steps=checked_steps(mix),
                      steps_per_replay=chain)
    held = {}

    def optimizer(parameters):
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config["optimizer"].items() if k != "name"}
        cls = getattr(torch.optim, spec.load(
            "optimizers", config["optimizer"]["name"]).TORCH)
        held["optimizer"] = opt = cls(parameters, **kw)
        readout.attach(opt)
        return opt

    ckpt = tempfile.mkdtemp(prefix="bench-port-ckpt-")
    est = TorchEstimator(
        model_creator=lambda: model, optimizer=optimizer,
        loss=readout.loss(_resolve_loss(config["loss"])),
        feature_columns=rows.columns, label_column=rows.label,
        feature_dtype=np.float32, label_dtype=np.float32,
        batch_size=int(config["batch_size"]), num_epochs=1 << 30,
        checkpoint_dir=ckpt, checkpoint_interval=1 << 40, seed=seed,
        shuffle=True, batch_preprocessor=model_module.preprocessor(config),
        drop_last=True, steps_per_dispatch=chain,
        prefetch_to_device=mix.get("prefetch_to_device"), device=device)
    window = Window(est, seconds, readout, tracer)
    window.build_start = t_build
    est.callbacks = [window]
    dataset = TableDataset(rows.blocks())
    window.fit_start = time.perf_counter()
    try:
        result = est.fit(dataset)
    finally:
        readout.close()
        shutil.rmtree(ckpt, ignore_errors=True)
    return result, window, readout, model, held.get("optimizer")
