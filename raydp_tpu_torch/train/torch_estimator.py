"""TorchEstimator — port of :class:`raydp_tpu.train.FlaxEstimator` for one
CUDA device (or, when asked, the CPU).

``fit`` trains a ``torch.nn.Module`` over any dataset with the read
interface of the reference's ``DistributedDataset`` (the port's
:class:`~raydp_tpu_torch.data.TableDataset`, or the reference's own): the
whole dataset resident on the device when it fits (:class:`DeviceEpochCache`,
an epoch gathers its batches on the device), else the streaming
:class:`DeviceFeed`. Per epoch it reports the same keys as the reference
(``train_loss``, ``steps``, ``samples_per_s``, the epoch time split into
feed/decode/stage/h2d/dispatch/sync, ``train_<metric>``, ``eval_loss``,
``eval_<metric>``), runs the callbacks, checkpoints every
``checkpoint_interval`` epochs (and the last) through
:mod:`raydp_tpu_torch.train.checkpoint`, and on a failure restores the last
checkpoint this fit wrote, up to ``max_retries`` times. ``fit_on_frame``
converts ETL DataFrames first (:class:`FrameEstimatorInterface`).
``predict``, ``get_model`` and ``export_serving`` (a bundle that
:mod:`raydp_tpu_torch.serve` loads onto serving replicas) follow;
``partial_fit`` trains online over a continuous pipeline
(:mod:`raydp_tpu_torch.stream`), one pass an epoch, and can export and
hot-swap the model into a live serving session every few epochs.

``fit_gang`` (and ``fit_on_frame(num_workers > 1)``) trains as a gang of
rank processes under one ``torch.distributed`` process group
(:mod:`raydp_tpu_torch.spmd`): each rank feeds its slice of every global
batch (:class:`~raydp_tpu_torch.data.feed.GangShardIterator`) through the
streaming feed and runs the same step on a replicated model. The step's
loss is the rank's masked sum over the GLOBAL row count, its gradient is
summed across the ranks with one all-reduce of a flat buffer before the
optimizer steps (the gradient XLA's inserted collective gives the
reference), BatchNorm takes the global batch's statistics
(:class:`~raydp_tpu_torch.models.layers.BatchNorm`), and the epoch's sums
are summed across the ranks before the host reads them, so every rank's
history is the global one. The eval tail pads and masks
(``RDT_TRAIN_PAD_TAIL``), so every eval row counts once. Rank 0 writes the
checkpoints (each rank its shards, under a sharded mesh: below), a failed
rank fails the gang, and the driver restarts it, resuming from the last
checkpoint, up to ``max_retries`` times.

How it dispatches (the reference's jitted scan and chain): on CUDA the
resident epoch, the resident eval pass and, with ``steps_per_dispatch=k >
1``, each ``k``-step chain of the streaming feed are CUDA graphs, captured
after the fit's first (eager) step and replayed once a step or chain
(:mod:`raydp_tpu_torch.train.step_graph`); streaming with ``k = 1``,
streaming eval, ragged batches and ``partial_fit`` run eagerly, as the
reference dispatches them one jitted step at a time. On the CPU the same
runners call the step directly. A gang under ``nccl`` captures its chains
with the collectives inside, sharded or replicated; under ``gloo`` every
step runs eagerly
(:func:`~raydp_tpu_torch.train.step_graph.graphs_allowed`).

How the reference's pieces map:

- the model: an ``nn.Module`` (``model``, copied at every fit so each fit
  starts from the same weights, as each Flax fit starts from
  ``model.init(PRNGKey(seed))``) or a zero-argument ``model_creator``; its
  ``train()``/``eval()`` mode is Flax's ``train`` argument, and BatchNorm
  statistics update in place in training mode;
- the optimizer: a factory ``params -> torch.optim.Optimizer``
  (``optimizer`` or ``optimizer_creator``); the default is
  ``torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)``, which
  is ``optax.adam(1e-3)``. ``optax.adagrad(lr)`` (accumulator from 0.1,
  ``g / sqrt(acc + 1e-7)``) is ``torch.optim.Adagrad(params, lr=lr,
  initial_accumulator_value=0.1, eps=0.0)`` to within 5e-7 of the update
  (torch adds eps outside the root; with the accumulator ≥ 0.1 dropping
  optax's 1e-7 inside it moves the root by at most that share). On CUDA
  the optimizer is made capturable before its first step
  (:func:`~raydp_tpu_torch.train.step_graph.prepare_optimizer`);
- ``compute_dtype`` casts the floating inputs (after
  ``batch_preprocessor``) to a torch dtype;
- ``remat`` (or ``RDT_TRAIN_REMAT``) wraps the train forward in
  ``torch.utils.checkpoint`` by the model's dominant parameter role
  (:mod:`raydp_tpu_torch.parallel.roles`);
- the loss and metric sums stay on the device; the host reads them once,
  at the end of the epoch.

Telemetry (the reference's names): the ``estimator.epoch`` fault site at
the top of every epoch, the ``train:place`` span around the state's
placement, the ``train:accum`` span around a capture when accumulation or
remat is engaged, the gauges ``train_param_bytes_per_process``,
``train_accum_steps`` and ``train_activation_bytes_per_process``, and the
``train_epoch_seconds`` histogram.

Sharding (the reference's ``mesh``/``mesh_spec``/``param_rules``): torch
runs one device a process, so a sharded fit is a gang's,
``fit_gang(num_workers=n, mesh_spec=...)``, one rank a mesh position
(:mod:`raydp_tpu_torch.parallel.mesh`); each rank builds the mesh over the
gang's process group. A mesh with a ``fsdp``, ``expert`` or ``tensor``
extent above 1 holds the model as each rank's shards
(:class:`~raydp_tpu_torch.parallel.shard.ShardedModule`: ``param_rules``
first, then the role policy), feeds each rank its block of every global
batch over data × fsdp (:func:`~raydp_tpu_torch.data.feed.
process_local_batch_rows`; the whole batch under pure ``expert`` or
``tensor``), sums the step's row counts, gradients, BatchNorm statistics
and epoch sums over exactly the ranks that saw different rows, captures
its ``k``-step chains under ``nccl`` as a replicated gang does (the gathers,
reduce-scatters and exchanges inside the graph; every step eager under
``gloo``), and checkpoints in the sharded multi-writer format; the
driver gets the gathered state, and ``get_state()`` its specs. A ragged
train tail pads and masks when ``drop_last=False`` (``RDT_TRAIN_PAD_TAIL``;
BatchNorm's statistics count the real rows only). A plain ``fit`` runs on
a world-1 mesh: a ``mesh_spec`` with an extent above 1 raises the
reference's ``ValueError``; ``fit(mesh=)`` takes a mesh built by
:func:`~raydp_tpu_torch.parallel.mesh.make_mesh` inside the ranks of the
caller's own process group.

A ``seq`` extent above 1 splits dim 1 of the batch's ndim >= 2 leaves over
``seq`` in the feed (``seq_sharded``; the reference's
``batch_sharding(mesh, seq=True)``), and the step gathers them whole at
entry, so the model sees every row as the reference's GSPMD shows it the
global array; the seq ranks then compute alike, and their gradients are not
summed. A ``stage`` extent above 1 trains a :class:`PipelineModel` through
the GPipe schedule (:mod:`raydp_tpu_torch.parallel.pipeline`): each rank
holds its stage's run of the stacked layers (the role policy splits
``stage_stack`` over ``stage``), ``accum_steps`` is the microbatch count,
remat is set per segment (``embed``, ``stage_stack``, ``head``), and the
``train_pipeline_stages`` gauge and the ``train:pipeline`` span are
emitted; any other model on a staged mesh raises the reference's
``ValueError``.
"""

from __future__ import annotations

import contextlib
import copy
import inspect
import math
import os
import tempfile
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from raydp_tpu_torch import faults, knobs, profiler
from raydp_tpu_torch import metrics as rdt_metrics
from raydp_tpu_torch.data.feed import (
    MASK_KEY, DeviceEpochCache, DeviceFeed, GangShardIterator,
    HostBatchIterator, epoch_seed, process_local_batch_rows,
)
from raydp_tpu_torch.device import DeviceLike, resolve_device
from raydp_tpu_torch.log import get_logger
from raydp_tpu_torch.parallel import gang
from raydp_tpu_torch.parallel.mesh import (
    Mesh, MeshSpec, as_mesh_spec, axis_index, data_axes, make_mesh,
    seq_extent, stage_extent,
)
from raydp_tpu_torch.parallel.shard import (
    ShardedModule, gather_dim, placement,
)
from raydp_tpu_torch.parallel.roles import (
    addressable_nbytes, apply_remat, parse_remat_policy, remat_mode_for_role,
    segment_role,
)
from raydp_tpu_torch.train import checkpoint as ckpt
from raydp_tpu_torch.train.estimator import (
    EstimatorInterface, FrameEstimatorInterface, save_epoch_now,
)
from raydp_tpu_torch.train.metrics import Metric, build_metrics
from raydp_tpu_torch.train.step_graph import (
    Accumulators, DispatchTimes, StepRunner, graphs_allowed,
    prepare_optimizer,
)

logger = get_logger("train.torch_estimator")


@dataclass
class TrainState:
    """The trained module and its optimizer. After a sharded fit, ``specs``
    maps each parameter to the spec it was trained under (the reference's
    vocabulary, ``.sharding.spec`` as a tuple; each rank's shard is in
    ``TrainingResult.ranks``)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    specs: Optional[Dict[str, tuple]] = None

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Mapping) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])


@dataclass
class TrainingResult:
    state: TrainState
    history: List[Dict[str, float]] = field(default_factory=list)
    checkpoint_dir: Optional[str] = None
    #: how each epoch that ran dispatched its steps (retried epochs
    #: included): ``graph_replays`` and ``graph_steps`` (the train steps
    #: those replays ran), ``eager_steps``, ``capture_s`` of a capture made
    #: in the epoch, ``eval_replays``
    dispatch: List[Dict[str, float]] = field(default_factory=list)
    #: a gang's ranks, in rank order: ``backend`` (its process group's),
    #: ``param_bytes`` (the parameters, buffers and optimizer state the
    #: rank held: its shards), ``memory_allocated`` and
    #: ``max_memory_allocated`` (the rank's CUDA bytes at the fit's end and
    #: at their peak, None on the CPU) and ``local_shapes`` (its shard of
    #: each parameter)
    ranks: List[Dict[str, Any]] = field(default_factory=list)


def _default_optimizer(params) -> torch.optim.Optimizer:
    return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


def _cast_floating(inputs, dtype: Optional[torch.dtype]):
    """Cast the floating tensors of a batch (a tensor, or dicts/lists of
    them) to the compute dtype — THE cast policy, shared by the train loop
    and predict."""
    if dtype is None:
        return inputs
    if isinstance(inputs, Mapping):
        return {k: _cast_floating(v, dtype) for k, v in inputs.items()}
    if isinstance(inputs, (list, tuple)):
        return type(inputs)(_cast_floating(v, dtype) for v in inputs)
    return inputs.to(dtype) if inputs.is_floating_point() else inputs


@torch.inference_mode()
def infer(model: nn.Module, batch: Dict[str, torch.Tensor],
          preprocessor: Optional[Callable], compute_dtype,
          rows: int) -> torch.Tensor:
    """THE inference step, shared by ``predict`` and a loaded servable:
    the model's inputs (the preprocessor's first output, else
    ``features``), cast by the compute dtype, through the model; a
    trailing output dim of 1 squeezed; float32.

    Every forward runs at ``rows`` rows, whatever the batch holds: a
    shorter batch is padded with zero rows on its device (before the
    preprocessor, which sees valid rows), a longer one is cut into
    ``rows``-row pieces, and the padding is sliced off the output. The
    GEMM kernels, and with them the order of each row's sums, are chosen by
    the row count, so a fixed count gives a row the same bits whatever it
    was batched with."""
    n = len(next(iter(batch.values())))
    padded = max(1, -(-n // rows)) * rows
    if padded != n:
        batch = {k: torch.cat([v, v.new_zeros((padded - n, *v.shape[1:]))])
                 for k, v in batch.items()}
    out = []
    for start in range(0, padded, rows):
        piece = {k: v[start:start + rows] for k, v in batch.items()}
        inputs = (preprocessor(piece)[0] if preprocessor is not None
                  else piece["features"])
        preds = model(_cast_floating(inputs, compute_dtype))
        if preds.ndim >= 2 and preds.shape[-1] == 1:
            preds = preds.squeeze(-1)
        out.append(preds.float())
    return (out[0] if len(out) == 1 else torch.cat(out))[:n]


def _masked_mean(x: torch.Tensor, mask) -> torch.Tensor:
    """Mean of ``x`` over REAL rows only: per-row reduce the non-batch dims,
    then weight by the 0/1 mask. ``mask=None`` is a plain mean."""
    if mask is None:
        return torch.mean(x)
    if x.ndim > 1:
        x = torch.mean(x, dim=tuple(range(1, x.ndim)))
    return torch.sum(x * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def _resolve_loss(loss) -> Callable:
    if callable(loss):
        return loss
    name = (loss or "mse").lower()

    # every named loss is elementwise-then-_masked_mean so a pad-and-mask
    # feed's zero rows contribute nothing
    def mse(preds, labels, mask=None):
        return _masked_mean((preds - labels) ** 2, mask)

    def mae(preds, labels, mask=None):
        return _masked_mean(torch.abs(preds - labels), mask)

    def smooth_l1(preds, labels, beta=1.0, mask=None):
        d = torch.abs(preds - labels)
        return _masked_mean(torch.where(d < beta, 0.5 * d * d / beta,
                                        d - 0.5 * beta), mask)

    def bce_with_logits(logits, labels, mask=None):
        return _masked_mean(torch.clamp_min(logits, 0) - logits * labels
                            + torch.log1p(torch.exp(-torch.abs(logits))),
                            mask)

    def softmax_cross_entropy(logits, labels, mask=None):
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)
        return _masked_mean(nll, mask)

    table = {"mse": mse, "l2": mse, "mae": mae, "l1": mae,
             "smooth_l1": smooth_l1, "huber": smooth_l1,
             "bce": bce_with_logits, "bce_with_logits": bce_with_logits,
             "cross_entropy": softmax_cross_entropy}
    if name not in table:
        raise ValueError(f"unknown loss {name!r}; have {sorted(table)}")
    return table[name]


def _loss_takes_mask(loss) -> bool:
    """Whether the loss accepts ``mask=`` (every named loss does; a custom
    callable must declare it or take ``**kwargs``) — the reference's
    condition for padding a ragged batch instead of dropping it."""
    if not callable(loss):
        return True
    try:
        params = inspect.signature(loss).parameters
    except (TypeError, ValueError):
        return False
    return "mask" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def _strip_mask(batch):
    """Split the feed's validity mask off a batch dict (None when the feed
    is not padding) — model/preprocessor code never sees the mask key."""
    mask = batch.get(MASK_KEY)
    if mask is None:
        return batch, None
    return {k: v for k, v in batch.items() if k != MASK_KEY}, mask


def _update_metric(m, stats, preds, labels, mask):
    """Metric update with the mask passed ONLY when one exists: builtin
    metrics take it; a custom Metric without mask support keeps working on
    unpadded feeds and fails loudly (not silently wrong) on padded ones."""
    if mask is None:
        return m.update(stats, preds, labels)
    return m.update(stats, preds, labels, mask=mask)


def _host_stats(stats) -> Dict[str, np.ndarray]:
    """A metric's statistics read to the host (once, at epoch end)."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32)) for k, v in stats.items()}


def _make_apply(split_batch, compute_dtype, remat_mode: str = "none",
                seq_mesh: Optional[Mesh] = None):
    """Build THE forward of the train and eval steps — one source for the
    split/cast/mode/squeeze policy; the train forward runs under
    ``remat_mode`` (:func:`~raydp_tpu_torch.parallel.roles.apply_remat`).
    ``seq_mesh``: the feed split dim 1 of the batch's ndim >= 2 leaves over
    its ``seq`` axis; they are gathered whole before the preprocessor and
    the model, which see every rank's row as the reference's GSPMD shows
    them the global array.

    Returns ``apply_fn(model, batch, train) -> (preds_f32, labels)``."""
    train_forward = apply_remat(lambda model, inputs: model(inputs),
                                remat_mode)

    def apply_fn(model, batch, train: bool):
        if seq_mesh is not None:
            batch = {k: gather_dim(v, 1, ("seq",), seq_mesh) if v.ndim >= 2
                     else v for k, v in batch.items()}
        inputs, labels = split_batch(batch)
        inputs = _cast_floating(inputs, compute_dtype)
        model.train(train)
        preds = train_forward(model, inputs) if train else model(inputs)
        if preds.ndim == labels.ndim + 1 and preds.shape[-1] == 1:
            preds = preds.squeeze(-1)
        return preds.float(), labels

    return apply_fn


def _make_train_step(apply_fn, loss_fn, metrics, accum: int,
                     in_gang: bool = False, batch_group=None):
    """Build the train step: one optimizer update from one batch.

    ``train_step(state, batch, mstats, loss_sum) -> (loss_sum, mstats)``
    updates ``state`` in place; the loss and metric sums are device tensors.
    With ``accum > 1`` the batch splits into ``accum`` microbatches run one
    after another: per-microbatch grads, loss and metric stats accumulate
    ROW-WEIGHTED in f32 (a masked microbatch weighs in by its real rows), so
    the single optimizer step at the end reproduces the unaccumulated
    update to float-summation-order tolerance while only ONE microbatch's
    activations are ever live.

    ``in_gang``: the batch is this rank's slice of a global batch, and
    ``batch_group`` the ranks that hold the other slices. The rank's loss
    is its masked mean weighed by its share of the global row count
    (all-reduced once a batch), so the ranks' losses sum to the global
    batch's mean; after ``backward`` the gradients are summed over the
    group (one all-reduce of a flat buffer; a sharded model's own
    :meth:`~raydp_tpu_torch.parallel.shard.ShardedModule.reduce_grads`) and
    the optimizer steps on that — the global batch's gradient on every
    rank. The loss sum then holds this rank's shares, which the epoch sums
    over the group. A masked batch's BatchNorm statistics count its real
    rows (:func:`~raydp_tpu_torch.parallel.gang.batch_rows`)."""

    def _params(state):
        return [p for p in state.model.parameters() if p.requires_grad]

    def _global_rows(rows: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(gang.all_reduce_(rows.clone(), batch_group),
                               1.0)

    def _sync_grads(state) -> None:
        if isinstance(state.model, ShardedModule):
            state.model.reduce_grads()
        else:
            gang.all_reduce_grads(_params(state), batch_group)

    def _rows(state, mask):
        if in_gang and mask is not None:
            return gang.batch_rows(state.model, mask)
        return contextlib.nullcontext()

    def _microbatch(state, batch, mask):
        preds, labels = apply_fn(state.model, batch, train=True)
        lv = loss_fn(preds, labels, mask=mask) if mask is not None \
            else loss_fn(preds, labels)
        return lv, preds.detach(), labels

    def train_step(state, batch, mstats, loss_sum):
        batch, mask = _strip_mask(batch)
        if accum <= 1:
            with _rows(state, mask):
                lv, preds, labels = _microbatch(state, batch, mask)
                if in_gang:
                    # a fill, not a host copy: a CUDA graph can capture it
                    rows = torch.sum(mask) if mask is not None else \
                        lv.new_full((), float(labels.shape[0]))
                    lv = lv * (rows / _global_rows(rows))
                state.optimizer.zero_grad(set_to_none=True)
                lv.backward()
            if in_gang:
                _sync_grads(state)
            state.optimizer.step()
            new_mstats = tuple(
                _update_metric(m, s, preds, labels, mask)
                for m, s in zip(metrics, mstats))
            return loss_sum + lv.detach().float(), new_mstats

        rows_total = next(iter(batch.values())).shape[0]
        if rows_total % accum:
            raise ValueError(f"accum_steps={accum} does not divide the batch "
                             f"dimension {rows_total}")
        mb = rows_total // accum
        params = _params(state)
        # a sharded model sums its gradients over ranks inside the backward
        # (a reduce-scatter), so each rank weighs its microbatch's loss by
        # its own rows before it, not its gradient after it
        sharded = isinstance(state.model, ShardedModule)
        # grads/loss accumulate in f32 regardless of the param dtype
        g_acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        l_acc = torch.zeros((), dtype=torch.float32, device=loss_sum.device)
        r_acc = torch.zeros((), dtype=torch.float32, device=loss_sum.device)
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            mb_mask = None if mask is None else mask[sl]
            with _rows(state, mb_mask):
                lv, preds, labels = _microbatch(
                    state, {n: a[sl] for n, a in batch.items()}, mb_mask)
                rows = torch.sum(mb_mask) if mb_mask is not None \
                    else float(labels.shape[0])
                grads = torch.autograd.grad(lv * rows if sharded else lv,
                                            params, allow_unused=True)
            for a, g in zip(g_acc, grads):
                if g is not None:
                    a.add_(g.float() if sharded else g.float() * rows)
            l_acc = l_acc + lv.detach().float() * rows
            r_acc = r_acc + rows
            mstats = tuple(_update_metric(m, s, preds, labels, mb_mask)
                           for m, s in zip(metrics, mstats))
        denom = _global_rows(r_acc) if in_gang else torch.clamp_min(r_acc, 1.0)
        for p, a in zip(params, g_acc):
            p.grad = (a / denom).to(p.dtype)
        if in_gang:
            _sync_grads(state)
        state.optimizer.step()
        return loss_sum + l_acc / denom, mstats

    return train_step


def _make_eval_step(apply_fn, loss_fn, metrics):
    """Build the eval step. It threads BOTH accumulators (the row-weighted
    loss sum AND the row count): under pad-and-mask the real row count is
    mask.sum().

    ``eval_step(state, batch, mstats, loss_sum, cnt_sum) -> (loss_sum,
    cnt_sum, mstats)``."""

    @torch.no_grad()
    def eval_step(state, batch, mstats, loss_sum, cnt_sum):
        batch, mask = _strip_mask(batch)
        preds, labels = apply_fn(state.model, batch, train=False)
        if mask is None:
            rows = float(labels.shape[0])
            loss_val = loss_fn(preds, labels).float()
        else:
            rows = torch.sum(mask)
            loss_val = loss_fn(preds, labels, mask=mask).float()
        new_mstats = tuple(
            _update_metric(m, s, preds, labels, mask)
            for m, s in zip(metrics, mstats))
        return loss_sum + loss_val * rows, cnt_sum + rows, new_mstats

    return eval_step


def _in_place(train_step, state, acc: Accumulators):
    """The train step as a body that updates ``acc`` in place."""

    def body(batch):
        acc.update(*train_step(state, batch, acc.stats, acc.loss))

    return body


def _in_place_eval(eval_step, state, acc: Accumulators):
    """The eval step as a body that updates ``acc`` in place."""

    def body(batch):
        loss, count, stats = eval_step(state, batch, acc.stats, acc.loss,
                                       acc.count)
        acc.update(loss, stats, count)

    return body


def _counts(*runners) -> tuple:
    """Each runner's counters (zeros for an absent one)."""
    return tuple((0, 0, 0, 0.0) if r is None else
                 (r.replays, r.replayed_steps, r.eager_steps, r.capture_s)
                 for r in runners)


def _dispatch_record(epoch: int, before: tuple, after: tuple,
                     loop_eager_steps: int,
                     timing: Dict[str, float]) -> Dict[str, float]:
    """How one epoch dispatched: the train and eval runners' counters
    after it less before it, plus the steps the loop ran eagerly itself,
    and ``timing``: ``lead_s`` always, and while traced on a card
    :meth:`DispatchTimes.read`'s keys."""
    (r0, s0, e0, c0), (er0, *_) = before
    (r1, s1, e1, c1), (er1, *_) = after
    return {"epoch": epoch, "graph_replays": r1 - r0,
            "graph_steps": s1 - s0,
            "eager_steps": e1 - e0 + loop_eager_steps,
            "capture_s": c1 - c0, "eval_replays": er1 - er0, **timing}


def _materialize_optimizer_state(state: TrainState) -> None:
    """Create the optimizer's state, which torch makes at the first step:
    one step on zero gradients. Every tensor it touches — the parameters
    too — is then overwritten by the checkpoint restored into it."""
    for p in state.model.parameters():
        if p.requires_grad:
            p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)


def _all_reduce_sums(acc: Accumulators, group) -> None:
    """Sum a pass's accumulators over ``group``, in place: the loss sum,
    the row count and every metric statistic (all of them sums)."""
    for t in (acc.loss, acc.count, *(v for s in acc.stats
                                     for v in s.values())):
        if t is not None:
            gang.all_reduce_(t, group)


def _sharded(mesh: Optional[Mesh]) -> bool:
    """Whether the mesh splits the model (not only the batch)."""
    return mesh is not None and any(
        mesh.shape[a] > 1 for a in ("fsdp", "expert", "tensor", "stage"))


def _traced_once(body, span: str):
    """``body`` whose first call runs inside the profiler span ``span`` (an
    eager fit's first step, where a graphed one times its capture)."""
    first = [True]

    def run(batch):
        if not first[0]:
            return body(batch)
        first[0] = False
        with profiler.trace(span, "training"):
            return body(batch)

    return run


def _layout(state: TrainState, mesh: Mesh) -> Dict[str, tuple]:
    """The checkpoint placement of every sharded tensor of ``state``."""
    specs = state.model.tensor_specs(state.optimizer)
    out = {}
    for key, t in ckpt._tensor_leaves(state.state_dict()):
        spec = specs.get(key, ())
        if any(e is not None for e in spec):
            out[key] = placement(spec, t.shape, mesh)
    return out


def _chain(body):
    """A body over a stack of ``k`` batches: ``k`` steps, one after the
    other (the reference's ``lax.scan`` over a stacked batch)."""

    def chain(stack):
        for i in range(next(iter(stack.values())).shape[0]):
            body({n: t[i] for n, t in stack.items()})

    return chain


class PipelineModel(nn.Module):
    """A layer-list model for pipeline-parallel placement (the reference's
    ``PipelineModel``).

    ``layers`` is a sequence of stage-homogeneous modules (identical
    parameter names and shapes — the transformer-block case); ``embed`` and
    ``head`` are optional entry and exit modules that run OUTSIDE the
    pipeline (``embed`` maps the batch inputs to the hidden array the
    layers consume). The layers' parameters are stacked on a leading axis
    under ``stage_stack`` (:func:`~raydp_tpu_torch.parallel.pipeline.
    stack_stage_params`; ``stage_stack.<name>`` is the reference's
    ``params["stage_stack"][...]``), which the role policy splits over a
    mesh's ``stage`` axis, so each rank holds its stage's contiguous run;
    ``layers[0]`` is the template each layer's parameters run through.
    The stack is a copy of the layers' parameters when the model is built:
    draw (or load) them first.

    ``forward`` is the sequential host form that ``predict`` and
    ``export_serving`` use — row-identical to the pipelined forward. The
    estimator trains through the GPipe schedule
    (:func:`~raydp_tpu_torch.parallel.pipeline.pipeline_apply`) on any mesh:
    its ``accum_steps`` microbatches are the pipeline's. Modules with
    buffers (BatchNorm's running statistics) are refused: running stats
    cannot hop stages."""

    def __init__(self, layers: Sequence[nn.Module],
                 embed: Optional[nn.Module] = None,
                 head: Optional[nn.Module] = None):
        super().__init__()
        if not layers:
            raise ValueError("PipelineModel needs at least one layer")
        from raydp_tpu_torch.parallel.pipeline import stack_stage_params

        layers = list(layers)
        parts = [("embed", embed), *((f"layers[{i}]", m)
                                     for i, m in enumerate(layers)),
                 ("head", head)]
        for where, m in parts:
            if m is not None and any(True for _ in m.buffers()):
                raise ValueError(
                    f"PipelineModel {where} carries mutable collections "
                    f"['batch_stats'] (e.g. BatchNorm batch_stats): running "
                    f"stats cannot hop pipeline stages — use stat-free blocks "
                    f"(LayerNorm)")
        self.embed = embed
        self.head = head
        stacked = stack_stage_params(
            [{n: p.detach() for n, p in m.named_parameters()}
             for m in layers])
        self.stage_stack = nn.Module()
        for name, t in stacked.items():
            *path, leaf = name.split(".")
            owner = self.stage_stack
            for part in path:
                if part not in owner._modules:
                    owner.add_module(part, nn.Module())
                owner = owner._modules[part]
            owner.register_parameter(leaf, nn.Parameter(t.clone()))
        self._names = list(stacked)
        # the template is no submodule: its own parameters never train
        self._template = (layers[0],)
        #: set by the estimator for training: ``(mesh, n_micro, seg_modes)``
        self.schedule: Optional[tuple] = None

    @property
    def num_layers(self) -> int:
        return int(self._stack()[self._names[0]].shape[0])

    def _stack(self) -> Dict[str, torch.Tensor]:
        """The stacked parameters by their names in a layer (the rank's run
        of layers under a stage-split :class:`ShardedModule`)."""
        out = {}
        for name in self._names:
            t = self.stage_stack
            for part in name.split("."):
                t = getattr(t, part)
            out[name] = t
        return out

    def _layer(self, params: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
        from torch.func import functional_call

        return functional_call(self._template[0], params, (x,))

    def forward(self, inputs):
        if self.schedule is not None:
            return self._pipelined(inputs, *self.schedule)
        h = self.embed(inputs) if self.embed is not None else inputs
        stack = self._stack()
        for i in range(self.num_layers):
            h = self._layer({n: p[i] for n, p in stack.items()}, h)
        return self.head(h) if self.head is not None else h

    def _pipelined(self, inputs, mesh: Mesh, n_micro: int,
                   seg_modes: Dict[str, str]):
        """The training forward (the reference's ``_make_pipeline_apply``):
        the batch in ``n_micro`` microbatches through the GPipe schedule,
        each segment under its own remat mode."""
        from raydp_tpu_torch.parallel.pipeline import pipeline_apply

        def run(fn, segment, *args):
            return apply_remat(fn, seg_modes.get(segment, "none"))(*args)

        h = inputs
        if self.embed is not None:
            h = run(lambda m, x: m(x), "embed", self.embed, h)
        rows = int(h.shape[0])
        if rows % n_micro:
            raise ValueError(
                f"pipeline microbatching: accum_steps={n_micro} does not "
                f"divide the batch dimension {rows} — pad-and-mask the tail "
                f"(RDT_TRAIN_PAD_TAIL) or drop it (drop_last=True)")
        h_micro = h.reshape((n_micro, rows // n_micro) + tuple(h.shape[1:]))
        layer = apply_remat(self._layer, seg_modes.get("stage_stack", "none"))
        out = pipeline_apply(layer, self._stack(), h_micro, mesh,
                             stage_local=True, split_data=False)
        h = out.reshape((rows,) + tuple(out.shape[2:]))
        if self.head is not None:
            h = run(lambda m, x: m(x), "head", self.head, h)
        return h


def _pipeline_model(model: nn.Module) -> Optional[PipelineModel]:
    """The :class:`PipelineModel` a (sharded) train-state model is, if any."""
    inner = model.module if isinstance(model, ShardedModule) else model
    return inner if isinstance(inner, PipelineModel) else None


def _check_pipeline(model: nn.Module, sizes: Dict[str, int]) -> None:
    """Refuse a placement the schedule cannot run, before any step: layers
    that do not divide over the stages, a plain module on a staged mesh."""
    n_stages = sizes["stage"]
    if isinstance(model, PipelineModel):
        n_layers = model.num_layers
        if n_stages > 1 and n_layers % n_stages:
            raise ValueError(
                f"PipelineModel has {n_layers} layers; the mesh's "
                f"stage={n_stages} must divide them (each stage applies "
                f"a contiguous run of layers)")
    elif n_stages > 1:
        raise ValueError(
            f"mesh has stage={n_stages} but the model is not a "
            f"PipelineModel: stage-stacked placement needs the layer-list "
            f"description (raydp_tpu_torch.train.PipelineModel)")


class TorchEstimator(EstimatorInterface, FrameEstimatorInterface):
    def __init__(
        self,
        model: Optional[nn.Module] = None,
        model_creator: Optional[Callable[[], nn.Module]] = None,
        optimizer: Optional[Callable] = None,
        optimizer_creator: Optional[Callable] = None,
        loss: Union[str, Callable, None] = "mse",
        feature_columns: Optional[Sequence[str]] = None,
        label_column: Optional[str] = None,
        batch_size: int = 64,
        num_epochs: int = 10,
        metrics: Optional[Sequence[Union[str, Metric]]] = None,
        checkpoint_dir: Optional[str] = None,
        seed: int = 0,
        feature_dtype=np.float32,
        label_dtype=np.float32,
        shuffle: bool = True,
        batch_preprocessor: Optional[Callable] = None,
        columns_spec: Optional[Dict] = None,
        compute_dtype: Optional[torch.dtype] = None,
        drop_last: bool = True,
        callbacks: Optional[Sequence[Callable[[Dict], None]]] = None,
        checkpoint_interval: int = 1,
        prefetch_to_device: Optional[int] = None,
        accum_steps: Optional[int] = None,
        device: DeviceLike = None,
        steps_per_dispatch: int = 1,
        remat: Optional[str] = None,
        mesh: Optional[Mesh] = None,
        mesh_spec: Optional[Union[MeshSpec, Dict[str, int]]] = None,
        param_rules: Optional[List[Tuple[str, tuple]]] = None,
        seq_sharded: Optional[bool] = None,
    ):
        if model is None and model_creator is None:
            raise ValueError("pass model or model_creator")
        #: the device every fit runs on: CUDA unless ``device="cpu"`` is
        #: passed; raises without CUDA
        self.device = resolve_device(device)
        self._model = model
        self._model_creator = model_creator
        self._optimizer = optimizer
        self._optimizer_creator = optimizer_creator
        self._loss = loss
        self.feature_columns = list(feature_columns or [])
        self.label_column = label_column
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self._metrics = build_metrics(metrics or [])
        self.checkpoint_dir = checkpoint_dir
        #: the streaming feed's shuffle seed and the resident permutation's
        #: generator seed (per epoch through ``epoch_seed``)
        self.seed = seed
        self.feature_dtype = feature_dtype
        self.label_dtype = label_dtype
        self.shuffle = shuffle
        self.batch_preprocessor = batch_preprocessor
        self.columns_spec = columns_spec
        self.compute_dtype = compute_dtype
        self.drop_last = drop_last
        self.callbacks = list(callbacks or [])
        #: checkpoint every N-th epoch (the final epoch always saves); a
        #: retry then replays at most N-1 epochs from the last save
        self.checkpoint_interval = max(1, int(checkpoint_interval))
        #: placed batches the streaming feed keeps ahead of the train step
        #: (None = RDT_PREFETCH_TO_DEVICE, 2); the resident path ignores it
        self.prefetch_to_device = prefetch_to_device
        #: gradient-accumulation microbatches per optimizer step (None = the
        #: RDT_TRAIN_ACCUM_STEPS knob, default 1). Must divide batch_size.
        self.accum_steps = accum_steps
        #: chain this many train steps into ONE dispatch on the streaming
        #: path: one CUDA graph of the k-step chain, replayed once per stack
        #: of k batches (the reference's lax.scan over a stacked batch).
        #: The same update sequence as dispatching each batch
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        #: rematerialization policy for the train-step forward: a mode
        #: ('none' | 'dots' | 'full') or a per-role 'role=mode,...' map over
        #: the parameter roles; None = the RDT_TRAIN_REMAT knob
        #: (parallel/roles.py parse_remat_policy)
        self.remat = remat
        #: a mesh built by make_mesh inside the ranks of the caller's own
        #: process group (fit); fit_gang builds its own from ``mesh_spec``
        self._mesh = mesh
        #: the mesh's axis sizes (a MeshSpec or a dict; None: MeshSpec())
        self._mesh_spec = mesh_spec
        #: ordered (path substring, spec) rules, ahead of the role policy
        self.param_rules = param_rules
        #: split dim 1 of the batch's ndim >= 2 leaves over the mesh's seq
        #: axis (None: whenever it is > 1; False opts out)
        self.seq_sharded = seq_sharded
        self._result: Optional[TrainingResult] = None

    def _build_mesh(self) -> Mesh:
        """THIS process's mesh: the one passed, else ``mesh_spec`` over the
        process group's world (every rank of it must call this)."""
        return self._mesh if self._mesh is not None else make_mesh(
            self._mesh_spec, device_type=self.device.type)

    def _resolve_accum(self) -> int:
        """The effective accumulation factor for THIS fit (the constructor
        argument wins over the knob, read at call time), validated against
        batch_size."""
        k = self.accum_steps if self.accum_steps is not None \
            else int(knobs.get("RDT_TRAIN_ACCUM_STEPS"))
        k = max(1, int(k))
        if k > 1 and self.batch_size % k:
            raise ValueError(
                f"accum_steps={k} must divide batch_size={self.batch_size}")
        return k

    def _resolve_remat(self) -> Dict[str, str]:
        """The effective remat POLICY for THIS fit, a role→mode map parsed
        and validated before any step (the constructor argument wins over
        the knob, read at call time)."""
        spec = (self.remat if self.remat is not None
                else str(knobs.get("RDT_TRAIN_REMAT"))).lower()
        return parse_remat_policy(spec)

    def _use_seq(self, mesh: Optional[Mesh]) -> bool:
        """Does THIS fit split the batch's dim 1 over the mesh's seq axis?
        Auto-on when the mesh has a >1 seq extent; ``seq_sharded=False``
        opts out (and True without a seq extent stays off — there is
        nothing to split over)."""
        if mesh is None or seq_extent(mesh) <= 1:
            return False
        return True if self.seq_sharded is None else bool(self.seq_sharded)

    def _make_forward(self, model: nn.Module, mesh: Optional[Mesh] = None
                      ) -> Tuple[Callable, int, str]:
        """THIS fit's forward and the step's knobs around it — one source
        shared by ``fit`` and ``partial_fit``: ``(apply_fn, step_accum,
        remat_mode)``; publishes ``train_accum_steps`` (and, for a
        :class:`PipelineModel`, ``train_pipeline_stages``).

        A monolithic model runs under the policy's mode for its dominant
        parameter role, ``accum`` microbatches a step. A
        :class:`PipelineModel` trains through the GPipe schedule over
        ``mesh``'s stage axis (a world-1 mesh: one stage) with the
        ``accum`` microbatches as the pipeline's, so the step runs with
        accum 1 and no remat around the forward: each segment (``embed``,
        ``stage_stack``, ``head``) runs under its own role's mode inside
        it."""
        accum = self._resolve_accum()
        policy = self._resolve_remat()
        rdt_metrics.set_gauge("train_accum_steps", accum)
        if mesh is None:
            mesh = Mesh(as_mesh_spec(self._mesh_spec).sizes(1))
        seq_mesh = mesh if self._use_seq(mesh) else None
        pipe = _pipeline_model(model)
        if pipe is None:
            mode = remat_mode_for_role(policy, segment_role(model))
            return (_make_apply(self._split_batch, self.compute_dtype, mode,
                                seq_mesh), accum, mode)
        seg_modes = {name: remat_mode_for_role(policy, segment_role(sub))
                     for name, sub in (("embed", pipe.embed),
                                       ("stage_stack", pipe.stage_stack),
                                       ("head", pipe.head))
                     if sub is not None}
        pipe.schedule = (mesh, accum, seg_modes)
        rdt_metrics.set_gauge("train_pipeline_stages", stage_extent(mesh))
        return (_make_apply(self._split_batch, self.compute_dtype,
                            seq_mesh=seq_mesh), 1, "none")

    # ------------------------------------------------------------------ build
    def _init_state(self, graphed: bool = False,
                    mesh: Optional[Mesh] = None) -> TrainState:
        """A fresh model (a copy of ``model``, or ``model_creator()``) placed
        on the fit's device under the ``train:place`` span — as this rank's
        shards of ``mesh`` when given (:class:`ShardedModule`) — and its
        optimizer from the factory over them, made capturable on CUDA
        (``graphed``: the fit will capture its steps); the
        ``train_param_bytes_per_process`` gauge is read after it."""
        with profiler.trace("train:place", "training"):
            model = copy.deepcopy(self._model) if self._model is not None \
                else self._model_creator()
            model = model.to(self.device)
            if mesh is not None:
                # before the stage split, which leaves each rank its run
                _check_pipeline(model, mesh.shape)
                model = ShardedModule(model, mesh, self.param_rules)
            factory = self._optimizer or self._optimizer_creator \
                or _default_optimizer
            optimizer = factory(model.parameters())
            if self.device.type == "cuda":
                prepare_optimizer(optimizer, graphed)
        rdt_metrics.set_gauge("train_param_bytes_per_process",
                              addressable_nbytes((model, optimizer)))
        return TrainState(model, optimizer,
                          specs=None if mesh is None else model.specs)

    def _columns(self) -> Dict:
        if self.columns_spec is not None:
            return self.columns_spec
        if not self.feature_columns or self.label_column is None:
            raise ValueError("pass feature_columns + label_column or columns_spec")
        return {
            "features": (self.feature_columns, self.feature_dtype),
            "label": (self.label_column, self.label_dtype),
        }

    def _split_batch(self, batch: Dict):
        if self.batch_preprocessor is not None:
            return self.batch_preprocessor(batch)
        return batch["features"], batch["label"]

    # -------------------------------------------------------------------- fit
    def fit(self, train_ds, evaluate_ds=None, max_retries: int = 0
            ) -> TrainingResult:
        """Train in this process: on a world-1 mesh (a ``mesh_spec`` with an
        extent above 1 raises the reference's ``ValueError``; sharded fits
        are :meth:`fit_gang`'s), or over ``mesh`` when one spanning the
        ranks of the caller's process group was passed (every rank calls
        ``fit`` with the same datasets)."""
        if self._mesh is not None:
            mesh = self._build_mesh()
            if mesh.size > 1:
                import torch.distributed as dist

                # one directory for every rank: rank 0's
                made = [tempfile.mkdtemp(prefix="rdt-ckpt-")
                        if not self.checkpoint_dir and mesh.rank == 0
                        else None]
                dist.broadcast_object_list(made, src=0)
                ckpt_dir = self.checkpoint_dir or made[0]
                ckpt.ensure_shared_dir(ckpt_dir, "rdt_ckpt_dir_probe")
                state, history, dispatch = self._fit_on_mesh(
                    mesh, train_ds, evaluate_ds, ckpt_dir, resume=False,
                    max_retries=max_retries)
                self._result = TrainingResult(state=state, history=history,
                                              checkpoint_dir=ckpt_dir,
                                              dispatch=dispatch)
                return self._result
        else:
            # the reference's ValueError for sizes that need more devices
            as_mesh_spec(self._mesh_spec).sizes(1)
        columns = self._columns()
        ckpt_dir = self.checkpoint_dir or tempfile.mkdtemp(prefix="rdt-ckpt-")

        # device-resident fast path: the dataset in device memory, batches
        # sliced (or gathered by a per-epoch permutation) on the device;
        # falls back to the streaming feed when too large or ragged-batch
        cache = feed = None
        if DeviceEpochCache.eligible(train_ds, columns, self.batch_size,
                                     self.drop_last):
            cache = DeviceEpochCache(train_ds, columns, device=self.device)
        if cache is None:
            feed = DeviceFeed(train_ds, self.batch_size, columns,
                              device=self.device, shuffle=self.shuffle,
                              seed=self.seed, drop_remainder=self.drop_last,
                              prefetch_to_device=self.prefetch_to_device)
        eval_feed = eval_cache = None
        if evaluate_ds is not None:
            # one device: the ragged final eval batch runs as it is (the
            # reference pads and masks it only under a >1 data or stage
            # extent). Eval goes resident alongside the train set when
            # train + eval residency together stay under the cap
            if (cache is not None
                    and DeviceEpochCache.eligible(evaluate_ds, columns,
                                                  1, True)
                    and cache.nbytes + DeviceEpochCache.estimate_bytes(
                        evaluate_ds, columns) <= DeviceEpochCache.cap_bytes()):
                eval_cache = DeviceEpochCache(evaluate_ds, columns,
                                              device=self.device)
            else:
                eval_feed = DeviceFeed(evaluate_ds, self.batch_size, columns,
                                       device=self.device, shuffle=False,
                                       drop_remainder=False,
                                       prefetch_to_device=self.prefetch_to_device)

        state, history, dispatch = self._train_loop(
            feed, eval_feed, ckpt_dir, max_retries=max_retries, cache=cache,
            eval_cache=eval_cache)
        self._result = TrainingResult(state=state, history=history,
                                      checkpoint_dir=ckpt_dir,
                                      dispatch=dispatch)
        return self._result

    # --------------------------------------------------------------- fit_gang
    def fit_gang(self, train_ds, evaluate_ds=None, *, num_workers: int = 2,
                 max_retries: int = 0, job_name: Optional[str] = None,
                 run_timeout: float = 3600.0,
                 start_timeout: float = 180.0,
                 worker_env: Optional[Dict[str, str]] = None
                 ) -> TrainingResult:
        """Train as a gang of ``num_workers`` rank processes under one
        ``torch.distributed`` process group (``flax_estimator.py:1271-1364``,
        parity: ``TorchTrainer`` + ``ScalingConfig(num_workers)`` +
        ``FailureConfig(max_failures)``).

        Each rank rebuilds the datasets from the object store (they must be
        store-backed: ``portable()``), feeds its slice of every global batch
        and runs the same train loop (see the module docstring for the
        step). The backend follows the gang's rule
        (:func:`~raydp_tpu_torch.spmd.job.gang_backend`): on CUDA, when the
        node has a card for every rank, each rank takes one (``nccl``, the
        chains captured as CUDA graphs, sharded or replicated); otherwise
        the ranks share the visible cards, or run on the CPU, under
        ``gloo`` (every step eager). A dead or failing rank fails the whole
        gang; the driver then ends every rank (survivors blocked in a
        collective included) and restarts it, and every rank resumes from
        the last checkpoint — up to ``max_retries`` restarts. Afterwards
        ``predict``, ``get_model``, ``export_serving`` and ``partial_fit``
        work as after ``fit``: the chief's trained state is loaded into a
        model here, and this process's ``train_accum_steps`` and
        ``train_pipeline_stages`` gauges take the chief's values.

        ``worker_env`` adds/overrides rank-process environment (a ``None``
        value removes the variable).

        ``mesh_spec`` lays the ranks out as a mesh (its sizes must multiply
        to ``num_workers``; the default is ``data=num_workers``, the
        replicated gang); each rank builds it, and a ``fsdp``, ``expert``
        or ``tensor`` extent above 1 shards the model (see the module
        docstring). A driver-built ``mesh`` is refused: the mesh spans the
        ranks' process group.

        **Shared storage requirement**: on a multi-machine gang,
        ``checkpoint_dir`` must be a filesystem mounted on every rank's
        host (rank 0 writes the step dirs every rank restores from). The
        default — a driver-local temp dir — only works when all ranks share
        the driver's machine; ranks that cannot see the directory fail fast
        at startup with a clear error.
        """
        import uuid

        from raydp_tpu_torch.spmd.job import create_spmd_job

        if self._mesh is not None:
            raise ValueError("fit_gang builds its mesh inside the ranks; "
                             "pass mesh_spec instead of a driver-built mesh")
        # the layout, the step's knobs and the placement, checked before
        # any rank starts
        sizes = as_mesh_spec(self._mesh_spec).sizes(num_workers)
        self._resolve_accum()
        self._resolve_remat()
        if self._model is not None:
            _check_pipeline(self._model, sizes)
        ckpt_dir = self.checkpoint_dir or tempfile.mkdtemp(prefix="rdt-gang-")
        if self.checkpoint_dir:
            # gang ranks run with resume=True by design (the restart loop
            # below depends on it), so THIS is the one path where a fresh fit
            # pointed at a reused dir silently ADOPTS the earlier run's
            # latest step — warn before the ranks start
            ckpt.warn_if_reused_dir(ckpt_dir)
        train_payload = train_ds.portable()
        eval_payload = evaluate_ds.portable() if evaluate_ds is not None \
            else None

        # the ranks get a copy without this process's tensors: the model as
        # a CPU module (a CUDA tensor would pickle as one), no result
        est = copy.copy(self)
        est._result = None
        est.__dict__.pop("_online", None)
        est.checkpoint_dir = ckpt_dir
        if self._model is not None:
            est._model = copy.deepcopy(self._model).cpu()
        cards = torch.cuda.device_count() if self.device.type == "cuda" else 0
        gpus_per_process = 1 if 0 < num_workers <= cards else 0

        def _rank_fit(ctx):
            return est._gang_rank_fit(ctx, train_payload, eval_payload,
                                      ckpt_dir)

        job = create_spmd_job(job_name or f"torchfit-{uuid.uuid4().hex[:6]}",
                              num_workers, torch_distributed=True,
                              env=worker_env, timeout=start_timeout,
                              gpus_per_process=gpus_per_process)
        attempts = 0
        while True:
            try:
                job.start()
                results = job.run(_rank_fit, timeout=run_timeout)
                job.stop()
                break
            except (KeyboardInterrupt, SystemExit):
                job.stop()
                raise
            except Exception as e:  # noqa: BLE001 - gang restart (FailureConfig)
                job.stop()
                attempts += 1
                if attempts > max_retries:
                    raise
                logger.warning("gang fit failed (%s); restarting gang from "
                               "last checkpoint (retry %d/%d)",
                               e, attempts, max_retries)

        chief = results[0]
        for name, value in chief["gauges"].items():
            rdt_metrics.set_gauge(name, value)
        state = self._init_state()
        state.load_state_dict(chief["state"])
        state.specs = chief["specs"]
        self._result = TrainingResult(state=state, history=chief["history"],
                                      checkpoint_dir=ckpt_dir,
                                      dispatch=chief["dispatch"],
                                      ranks=[r["rank"] for r in results])
        return self._result

    def _gang_rank_fit(self, ctx, train_payload, eval_payload,
                       ckpt_dir: str) -> Dict[str, Any]:
        """Runs inside each SPMD rank (``flax_estimator.py:1366-1428``, the
        reference's ``train_func`` body): the mesh over the gang, the
        rank's feeds and the train loop with ``resume``; rank 0 returns the
        trained state, gathered whole, on the host."""
        from raydp_tpu_torch.data.dataset import DistributedDataset

        # the rank's own process: its TF32 switches, and its card
        self.device = resolve_device(self.device)
        if self.device.type == "cpu":
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // ctx.world_size))
        mesh = self._build_mesh()
        # checkpoints assume ONE filesystem: every rank writes its shards
        # into the step dirs every rank restores from — fail fast on
        # per-host paths
        ckpt.ensure_shared_dir(ckpt_dir, "rdt_ckpt_dir_probe")
        train_ds = DistributedDataset.from_portable(train_payload)
        eval_ds = DistributedDataset.from_portable(eval_payload) \
            if eval_payload is not None else None
        state, history, dispatch = self._fit_on_mesh(
            mesh, train_ds, eval_ds, ckpt_dir, resume=True, max_retries=0)
        out: Dict[str, Any] = {"history": history, "dispatch": dispatch}
        cuda = self.device.type == "cuda"
        out["rank"] = {
            "backend": torch.distributed.get_backend(),
            "param_bytes": addressable_nbytes((state.model, state.optimizer)),
            "memory_allocated": torch.cuda.memory_allocated(self.device)
            if cuda else None,
            "max_memory_allocated":
                torch.cuda.max_memory_allocated(self.device) if cuda
                else None,
            "local_shapes": {n: tuple(p.shape) for n, p in
                             state.model.state_dict().items()}}
        # the fit's geometry, which the driver's gauges then report
        gauges = rdt_metrics.snapshot()["gauges"]
        out["gauges"] = {g: gauges[g][""] for g in
                         ("train_accum_steps", "train_pipeline_stages")
                         if "" in gauges.get(g, {})}
        whole = state.state_dict()
        if isinstance(state.model, ShardedModule):
            # a collective: every rank takes part
            whole = state.model.gather_state(whole, state.optimizer)
        if ctx.rank == 0:
            # as host tensors (numpy has no bf16)
            out["state"] = ckpt.map_tensors(
                lambda _, t: t.detach().cpu(), whole)
            out["specs"] = state.specs
        return out

    def _fit_on_mesh(self, mesh: Mesh, train_ds, eval_ds, ckpt_dir: str,
                     resume: bool, max_retries: int):
        """The train loop of one rank of ``mesh``: the streaming feed over
        this rank's block of every global batch
        (:func:`process_local_batch_rows`; a rank never takes the resident
        cache). The ragged train tail pads and masks when ``drop_last`` is
        off, the eval tail always (``RDT_TRAIN_PAD_TAIL``), so every row
        counts once."""
        columns = self._columns()
        rows = process_local_batch_rows(mesh, self.batch_size)
        seq = (axis_index(mesh, "seq"), seq_extent(mesh)) \
            if self._use_seq(mesh) else None
        pad = bool(knobs.get("RDT_TRAIN_PAD_TAIL")) \
            and _loss_takes_mask(self._loss)
        feed = DeviceFeed(
            train_ds, self.batch_size, columns, device=self.device,
            prefetch_to_device=self.prefetch_to_device,
            host_iter=GangShardIterator(
                train_ds, self.batch_size, mesh.size, mesh.rank, columns,
                shuffle=self.shuffle, seed=self.seed,
                pad_remainder=pad and not self.drop_last, row_range=rows,
                seq_split=seq))
        eval_feed = None
        if eval_ds is not None:
            eval_feed = DeviceFeed(
                eval_ds, self.batch_size, columns, device=self.device,
                prefetch_to_device=self.prefetch_to_device,
                host_iter=GangShardIterator(
                    eval_ds, self.batch_size, mesh.size, mesh.rank,
                    columns, shuffle=False, seed=self.seed,
                    pad_remainder=pad, row_range=rows, seq_split=seq))
        return self._train_loop(feed, eval_feed, ckpt_dir,
                                max_retries=max_retries, resume=resume,
                                mesh=mesh)

    def _train_loop(self, feed, eval_feed, ckpt_dir: str,
                    max_retries: int = 0, cache=None, eval_cache=None,
                    resume: bool = False, mesh: Optional[Mesh] = None):
        """The epochs. ``resume`` (a gang rank's): restore the latest
        checkpoint in ``ckpt_dir`` before the first epoch, and on a retry
        restore the latest one there, whoever wrote it. ``mesh``: this
        process is a rank of a process group laid out as ``mesh`` — the
        step sums its gradient over the ranks that saw other rows,
        BatchNorm takes the global batch's statistics, the epoch's sums are
        summed over those ranks, a ``fsdp``/``expert``/``tensor``/``stage``
        extent above 1 shards the model, and the checkpoints are the
        gang's. Chains are captured unless the gang runs under ``gloo``
        (:func:`graphs_allowed`, decided before the first step)."""
        if self.checkpoint_dir and not resume:
            ckpt.warn_if_reused_dir(ckpt_dir)
        loss_fn = _resolve_loss(self._loss)
        metrics = self._metrics
        device = self.device
        chain = self.steps_per_dispatch if cache is None else 1
        in_gang = mesh is not None
        sharded = _sharded(mesh)
        batch_group = mesh.group(data_axes(mesh)) if in_gang else None
        # the optimizer steps in a graph on the resident and chained paths,
        # unless a gloo gang's collectives keep every step eager
        capture = graphs_allowed(mesh)
        graphed = device.type == "cuda" and capture \
            and (cache is not None or chain > 1)

        def fresh_state() -> TrainState:
            state = self._init_state(graphed, mesh if sharded else None)
            if in_gang:
                gang.sync_batchnorm(state.model, batch_group)
            return state

        state = fresh_state()
        apply_fn, accum, mode = self._make_forward(state.model, mesh)
        pipelined = _pipeline_model(state.model) is not None
        train_step = _make_train_step(apply_fn, loss_fn, metrics, accum,
                                      in_gang, batch_group)
        eval_step = _make_eval_step(apply_fn, loss_fn, metrics)
        # a capture is timed and its activation bytes published (the
        # reference's compile span) only when accumulation, remat or the
        # pipeline is engaged, as the reference reads its memory analysis;
        # an eager pipelined fit times its first step under the span
        span = "train:pipeline" if pipelined else \
            "train:accum" if accum > 1 or mode != "none" else None

        acc = Accumulators(metrics, device)
        eacc = Accumulators(metrics, device, count=True)
        plan = cache.make_epoch(self.batch_size, self.shuffle) \
            if cache is not None else None
        eval_plan = eval_tail = None
        if eval_cache is not None:
            # the eval pass over the resident rows, then the ragged tail as
            # one more (smaller) batch, eagerly
            eval_plan = eval_cache.make_epoch(self.batch_size, shuffle=False)
            tail_off = eval_plan.steps * self.batch_size
            if eval_cache.num_rows > tail_off:
                eval_tail = {n: a[tail_off:]
                             for n, a in eval_cache.arrays.items()}

        def bind(state):
            """The steps and runners over ``state``; built again after a
            restore replaces the optimizer's tensors that a graph holds."""
            step = _in_place(train_step, state, acc)
            estep = _in_place_eval(eval_step, state, eacc)
            train = None
            if plan is not None:
                train = StepRunner(lambda _: step(plan.next_batch()), device,
                                   "resident train step",
                                   optimizer=state.optimizer, span=span)
            elif chain > 1 and capture:
                train = StepRunner(_chain(step), device,
                                   f"{chain}-step train chain",
                                   optimizer=state.optimizer, span=span,
                                   quiesce=feed.placement_lock)
            evals = None
            if eval_plan is not None:
                evals = StepRunner(lambda _: estep(eval_plan.next_batch()),
                                   device, "resident eval step")
            if pipelined and train is None:
                step = _traced_once(step, span)
            return step, estep, train, evals

        step, estep, run_train, run_eval = bind(state)
        history: List[Dict[str, float]] = []
        dispatch: List[Dict[str, float]] = []
        epoch = 0
        retries = 0
        #: highest checkpoint step THIS run wrote — a retry may only restore
        #: up to it; a reused dir's stale steps (possibly HIGHER-numbered,
        #: which latest-step selection would otherwise prefer) are foreign
        last_written_step: Optional[int] = None

        def adopt(max_step: Optional[int]) -> bool:
            """Restore the latest checkpoint in ``ckpt_dir`` (at or below
            ``max_step``) into ``state``, with its epoch and history, and
            bind the steps again; whether there was one."""
            nonlocal epoch, history, step, estep, run_train, run_eval
            restored = ckpt.restore(
                ckpt_dir, state.state_dict(), max_step=max_step,
                layout=_layout(state, mesh) if sharded else None)
            if restored is None:
                return False
            saved, done_epoch = restored
            state.load_state_dict(saved)
            epoch = done_epoch + 1
            extra = ckpt.restore_extra(ckpt_dir, max_step=max_step)
            if extra and "history" in extra:
                history = list(extra["history"])
            # the optimizer's restored state is new tensors: warm up and
            # capture again
            step, estep, run_train, run_eval = bind(state)
            return True

        if resume and ckpt.latest_step(ckpt_dir) is not None:
            # a fresh optimizer has no state yet: make it, so that the
            # restore overwrites every tensor of it
            _materialize_optimizer_state(state)
            if adopt(None):
                logger.info("resuming from checkpoint step %d", epoch - 1)
        times = DispatchTimes(device) if device.type == "cuda" else None
        while epoch < self.num_epochs:
            try:
                rule = faults.check("estimator.epoch", key=str(epoch))
                if rule is not None:  # chaos provokes the retry path here
                    faults.apply(rule, "estimator.epoch")
                # spans and the card's dispatch times only while a torch
                # profiler runs: read once an epoch
                on = profiler.tracing()
                events = times if on else None
                if events is not None:
                    events.begin()
                if run_train is not None:
                    run_train.events = events
                #: the epoch report's walls: sums of the loop's timed spans
                walls = profiler.Walls(("feed", "dispatch", "sync"))
                first = None  # the first dispatch's start
                with profiler.timed("train:epoch", on, ring=True,
                                    epoch=epoch) as ep:
                    gang.COMM.take()
                    acc.reset()
                    before = _counts(run_train, run_eval)
                    steps, samples, eager_steps = 0, 0, 0
                    if plan is not None:
                        plan.begin(epoch_seed(self.seed, epoch))
                        for _ in range(plan.steps):
                            with profiler.timed("train:dispatch", on, walls,
                                                "dispatch") as d:
                                run_train({})
                            if first is None:
                                first = d.t0
                        # the loss read INSIDE the dispatch wall, so
                        # dispatch_time_s carries the epoch's device time
                        with profiler.timed("train:sync", on, walls,
                                            "dispatch"):
                            acc.loss.item()
                        steps = plan.steps
                        samples = plan.steps * self.batch_size
                    else:
                        feed.set_epoch(epoch)
                        it = feed.chained(chain)
                        while True:
                            with profiler.timed("train:feed_wait", on, walls,
                                                "feed"):
                                item = next(it, None)
                            if item is None:
                                break
                            stack, k = item
                            with profiler.timed("train:dispatch", on, walls,
                                                "dispatch") as d:
                                if run_train is not None:
                                    run_train(stack, n_steps=k)
                                else:
                                    if events is not None:
                                        events.start()
                                    if chain > 1:
                                        _chain(step)(stack)
                                    else:
                                        step(stack)
                                    if events is not None:
                                        events.end(k)
                                    eager_steps += k
                            if first is None:
                                first = d.t0
                            steps += k
                            samples += self.batch_size * k
                    if run_train is not None:
                        run_train.flush()
                    # the one host read of the epoch's loss: it waits for
                    # the device, so the epoch wall includes the device
                    # work; a gang first sums its ranks' shares
                    with profiler.timed("train:sync", on, walls, "sync"):
                        if in_gang:
                            _all_reduce_sums(acc, batch_group)
                        train_loss = float(acc.loss) / steps if steps \
                            else math.nan
                dt = ep.dt
                wall = walls.take()
                # the card's idle before the epoch's first dispatch: the
                # last epoch ended in a loss read that waited for it
                timing = {"lead_s": first - ep.t0 if first is not None
                          else dt}
                if events is not None:
                    timing.update(events.read())
                rdt_metrics.observe("train_epoch_seconds", dt)
                # the optimizer makes its state at its first step
                rdt_metrics.set_gauge(
                    "train_param_bytes_per_process",
                    addressable_nbytes((state.model, state.optimizer)))
                # the feed's thread-side phase split (decode/stage/h2d):
                # these walls OVERLAP dispatch by design
                pipe = feed.timings.take() if feed is not None else {}
                report = {
                    "epoch": epoch,
                    "train_loss": train_loss,
                    "steps": steps,
                    "samples_per_s": samples / dt if dt > 0 else 0.0,
                    "epoch_time_s": dt,
                    "feed_time_s": wall["feed"],
                    "decode_time_s": pipe.get("decode", 0.0),
                    "stage_time_s": pipe.get("stage", 0.0),
                    "h2d_time_s": pipe.get("h2d", 0.0),
                    "dispatch_time_s": wall["dispatch"],
                    "sync_time_s": wall["sync"],
                }
                for m, s in zip(metrics, acc.stats):
                    report[f"train_{m.name}"] = m.compute(_host_stats(s))

                if eval_feed is not None or eval_plan is not None:
                    with profiler.timed("train:eval", on):
                        eacc.reset()
                        if eval_plan is not None:
                            eval_plan.begin(0)  # unused: shuffle=False
                            for _ in range(eval_plan.steps):
                                run_eval({})
                            if eval_tail is not None:
                                estep(eval_tail)
                        else:
                            for batch in eval_feed:
                                estep(batch)
                        if in_gang:
                            _all_reduce_sums(eacc, batch_group)
                        rows = float(eacc.count)  # real rows only
                    report["eval_loss"] = (float(eacc.loss) / rows) if rows \
                        else math.nan
                    for m, s in zip(metrics, eacc.stats):
                        report[f"eval_{m.name}"] = m.compute(_host_stats(s))
                if in_gang:
                    # the host wall of the epoch's collectives called
                    # eagerly: all of them under gloo; under nccl only the
                    # time to enqueue them, and a captured one counts once,
                    # at the capture
                    report["allreduce_time_s"] = gang.COMM.take()

                dispatch.append(_dispatch_record(
                    epoch, before, _counts(run_train, run_eval), eager_steps,
                    timing))
                history.append(report)
                for cb in self.callbacks:
                    cb(report)
                logger.info("epoch %d: %s", epoch,
                            {k: (round(v, 5) if isinstance(v, float) else v)
                             for k, v in report.items()})
                if save_epoch_now(epoch, self.checkpoint_interval,
                                  self.num_epochs):
                    with profiler.timed("train:checkpoint", on):
                        ckpt.save(ckpt_dir, state.state_dict(), step=epoch,
                                  extra={"history": history}, gang=in_gang,
                                  layout=_layout(state, mesh) if sharded
                                  else None)
                    last_written_step = epoch
                epoch += 1
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 - retry path (FailureConfig)
                retries += 1
                if retries > max_retries:
                    raise
                logger.warning("epoch %d failed (%s); restoring from checkpoint "
                               "(retry %d/%d)", epoch, e, retries, max_retries)
                # adopt a checkpoint only if an explicit resume claimed the
                # dir, or THIS run wrote it — and then only up to the step
                # this run wrote (a reused dir's stale higher-numbered steps
                # would otherwise win latest-step selection and silently
                # return an earlier run's model)
                if not ((resume or last_written_step is not None)
                        and adopt(None if resume else last_written_step)):
                    # no checkpoint from this run (a failure before the
                    # first interval save): start over from fresh weights
                    # like a fresh fit
                    state = fresh_state()
                    epoch = 0
                    history = []
                    step, estep, run_train, run_eval = bind(state)

        return state, history, dispatch

    # ------------------------------------------------------------ partial_fit
    def _partial_fit_epoch(self, ds, epoch: int) -> Dict[str, float]:
        """One online update: a single gradient pass over the epoch's rows
        through the streaming ``DeviceFeed``, eagerly (a stream epoch is
        small: no chain, no resident variant, as in the reference). State
        persists on the estimator across epochs; ``self._result`` tracks it
        so ``get_model`` works mid-stream."""
        o = getattr(self, "_online", None)
        if o is None:
            o = self._online_init(ds)
            if o is None:
                # an empty first epoch (a filter matching nothing is routine
                # in streaming) has no rows to start from: report it and keep
                # waiting for rows
                return {"epoch": epoch, "train_loss": math.nan, "steps": 0,
                        "samples_per_s": 0.0, "epoch_time_s": 0.0,
                        "decode_time_s": 0.0, "h2d_time_s": 0.0}
            self._online = o
        # one device: the ragged tail of an epoch trains as it is (the
        # reference pads or drops it only under a >1 data or stage extent)
        feed = DeviceFeed(ds, self.batch_size, o["columns"],
                          device=self.device, shuffle=False,
                          drop_remainder=False,
                          prefetch_to_device=self.prefetch_to_device)
        with profiler.timed("train:epoch", profiler.tracing(), ring=True,
                            epoch=epoch) as ep:
            acc = o["acc"]
            acc.reset()
            steps = 0
            for batch in feed:
                o["step"](batch)
                steps += 1
            train_loss = float(acc.loss) / steps if steps else math.nan
        dt = ep.dt
        pipe = feed.timings.take()
        report = {
            "epoch": epoch,
            "train_loss": train_loss,
            "steps": steps,
            "samples_per_s": (steps * self.batch_size / dt) if dt > 0
            else 0.0,
            "epoch_time_s": dt,
            "decode_time_s": pipe.get("decode", 0.0),
            "h2d_time_s": pipe.get("h2d", 0.0),
        }
        for m, s in zip(self._metrics, acc.stats):
            report[f"train_{m.name}"] = m.compute(_host_stats(s))
        o["history"].append(report)
        self._result = TrainingResult(state=o["state"],
                                      history=o["history"])
        return report

    def _online_init(self, ds) -> Optional[Dict[str, Any]]:
        """The persistent online-training state, from the first epoch with
        rows: the placed model and optimizer and the SAME step body as
        ``fit``'s (accumulation and remat included). None when the epoch
        holds no rows."""
        columns = self._columns()
        first = next(iter(HostBatchIterator(ds, 1, columns, shuffle=False,
                                            drop_remainder=False)), None)
        if first is None:
            return None
        state = self._init_state()
        apply_fn, accum, _ = self._make_forward(state.model)
        train_step = _make_train_step(apply_fn, _resolve_loss(self._loss),
                                      self._metrics, accum)
        acc = Accumulators(self._metrics, self.device)
        return {"columns": columns, "state": state, "acc": acc,
                "step": _in_place(train_step, state, acc), "history": []}

    # ----------------------------------------------------------- fit_on_frame
    def fit_on_frame(self, train_df, evaluate_df=None, *,
                     fs_directory: Optional[str] = None,
                     stop_etl_after_conversion: bool = False,
                     max_retries: int = 0,
                     num_workers: Optional[int] = None) -> TrainingResult:
        """``fit`` on ETL DataFrames (``flax_estimator.py:1430-1453``): the
        frames convert through the object store (or ``fs_directory``'s
        parquet files), optionally with the ETL stopped and the blocks kept
        (``stop_etl_after_conversion``). With ``shuffle`` a streaming fit
        reads the engine's ``random_shuffle(seed)`` of the train set; a
        resident fit skips it, since its per-epoch on-device permutation is
        already a uniform row shuffle. ``num_workers > 1`` trains as a gang
        (:meth:`fit_gang`), which always streams, so a shuffled gang always
        reads the engine's shuffle."""
        train_ds, eval_ds = self._convert_frames(
            train_df, evaluate_df, fs_directory=fs_directory,
            stop_etl_after_conversion=stop_etl_after_conversion)
        in_gang = num_workers is not None and num_workers > 1
        if self.shuffle and (in_gang or not DeviceEpochCache.eligible(
                train_ds, self._columns(), self.batch_size, self.drop_last)):
            train_ds = train_ds.random_shuffle(seed=self.seed)
        if in_gang:
            return self.fit_gang(train_ds, eval_ds, num_workers=num_workers,
                                 max_retries=max_retries)
        return self.fit(train_ds, eval_ds, max_retries=max_retries)

    # ---------------------------------------------------------------- predict
    def predict(self, ds, batch_size: Optional[int] = None) -> np.ndarray:
        """Run the trained model over a dataset and return predictions as
        one host array (row order = dataset block order; the ragged last
        batch included). ``batch_size`` sets the host batches only: every
        forward runs at the estimator's ``batch_size`` rows (:func:`infer`),
        so a row's prediction does not depend on it.

        Works for plain ``feature_columns`` models AND for
        ``batch_preprocessor`` / ``columns_spec`` models (e.g. DLRM): those
        decode the same column spec the train feed used and run the
        preprocessor per batch, exactly like the train step. ANY spec entry
        whose column(s) the dataset lacks (an inference frame's label) is
        synthesized as zeros — the preprocessor's label output is discarded
        anyway.
        """
        model = self.get_model()   # raises if fit() has not run
        custom = self._custom()
        cols = self._predict_columns()
        synth: Dict[str, Tuple[Tuple[str, ...], np.dtype]] = {}
        if custom:
            have = set(ds.schema.names)
            for name, (cspec, dt) in list(cols.items()):
                cnames = (cspec,) if isinstance(cspec, str) else tuple(cspec)
                missing = [c for c in cnames if c not in have]
                if missing and len(missing) < len(cnames):
                    # some of the entry's columns exist and some don't: a
                    # schema mismatch, not a label-less inference frame
                    raise ValueError(
                        f"columns_spec entry {name!r} is partially missing "
                        f"from the dataset schema: missing {missing}")
                if missing:
                    cols.pop(name)
                    synth[name] = (cnames, np.dtype(dt))
                    logger.info("predict: columns_spec entry %r absent from "
                                "the dataset schema; synthesizing zeros",
                                name)
            if not cols:
                raise ValueError(
                    "no columns_spec entry matches the dataset schema "
                    f"{sorted(have)}; cannot synthesize every input")
        it = HostBatchIterator(ds, batch_size or self.batch_size, cols,
                               shuffle=False, drop_remainder=False)
        out = []
        for batch in it:
            rows = len(next(iter(batch.values())))
            for name, (cnames, dt) in synth.items():
                # the decoded shape contract: one column decodes to [rows],
                # several to [rows, n]
                shape = (rows,) if len(cnames) == 1 else (rows, len(cnames))
                batch[name] = np.zeros(shape, dt)
            placed = {k: torch.tensor(v, device=self.device)
                      for k, v in batch.items()}
            out.append(infer(model, placed, self.batch_preprocessor,
                             self.compute_dtype,
                             self.batch_size).cpu().numpy())
        if not out:
            return np.empty((0,), np.float32)
        return np.concatenate(out, axis=0)

    def _custom(self) -> bool:
        return (self.batch_preprocessor is not None
                or self.columns_spec is not None)

    def _predict_columns(self) -> Dict:
        """The column spec inference decodes: the full spec for custom
        models (an absent entry, the label, is synthesized as zeros), else
        ``features`` only."""
        if self._custom():
            return dict(self._columns())
        return {"features": (self.feature_columns, self.feature_dtype)}

    # --------------------------------------------------------- export_serving
    def export_serving(self, export_dir: str) -> str:
        """Write a serving bundle for
        :class:`raydp_tpu_torch.serve.ServingSession`: the trained weights
        through ``train/checkpoint.py`` plus the pickled inference recipe
        (the model on the meta device, column spec, preprocessor, cast
        policy, and ``infer_rows``, the row count of every forward) —
        exactly what :meth:`predict` uses, through the same :func:`infer`,
        so a replica's output is bitwise a driver-side ``predict()``'s,
        however the rows were batched."""
        from raydp_tpu_torch.serve.servable import export_bundle

        model = self.get_model()   # raises if fit() has not run
        bundle = {
            "columns": self._predict_columns(),
            "custom": self._custom(),
            "preprocessor": self.batch_preprocessor,
            "compute_dtype": self.compute_dtype,
            "infer_rows": self.batch_size,
        }
        return export_bundle(export_dir, "torch", bundle, model)

    # -------------------------------------------------------------- get_model
    def get_model(self) -> nn.Module:
        """The trained module, in eval mode (Flax's default ``train=False``),
        with Flax's parameter names."""
        if self._result is None:
            raise RuntimeError("call fit() first")
        return self._result.state.model.eval()

    def get_state(self) -> TrainState:
        """The trained state: the module, its optimizer and, after a
        sharded fit, the specs it was trained under."""
        if self._result is None:
            raise RuntimeError("call fit()/fit_on_frame() first")
        return self._result.state
