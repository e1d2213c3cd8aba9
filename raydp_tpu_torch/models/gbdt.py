"""Histogram gradient-boosted decision trees on the card — the port of
:mod:`raydp_tpu.models.gbdt`.

The algorithm is the reference's, as dense static-shape tensor programs:

- features are **quantile-binned once** on the host (:func:`make_bins`,
  :func:`apply_bins`, numpy copies); training sees only an ``int32 [n, f]``
  bin matrix, copied to the device once per fit and resident for all of it;
- trees grow **level-wise with a fixed max_depth**: per level, one
  histogram pass over every row (gradient and hessian sums per node,
  feature and bin), a cumulative-sum gain scan (in the order of XLA's
  ``jnp.cumsum``: :func:`scan_bins`), the masked argmax (the first
  maximum, as ``jnp.argmax``) and the row routing;
- multiclass builds the K one-vs-rest trees of a round **together**: the
  class is part of every histogram's segment index, so one pass serves
  all K trees (the reference ``vmap``s tree building over the class axis);
- a "no split" is threshold ``num_bins - 1`` (every row routes left).

**Histograms are deterministic on both devices.** On the CPU a segment sum
is ``index_add_``, which adds each segment's values in row order (bitwise
``jax.ops.segment_sum``'s sums). On CUDA ``index_add_`` adds with atomics
in whatever order the threads arrive, so two fits could choose different
splits; there the keys are sorted (a stable radix sort) and each segment is
reduced by ``torch.segment_reduce`` over the sorted values, a fixed tree of
adds per segment. Two fits on the card give the same bits.

**One boosting round is one CUDA graph.** The reference runs all rounds as
one ``lax.scan`` dispatch. Here one round (every level, unrolled) is a body
that reads the margins and the round index on the device and writes its
tables into preallocated ``[T, ...]`` buffers at that index; on CUDA a
:class:`~raydp_tpu_torch.train.step_graph.StepRunner` runs the first round
eagerly, captures the second and replays it for every later round, and the
tables (and, with an eval set, the per-round metric computed on the device)
come back to the host once, after the last round. Early stopping keeps the
reference's host loop: one sync per round to read the eval margins.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from raydp_tpu_torch.device import DeviceLike, resolve_device
from raydp_tpu_torch.parallel import gang

OBJECTIVES = ("reg:squarederror", "binary:logistic", "multi:softmax",
              "multi:softprob")


@dataclasses.dataclass
class GBDTModel:
    """A fitted forest: per-tree split/leaf tables + binning for inference
    (the reference's fields; :func:`~raydp_tpu_torch.models.convert.gbdt_from_reference`
    carries a reference model across).

    Table shapes: ``[T, nodes]`` for single-output objectives;
    ``[T, K, nodes]`` for multiclass (K trees per boosting round).
    """

    split_feature: np.ndarray   # [T, 2**depth - 1] or [T, K, 2**depth - 1]
    split_bin: np.ndarray       # same leading shape
    leaf_value: np.ndarray      # [T, 2**depth] or [T, K, 2**depth]
    bin_edges: np.ndarray       # [f, num_bins - 1] float32
    base_score: np.ndarray      # scalar, or [K] for multiclass
    max_depth: int
    objective: str
    best_iteration: Optional[int] = None   # set when early stopping fired

    @property
    def num_trees(self) -> int:
        return self.split_feature.shape[0]

    @property
    def num_class(self) -> int:
        return self.leaf_value.shape[1] if self.leaf_value.ndim == 3 else 1

    def predict(self, X: np.ndarray, output_margin: bool = False,
                device: DeviceLike = None) -> np.ndarray:
        """Route ``X``'s rows through the forest on ``device`` (CUDA unless
        ``device="cpu"``; raises without it)."""
        Xb = apply_bins(np.asarray(X, dtype=np.float32), self.bin_edges)
        margin = predict_binned(Xb, self.split_feature, self.split_bin,
                                self.leaf_value, self.max_depth,
                                device=device)
        margin = margin + self.base_score
        if output_margin:
            return margin
        if self.objective == "binary:logistic":
            return 1.0 / (1.0 + np.exp(-margin))
        if self.objective == "multi:softprob":
            e = np.exp(margin - margin.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        if self.objective == "multi:softmax":
            return margin.argmax(axis=1).astype(np.float32)
        return margin


def make_bins(X: np.ndarray, num_bins: int = 256) -> np.ndarray:
    """Per-feature quantile bin edges ``[f, num_bins - 1]`` (host side, once)."""
    qs = np.linspace(0, 1, num_bins + 1)[1:-1]
    return np.quantile(X, qs, axis=0).T.astype(np.float32)


def apply_bins(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """float features → int32 bin indices in ``[0, num_bins)``."""
    out = np.empty(X.shape, dtype=np.int32)
    for j in range(X.shape[1]):
        out[:, j] = np.searchsorted(edges[j], X[:, j], side="left")
    return out


# ---------------------------------------------------------------------------
# device code: every tensor carries the class axis K (1 for single-output
# objectives) — margins and (g, h) are [n, K], tree tables [K, nodes]
# ---------------------------------------------------------------------------

def segment_sums(keys: torch.Tensor, num_segments: int,
                 *values: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-key sums ``[num_segments]`` of each of ``values`` (each shaped
    like ``keys``), deterministic on both devices: ``index_add_`` in row
    order on the CPU; on CUDA one stable sort of the keys shared by every
    value, then ``segment_reduce`` over each value in sorted order."""
    keys = keys.reshape(-1)
    if keys.device.type == "cpu":
        return tuple(v.new_zeros(num_segments).index_add_(0, keys,
                                                          v.reshape(-1))
                     for v in values)
    return _sorted_segment_sums(keys, num_segments, *values)


def _sorted_segment_sums(keys: torch.Tensor, num_segments: int,
                         *values: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The sort-based segment sums (CUDA's path; also callable on the CPU,
    where the tests hold it to ``index_add_``). No host sync: it can be
    captured into a CUDA graph."""
    if num_segments < 2 ** 31:
        keys = keys.to(torch.int32)
    keys, order = torch.sort(keys.reshape(-1), stable=True)
    bounds = torch.arange(num_segments + 1, dtype=keys.dtype,
                          device=keys.device)
    offsets = torch.searchsorted(keys, bounds)
    return tuple(torch.segment_reduce(v.reshape(-1)[order], "sum",
                                      offsets=offsets, unsafe=True,
                                      initial=0.0)
                 for v in values)


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last dim, each one f32 add after the
    other (torch's CPU ``cumsum`` accumulates in f64, its CUDA one in a
    tree)."""
    sums = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        sums.append(sums[-1] + x[..., i])
    return torch.stack(sums, dim=-1)


#: XLA's CPU rewrite of a cumulative reduce-window sums in blocks of 16
_SCAN_BLOCK = 16


def scan_bins(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last dim in the association XLA's
    CPU backend gives ``jnp.cumsum`` (its reduce-window rewrite): sums run
    one after the other within blocks of 16, each block then adds the
    exclusive prefix of the block totals, computed the same way. Bitwise
    ``jnp.cumsum``'s on the CPU, and the same bits on either device; the
    gain scan's order decides near-tied argmaxes."""
    L, block = x.shape[-1], _SCAN_BLOCK
    if L <= block:
        return _sequential_cumsum(x)
    nb = -(-L // block)
    padded = torch.nn.functional.pad(x, (0, nb * block - L))
    within = _sequential_cumsum(padded.reshape(*x.shape[:-1], nb, block))
    before = scan_bins(within[..., -1])
    before = torch.cat([torch.zeros_like(before[..., :1]),
                        before[..., :-1]], dim=-1)
    out = within + before[..., None]
    return out.reshape(*x.shape[:-1], nb * block)[..., :L]


def _grad_hess(pred: torch.Tensor, y: torch.Tensor, onehot, objective: str):
    """(g, h) per row and class, ``[n, K]``; ``onehot`` is the multiclass
    labels' one-hot ``[n, K]`` (made once per fit)."""
    if objective == "binary:logistic":
        p = torch.sigmoid(pred)
        return p - y[:, None], p * (1.0 - p)
    if objective.startswith("multi:"):
        p = torch.softmax(pred, dim=-1)
        return p - onehot, p * (1.0 - p)
    # reg:squarederror — ½(pred − y)²
    return pred - y[:, None], torch.ones_like(pred)


def _at_nodes(table: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """``table[k, node[i, k]]`` for every row i and class k: ``[n, K]``."""
    return table.gather(1, node.T).T


def _build_trees(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor, *,
                 max_depth: int, num_bins: int, learning_rate: float,
                 reg_lambda: float, min_child_weight: float,
                 reduce: Optional[Callable] = None):
    """The K trees of one round for the (g, h) targets ``[n, K]``; returns
    (split features, split bins ``[K, 2**depth - 1]``, leaf values
    ``[K, 2**depth]``, per-row update ``[n, K]``). ``reduce`` sums each
    level's stacked (g, h) histograms, and the leaves' sums, over the ranks
    that hold the other rows (one collective each), so every rank takes the
    same splits."""
    n, f = Xb.shape
    K = g.shape[1]
    dev = Xb.device
    num_leaves = 2 ** max_depth
    klass = torch.arange(K, device=dev)
    feat_ids = torch.arange(f, device=dev)
    node = torch.zeros((n, K), dtype=torch.int64, device=dev)  # level-local
    g_rows = g[:, :, None].expand(n, K, f)
    h_rows = h[:, :, None].expand(n, K, f)
    split_feature, split_bin = [], []
    for depth in range(max_depth):  # static unroll: buffers double per level
        level_nodes = 2 ** depth
        # histograms over (class, node, feature, bin), one pass for all K
        seg = (((klass * level_nodes + node)[:, :, None] * f + feat_ids)
               * num_bins + Xb[:, None, :])
        shape = (K, level_nodes, f, num_bins)
        hist_g, hist_h = segment_sums(seg, int(np.prod(shape)), g_rows,
                                      h_rows)
        hist = torch.stack([hist_g.view(shape), hist_h.view(shape)])
        if reduce is not None:
            hist = reduce(hist)
        GL, HL = scan_bins(hist)
        Gt = GL[..., -1:]
        Ht = HL[..., -1:]
        GR = Gt - GL
        HR = Ht - HL
        gain = (GL * GL / (HL + reg_lambda)
                + GR * GR / (HR + reg_lambda)
                - Gt * Gt / (Ht + reg_lambda))
        ok = (HL >= min_child_weight) & (HR >= min_child_weight)
        gain = torch.where(ok, gain, -torch.inf)
        # bin B-1 keeps everything left — the canonical "no split"
        gain[..., num_bins - 1] = 0.0

        flat = gain.view(K, level_nodes, f * num_bins)
        best = torch.argmax(flat, dim=-1)          # the first maximum
        best_gain = flat.gather(-1, best[..., None])[..., 0]
        no_split = best_gain <= 0.0
        bf = torch.where(no_split, 0, best // num_bins)
        bb = torch.where(no_split, num_bins - 1, best % num_bins)
        split_feature.append(bf)
        split_bin.append(bb)

        go_right = Xb.gather(1, _at_nodes(bf, node)) > _at_nodes(bb, node)
        node = node * 2 + go_right

    leaf_g, leaf_h = segment_sums(klass * num_leaves + node,
                                  K * num_leaves, g, h)
    if reduce is not None:
        leaf_g, leaf_h = reduce(torch.stack([leaf_g, leaf_h]))
    leaf_value = (-leaf_g / (leaf_h + reg_lambda)
                  * learning_rate).float().view(K, num_leaves)
    return (torch.cat(split_feature, dim=1), torch.cat(split_bin, dim=1),
            leaf_value, _at_nodes(leaf_value, node))


def _route(Xb: torch.Tensor, sf: torch.Tensor, sb: torch.Tensor,
           leaves: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Route every row of a binned matrix through one round's K trees
    (tables ``[K, nodes]``, int64 splits) — the single routing walk (also
    the in-graph eval predictor); returns the leaf values ``[n, K]``."""
    n = Xb.shape[0]
    node = torch.zeros((n, sf.shape[0]), dtype=torch.int64, device=Xb.device)
    for depth in range(max_depth):
        at = node + (2 ** depth - 1)
        right = Xb.gather(1, _at_nodes(sf, at)) > _at_nodes(sb, at)
        node = node * 2 + right
    return _at_nodes(leaves, node)


def _eval_metric_value(margin: torch.Tensor, y: torch.Tensor,
                       y_ids: Optional[torch.Tensor],
                       objective: str) -> torch.Tensor:
    """On-device twin of :func:`eval_metric`'s value (same formulas, torch
    ops; ``margin`` ``[n, K]``) — what the fused train+eval loop stores
    every round. KEEP IN SYNC with :func:`eval_metric`."""
    if objective == "binary:logistic":
        m = margin[:, 0]
        p = 1.0 / (1.0 + torch.exp(-m))
        eps = 1e-7
        return -torch.mean(y * torch.log(p + eps)
                           + (1 - y) * torch.log(1 - p + eps))
    if objective.startswith("multi:"):
        e = torch.exp(margin - margin.max(dim=1, keepdim=True).values)
        p = e / e.sum(dim=1, keepdim=True)
        return -torch.mean(torch.log(p.gather(1, y_ids[:, None])[:, 0]
                                     + 1e-7))
    return torch.sqrt(torch.mean((margin[:, 0] - y) ** 2))


def predict_binned(Xb, split_feature, split_bin, leaf_value, max_depth: int,
                   device: DeviceLike = None) -> np.ndarray:
    """Margins without the base score: every tree's leaf values added in
    tree order from zeros (the reference's scan), on ``device`` (CUDA
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    multi = np.ndim(split_feature) == 3
    Xb_t = torch.as_tensor(np.asarray(Xb), device=dev)
    sf, sb, lv = (torch.as_tensor(np.asarray(t), device=dev)
                  for t in (split_feature, split_bin, leaf_value))
    if not multi:
        sf, sb, lv = sf[:, None], sb[:, None], lv[:, None]
    pred = torch.zeros((Xb_t.shape[0], sf.shape[1]), dtype=torch.float32,
                       device=dev)
    for t in range(sf.shape[0]):
        pred = pred + _route(Xb_t, sf[t].long(), sb[t].long(), lv[t],
                             max_depth)
    out = pred.cpu().numpy()
    return out if multi else out[:, 0]


def eval_metric(margin: np.ndarray, y: np.ndarray,
                objective: str) -> Tuple[str, float]:
    """The objective's default metric (xgboost naming).

    KEEP IN SYNC with :func:`_eval_metric_value` (the on-device torch twin
    the fused boosting loop stores)."""
    if objective == "binary:logistic":
        p = 1.0 / (1.0 + np.exp(-margin))
        eps = 1e-7
        return "logloss", float(-np.mean(
            y * np.log(p + eps) + (1 - y) * np.log(1 - p + eps)))
    if objective.startswith("multi:"):
        e = np.exp(margin - margin.max(axis=1, keepdims=True))
        p = e / e.sum(axis=1, keepdims=True)
        rows = np.arange(len(y))
        return "mlogloss", float(-np.mean(
            np.log(p[rows, y.astype(np.int64)] + 1e-7)))
    return "rmse", float(np.sqrt(np.mean((margin - y) ** 2)))


class _Boosting:
    """The fit's device state and its round body: margins ``pred``, the
    round index ``rnd``, the ``[T, K, ...]`` table buffers and, with an
    eval set, its margins and the per-round metric. :meth:`round` reads
    and writes only these tensors, so one capture of it replays every
    round."""

    def __init__(self, Xb, y, w, pred, num_trees: int, build, objective: str,
                 max_depth: int, evals=None):
        dev = Xb.device
        K = pred.shape[1]
        self.Xb, self.y, self.w, self.pred = Xb, y, w, pred
        self.build, self.objective, self.max_depth = build, objective, \
            max_depth
        multi = objective.startswith("multi:")
        self.onehot = (torch.nn.functional.one_hot(y.long(), K).float()
                       if multi else None)
        self.rnd = torch.zeros(1, dtype=torch.int64, device=dev)
        internal, leaves = 2 ** max_depth - 1, 2 ** max_depth
        self.sf = torch.zeros((num_trees, K, internal), dtype=torch.int32,
                              device=dev)
        self.sb = torch.zeros_like(self.sf)
        self.lv = torch.zeros((num_trees, K, leaves), dtype=torch.float32,
                              device=dev)
        self.evals = evals is not None
        if self.evals:
            self.eXb, self.ey, self.emargin = evals
            self.ey_ids = self.ey.long() if multi else None
            self.values = torch.zeros(num_trees, dtype=torch.float32,
                                      device=dev)

    def round(self, _inputs=None) -> None:
        """ONE boosting round — the single copy of the per-round tree math
        (g/h weighting, the K trees, the margin update, the eval margin and
        metric)."""
        g, h = _grad_hess(self.pred, self.y, self.onehot, self.objective)
        g = g * self.w[:, None]
        h = h * self.w[:, None]
        sf, sb, lv, upd = self.build(self.Xb, g, h)
        self.pred.add_(upd)
        self.sf.index_copy_(0, self.rnd, sf[None].to(torch.int32))
        self.sb.index_copy_(0, self.rnd, sb[None].to(torch.int32))
        self.lv.index_copy_(0, self.rnd, lv[None])
        if self.evals:
            self.emargin.add_(_route(self.eXb, sf, sb, lv, self.max_depth))
            value = _eval_metric_value(self.emargin, self.ey, self.ey_ids,
                                       self.objective)
            self.values.index_copy_(0, self.rnd, value[None])
        self.rnd.add_(1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fit_gbdt(
    X: np.ndarray,
    y: np.ndarray,
    *,
    num_trees: int = 100,
    max_depth: int = 6,
    num_bins: int = 256,
    learning_rate: float = 0.3,
    reg_lambda: float = 1.0,
    min_child_weight: float = 1.0,
    objective: str = "reg:squarederror",
    num_class: Optional[int] = None,
    sample_weight: Optional[np.ndarray] = None,
    evals: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    early_stopping_rounds: Optional[int] = None,
    bin_edges: Optional[np.ndarray] = None,
    mesh=None,
    device: DeviceLike = None,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[GBDTModel, np.ndarray, Dict[str, List[float]]]:
    """Fit a forest on ``device`` (CUDA unless ``device="cpu"``; raises
    without it); returns (model, final train margins, evals_result).

    ``evals_result`` holds per-round eval metrics; empty when no ``evals``
    given. With ``early_stopping_rounds`` the loop stops once the eval
    metric has not improved for that many rounds and the forest is
    truncated to the best iteration (recorded on ``model.best_iteration``).

    On CUDA the first round runs eagerly, the second is captured and every
    later one replays the capture. ``timings``, when given, receives the
    fit's wall split: ``binning_s``, ``h2d_s``
    (the copy to the device), ``capture_s``, ``rounds_s`` (the rounds
    without the capture), ``fetch_s`` (tables and margins back to the
    host), ``rounds``, ``graph_replays`` and ``eager_rounds``.

    ``mesh`` (a :class:`~raydp_tpu_torch.parallel.mesh.Mesh` built by
    ``make_mesh`` inside the ranks of a process group, every rank passing
    the same ``X`` and ``y``) shards the rows over its data axes (data ×
    fsdp): they are padded with zero-weight rows to the data extent (they
    add nothing to any histogram or leaf), each rank keeps its block, and
    each level's histograms and the leaves' sums are summed over the data
    ranks with one ``all_reduce`` each, so every rank holds the same split
    tables; the rounds are then captured with their all-reduces under
    ``nccl`` and run eagerly under ``gloo``
    (:func:`~raydp_tpu_torch.train.step_graph.graphs_allowed`). The
    margins returned are every
    row's, gathered from the ranks. On a world-1 mesh the fit is the
    unsharded fit, bit for bit."""
    from raydp_tpu_torch.parallel.mesh import data_axes
    from raydp_tpu_torch.parallel.shard import gather_dim
    from raydp_tpu_torch.train.step_graph import StepRunner, graphs_allowed

    if objective not in OBJECTIVES:
        raise ValueError(
            f"unsupported objective {objective!r}; have {OBJECTIVES}")
    dev = resolve_device(device)
    times = {} if timings is None else timings
    t0 = time.perf_counter()
    multi = objective.startswith("multi:")
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    if bin_edges is None:
        bin_edges = make_bins(X, num_bins)
    Xb = apply_bins(X, bin_edges)
    w = (np.ones(len(y), np.float32) if sample_weight is None
         else np.asarray(sample_weight, np.float32))

    if multi:
        K = int(num_class or int(y.max()) + 1)
        counts = np.bincount(y.astype(np.int64), minlength=K) + 1.0
        base_score = np.log(counts / counts.sum()).astype(np.float32)
    elif objective == "binary:logistic":
        K = 1
        p = float(np.clip(np.average(y, weights=w), 1e-6, 1 - 1e-6))
        base_score = np.float32(np.log(p / (1 - p)))
    else:
        K = 1
        base_score = np.float32(np.average(y, weights=w))
    pred0 = np.broadcast_to(np.asarray(base_score, np.float32), (len(y), K))
    n_orig = len(y)
    rows = data_axes(mesh) if mesh is not None else ()
    ranks = mesh.extent(rows) if mesh is not None else 1
    reduce = None
    if ranks > 1:
        pad = (-n_orig) % ranks
        Xb = np.concatenate([Xb, np.zeros((pad, Xb.shape[1]), Xb.dtype)])
        y = np.concatenate([y, np.zeros(pad, y.dtype)])
        w = np.concatenate([w, np.zeros(pad, w.dtype)])
        pred0 = np.broadcast_to(pred0[:1], (len(y), K))
        per = len(y) // ranks
        mine = slice(mesh.block(rows) * per, (mesh.block(rows) + 1) * per)
        Xb_rank, y, w, pred0 = Xb[mine], y[mine], w[mine], pred0[mine]
        group = mesh.group(rows)

        def reduce(t):
            return gang.all_reduce_(t.contiguous(), group)
    else:
        Xb_rank = Xb

    eval_host = None
    if evals is not None:
        eX, ey = evals
        eXb = apply_bins(np.asarray(eX, np.float32), bin_edges)
        ey = np.asarray(ey, np.float32)
        emargin0 = np.broadcast_to(np.asarray(base_score, np.float32),
                                   (len(ey), K))
        metric_name = eval_metric(emargin0 if multi else emargin0[:, 0], ey,
                                  objective)[0]
        eval_host = (eXb, ey, emargin0)
    times["binning_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    # the bin matrix crosses once and stays resident for the whole fit
    Xb_d, y_d, w_d, pred = (torch.tensor(a, device=dev)
                            for a in (Xb_rank, y, w,
                                      np.ascontiguousarray(pred0)))
    evals_d = None
    if eval_host is not None:
        evals_d = tuple(torch.tensor(np.ascontiguousarray(a), device=dev)
                        for a in eval_host)
    _sync(dev)
    times["h2d_s"] = time.perf_counter() - t0

    def build(Xb_, g, h):
        return _build_trees(Xb_, g, h, max_depth=max_depth,
                            num_bins=num_bins, learning_rate=learning_rate,
                            reg_lambda=reg_lambda,
                            min_child_weight=min_child_weight,
                            reduce=reduce)

    state = _Boosting(Xb_d, y_d, w_d, pred, num_trees, build, objective,
                      max_depth, evals_d)
    # a round whose histograms cross ranks is captured with its
    # all-reduces under nccl, and runs eagerly under gloo
    runner = StepRunner(state.round, dev, "gbdt boosting round",
                        capture=reduce is None or graphs_allowed(mesh))

    evals_result: Dict[str, List[float]] = {}
    best_iteration = None
    fetch = 0.0
    t0 = time.perf_counter()
    if evals is None or early_stopping_rounds is None:
        # no host decision between rounds: every round (with its eval
        # margin and metric) stays on the device until the last
        for _ in range(num_trees):
            runner({})
        rounds = num_trees
        _sync(dev)
        times["rounds_s"] = time.perf_counter() - t0
        keep = rounds
        if evals is not None:
            t1 = time.perf_counter()
            history = [float(v) for v in state.values.cpu().numpy()]
            fetch += time.perf_counter() - t1
            evals_result = {f"eval_{metric_name}": history}
    else:
        # early stopping: the keep/stop decision is host semantics — one
        # sync a round to read the eval margins
        history: List[float] = []
        best, best_round = np.inf, -1
        rounds = 0
        for rnd in range(num_trees):
            runner({})
            rounds += 1
            t1 = time.perf_counter()
            emargin = state.emargin.cpu().numpy()
            fetch += time.perf_counter() - t1
            _, value = eval_metric(emargin if multi else emargin[:, 0],
                                   eval_host[1], objective)
            history.append(value)
            if value < best - 1e-12:
                best, best_round = value, rnd
            if rnd - best_round >= early_stopping_rounds:
                break
        times["rounds_s"] = time.perf_counter() - t0 - fetch
        evals_result = {f"eval_{metric_name}": history}
        # a metric that never improves (NaN/inf) leaves best_round at -1:
        # keep at least the first round rather than an empty forest
        best_round = max(best_round, 0)
        keep = best_round + 1
        best_iteration = best_round
    t0 = time.perf_counter()
    tables = [t[:keep].cpu().numpy() for t in (state.sf, state.sb, state.lv)]
    margins = state.pred
    if reduce is not None:
        margins = gather_dim(margins, 0, rows, mesh)[:n_orig]
    margins = margins.cpu().numpy()
    times["fetch_s"] = fetch + time.perf_counter() - t0
    if not multi:
        tables = [t[:, 0] for t in tables]
        margins = margins[:, 0]
    if keep < rounds:  # truncated: the train margins must match
        margins = base_score + predict_binned(Xb[:n_orig], *tables,
                                              max_depth, device=dev)
    times["capture_s"] = runner.capture_s
    times["rounds_s"] -= times["capture_s"]
    times["rounds"] = rounds
    times["graph_replays"] = runner.replays if runner.graphed else 0
    times["eager_rounds"] = rounds - times["graph_replays"]

    model = GBDTModel(split_feature=tables[0], split_bin=tables[1],
                      leaf_value=tables[2], bin_edges=bin_edges,
                      base_score=np.asarray(base_score),
                      max_depth=max_depth, objective=objective,
                      best_iteration=best_iteration)
    return model, margins, evals_result
