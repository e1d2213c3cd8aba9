"""Serving bundles: export a trained estimator, load it anywhere — the
port of :mod:`raydp_tpu.serve.servable`.

``TorchEstimator.export_serving`` writes a self-contained directory

- ``servable.json`` — kind (``"torch"``) + format version, written last and
  atomically: its presence marks a complete bundle;
- ``predict.pkl``  — the cloudpickled inference recipe: the ``nn.Module``
  moved to the ``meta`` device (an architecture without weights, the
  counterpart of the reference's weightless Flax module) and everything
  the estimator's own ``predict()`` uses (column spec, preprocessor, cast
  policy, and ``infer_rows``: every forward runs at that many rows, so a
  served row has ``predict()``'s bits whatever it was coalesced with);
- ``ckpt/``        — the weights written through
  :mod:`raydp_tpu_torch.train.checkpoint` at step 0 (the module's
  ``state_dict`` and its non-persistent buffers), so a bundle restores with
  the machinery a resumed training run trusts,

and :func:`load_servable` rebuilds a :class:`Servable` in any process — the
driver for local checks, or an executor actor as a serving replica
(:mod:`raydp_tpu_torch.serve.replica`) — on the device it is given:
``None`` means CUDA, and raises without it.

A Servable splits inference into the three phases the replica pipeline
overlaps: ``decode`` (Arrow → host arrays), ``place`` (host → device: a
pinned copy on a side stream and the event it records) and ``apply`` (the
forward, ending in the device-to-host copy of the predictions).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import cloudpickle
import numpy as np
import pyarrow as pa
import torch

from raydp_tpu_torch.device import DeviceLike, resolve_device
from raydp_tpu_torch.log import get_logger
from raydp_tpu_torch.train import checkpoint

logger = get_logger("serve.servable")

META_FILE = "servable.json"
BUNDLE_FILE = "predict.pkl"
CKPT_SUBDIR = "ckpt"
FORMAT_VERSION = 2

#: a placed batch: the device tensors and the CUDA event their copy
#: recorded (None on the CPU)
Placed = Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]


def _weights(model: torch.nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """The tensors a bundle stores: the ``state_dict`` and the buffers it
    leaves out (non-persistent ones, e.g. DLRM's interaction indices),
    which the meta-device module does not hold either."""
    state = model.state_dict()
    extra = {name: buf for name, buf in model.named_buffers()
             if name not in state}
    return {"model": state, "buffers": extra}


def export_bundle(export_dir: str, kind: str, bundle: Dict[str, Any],
                  model: torch.nn.Module) -> str:
    """Write a servable directory: the weights of ``model`` through
    ``checkpoint.save`` (step 0 — a bundle is a single immutable export,
    not a training timeline), then the pickled ``bundle`` with ``model``
    moved to the meta device, then the meta file."""
    os.makedirs(export_dir, exist_ok=True)
    checkpoint.save(os.path.join(export_dir, CKPT_SUBDIR), _weights(model),
                    step=0)
    bundle = dict(bundle)
    bundle["model"] = copy.deepcopy(model).to("meta")
    with open(os.path.join(export_dir, BUNDLE_FILE), "wb") as f:
        f.write(cloudpickle.dumps(bundle))
    meta = {"kind": kind, "format_version": FORMAT_VERSION}
    tmp = os.path.join(export_dir, f".{META_FILE}.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f)
    # meta lands last and atomically: its presence marks a complete bundle
    os.replace(tmp, os.path.join(export_dir, META_FILE))
    logger.info("exported %s servable to %s", kind, export_dir)
    return export_dir


class Servable:
    """A loaded model with the three-phase predict pipeline.

    ``predict_table`` chains the phases synchronously; the replica worker
    runs ``decode``+``place`` on a
    :class:`~raydp_tpu_torch.data.feed.DevicePrefetcher` thread so batch
    ``k+1``'s staging and H2D overlap the ``apply`` of batch ``k`` on the
    worker thread."""

    def __init__(self, kind: str, columns: Dict[str, Tuple[Any, Any]],
                 apply_fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                 nbytes: int, device: torch.device):
        self.kind = kind
        #: feed-style column spec: name -> (column(s), dtype)
        self.columns = columns
        self._apply = apply_fn
        #: total weight bytes — the replica load report surfaces it
        self.nbytes = nbytes
        self.device = device
        self._copy_stream: Optional[torch.cuda.Stream] = None

    # -- decode ---------------------------------------------------------------
    def decode(self, table: pa.Table) -> Dict[str, np.ndarray]:
        """Arrow → the host batch dict the apply consumes. Spec entries
        whose column(s) the table lacks wholesale (the label a serving
        request never carries) synthesize as zeros, exactly like
        ``TorchEstimator.predict``; a partially-missing entry is a schema
        mismatch and fails loudly."""
        from raydp_tpu_torch.data.feed import _as_numpy

        have = set(table.schema.names)
        batch: Dict[str, np.ndarray] = {}
        for name, (cspec, dt) in self.columns.items():
            cnames = (cspec,) if isinstance(cspec, str) else tuple(cspec)
            missing = [c for c in cnames if c not in have]
            if missing and len(missing) < len(cnames):
                raise ValueError(
                    f"servable spec entry {name!r} is partially missing from "
                    f"the request schema: missing {missing}")
            if missing:
                shape = ((table.num_rows,) if len(cnames) == 1
                         else (table.num_rows, len(cnames)))
                batch[name] = np.zeros(shape, np.dtype(dt))
            else:
                batch[name] = _as_numpy(table, list(cnames), dt)
        return batch

    # -- place ----------------------------------------------------------------
    def place(self, batch: Dict[str, np.ndarray]) -> Placed:
        """Host batch → device tensors (the H2D phase). On CUDA each array
        is copied into pinned host memory and sent with a ``non_blocking``
        copy on the servable's side stream, whose completion the returned
        event records; :meth:`apply` makes its own stream wait for it."""
        from raydp_tpu_torch.data.feed import torch_dtype

        if self.device.type != "cuda":
            return {n: torch.tensor(a) for n, a in batch.items()}, None
        pinned = {}
        for n, a in batch.items():
            host = torch.empty(a.shape, dtype=torch_dtype(a.dtype),
                               pin_memory=True)
            np.copyto(host.numpy(), a)
            pinned[n] = host
        with torch.cuda.device(self.device):
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream()
            with torch.cuda.stream(self._copy_stream):
                # the caching host allocator keeps each pinned block until
                # the copy reading it has completed
                out = {n: h.to(self.device, non_blocking=True)
                       for n, h in pinned.items()}
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
        return out, ready

    # -- apply ----------------------------------------------------------------
    def apply(self, placed: Placed) -> np.ndarray:
        """The forward pass; returns float32 host predictions, one row per
        input row. The stream of the calling thread waits for the
        placement's copy, and the allocator learns that this stream uses
        the side stream's tensors; the device-to-host copy at the end
        synchronises."""
        tensors, ready = placed
        if ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
            for t in tensors.values():
                t.record_stream(current)
        return self._apply(tensors).cpu().numpy()

    def predict_table(self, table: pa.Table) -> np.ndarray:
        return self.apply(self.place(self.decode(table)))


def _build_torch(bundle: Dict[str, Any], export_dir: str,
                 device: torch.device) -> Servable:
    from raydp_tpu_torch.train.torch_estimator import infer

    model = bundle["model"].to_empty(device=device)
    restored = checkpoint.restore(os.path.join(export_dir, CKPT_SUBDIR),
                                  _weights(model))
    if restored is None:
        raise FileNotFoundError(
            f"servable at {export_dir!r} has no complete checkpoint under "
            f"{CKPT_SUBDIR}/")
    weights = restored[0]
    model.load_state_dict(weights["model"], strict=True)
    with torch.no_grad():
        for name, buf in weights["buffers"].items():
            model.get_buffer(name).copy_(buf)
    model.eval()
    nbytes = sum(t.numel() * t.element_size()
                 for part in weights.values() for t in part.values())
    preprocessor = bundle.get("preprocessor")
    compute_dtype = bundle.get("compute_dtype")
    rows = bundle["infer_rows"]

    def apply_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return infer(model, batch, preprocessor, compute_dtype, rows)

    return Servable("torch", bundle["columns"], apply_fn, nbytes, device)


_BUILDERS = {"torch": _build_torch}


def load_servable(export_dir: str, device: DeviceLike = None) -> Servable:
    """Rebuild a :class:`Servable` from an exported directory on ``device``
    (``None`` means CUDA and raises without it; pass ``"cpu"`` for the
    CPU). The weights restore through ``train/checkpoint.py``, like any
    training resume."""
    dev = resolve_device(device)
    meta_path = os.path.join(export_dir, META_FILE)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"no servable at {export_dir!r} ({META_FILE} missing — was "
            "export_serving() called, and is the path visible on this "
            "machine?)")
    with open(meta_path, "r", encoding="utf-8") as f:
        meta = json.load(f)
    kind = meta.get("kind")
    builder = _BUILDERS.get(kind)
    if builder is None:
        # a 'flax' or 'keras' bundle comes from the JAX package
        raise ValueError(f"cannot load servable kind {kind!r} in "
                         f"{export_dir!r}: this package loads "
                         f"{sorted(_BUILDERS)} bundles")
    with open(os.path.join(export_dir, BUNDLE_FILE), "rb") as f:
        bundle = cloudpickle.loads(f.read())
    return builder(bundle, export_dir, dev)
