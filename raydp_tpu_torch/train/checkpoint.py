"""Checkpoint save/restore — port of :mod:`raydp_tpu.train.checkpoint`.

The on-disk layout is the reference's own non-orbax format as one process
writes it: ``<ckpt_dir>/step_<n>/shard_0.npz`` holds each tensor's raw bytes
(``a0``, ``a1``, ...), ``manifest_0.json`` maps each tensor's key path to
its entry (``key``, ``arr``, ``index``, ``shape``, ``dtype``), then the JSON
sidecar ``extra.json`` (when given), then the ``COMPLETE`` marker last. A
step dir without ``COMPLETE`` is torn and never restored. Retention keeps
the newest ``_KEEP`` steps at or below the one just written.

The state is any nesting of dicts, lists and tuples (the estimator saves
``{"model": module.state_dict(), "optimizer": optimizer.state_dict()}``).
Tensors are saved; every other leaf (an optimizer's hyperparameters) comes
from the template at restore time, as the reference takes the tree's
structure from its template.

Under a training gang (a ``torch.distributed`` process group) every rank
holds the whole replicated state: :func:`save` with ``gang`` writes on rank
0 only — the
reference's multi-writer format with one writer — and every rank waits at a
barrier until the step is complete, so each rank can then restore it from
the shared directory (:func:`ensure_shared_dir` checks at the gang's start
that every rank sees it). The sharded multi-writer format waits for sharded
state (ROADMAP item 12c).
"""

from __future__ import annotations

import json
import os
import shutil
from collections.abc import Mapping
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

from raydp_tpu_torch.log import get_logger

logger = get_logger("train.checkpoint")

_KEEP = 2


def _is_complete(path: str) -> bool:
    """Only the ``COMPLETE`` marker, written last, makes a step dir
    restorable; a dir with a manifest and no marker (a write cut short) is
    torn — restore must skip it and fall back to the previous step."""
    return os.path.exists(os.path.join(path, "COMPLETE"))


def _step_dirs(ckpt_dir: str, complete_only: bool = True):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                path = os.path.join(ckpt_dir, name)
                if not complete_only or _is_complete(path):
                    out.append((int(name.split("_", 1)[1]), path))
            except ValueError:
                pass
    return sorted(out)


def _latest_agreed(ckpt_dir: str, max_step: Optional[int] = None
                   ) -> Optional[Tuple[int, str]]:
    """The ``(step, path)`` to restore: the latest complete step.

    ``max_step`` bounds the choice: a fresh fit's retry passes the highest
    step it wrote itself, so stale higher-step dirs left in a reused
    checkpoint_dir by an earlier run are never adopted."""
    steps = _step_dirs(ckpt_dir)
    if max_step is not None:
        steps = [s for s in steps if s[0] <= max_step]
    return steps[-1] if steps else None


def warn_if_reused_dir(ckpt_dir: str) -> None:
    """A fresh fit pointed at a dir that already holds ``step_*``
    checkpoints: retention and retry-restore are scoped to THIS run's steps
    (``_latest_agreed(max_step=...)``), but a later ``restore()`` without
    ``max_step`` would silently prefer the foreign higher-numbered steps —
    tell the user the dir is reused up front."""
    steps = _step_dirs(ckpt_dir, complete_only=False)
    if steps:
        logger.warning(
            "checkpoint_dir %r already contains %d step_* checkpoint dir(s) "
            "(latest: step_%d) from an earlier run; this fit will not adopt "
            "them, but a later restore() on this dir would — use a "
            "fresh checkpoint_dir per run to keep runs separate",
            ckpt_dir, len(steps), steps[-1][0])


def ensure_shared_dir(ckpt_dir: str, tag: str) -> None:
    """Gang-startup probe: the chief creates ``ckpt_dir``; every other rank
    must see it after a barrier, else the gang runs on per-host paths and a
    later save/resume deadlocks collectives. Fail fast with a shared-storage
    message instead. Single-process it only creates the dir. ``tag`` names
    the probe in the error (the reference's barrier key)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        os.makedirs(ckpt_dir, exist_ok=True)
        return
    if dist.get_rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
    dist.barrier()
    if not os.path.isdir(ckpt_dir):
        raise RuntimeError(
            f"checkpoint_dir {ckpt_dir!r} is not visible on rank "
            f"{dist.get_rank()}'s machine ({tag}): multi-process gangs need "
            "shared storage for checkpoints — pass a checkpoint_dir on a "
            "filesystem mounted on every rank's host")


def _write_extra(path: str, ckpt_dir: str, step: int, extra: dict) -> None:
    tmp = os.path.join(ckpt_dir, f".extra_{step}.tmp")
    with open(tmp, "w") as f:
        json.dump(extra, f)
    os.replace(tmp, os.path.join(path, "extra.json"))


def _keystr(path: tuple) -> str:
    """``['model']['Dense_0.kernel']``, ``['optimizer']['state'][0]['step']``:
    a leaf's key path, as ``jax.tree_util.keystr`` writes it."""
    return "".join(f"[{k!r}]" for k in path)


def _tensor_leaves(tree: Any, path: tuple = ()
                   ) -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _tensor_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensor_leaves(v, path + (i,))
    elif isinstance(tree, torch.Tensor):
        yield _keystr(path), tree


def map_tensors(fn, tree: Any, path: tuple = ()) -> Any:
    """``tree`` with each tensor leaf replaced by ``fn(keystr, leaf)``."""
    if isinstance(tree, Mapping):
        return {k: map_tensors(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(_keystr(path), tree)
    return tree


def _raw(t: torch.Tensor) -> np.ndarray:
    """Flat uint8 copy of a tensor's bytes (bf16 included: numpy has no
    bf16, so every entry is stored as bytes and re-viewed through the
    manifest's dtype on load)."""
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _entry_tensor(npz, e: dict) -> torch.Tensor:
    raw = torch.from_numpy(npz[e["arr"]].copy())
    return raw.view(getattr(torch, e["dtype"])).reshape(e["shape"])


def _prune(ckpt_dir: str, written_step: int) -> None:
    """Retention: keep the newest ``_KEEP`` steps AT OR BELOW the one just
    written. Bounding at ``written_step`` means stale higher-step dirs in a
    reused directory are left alone (they are foreign data, and pruning
    lower steps in their favor would delete the checkpoint written
    milliseconds earlier while keeping another run's)."""
    steps = [s for s in _step_dirs(ckpt_dir, complete_only=False)
             if s[0] <= written_step]
    for _, old in steps[:-_KEEP]:
        shutil.rmtree(old, ignore_errors=True)


def save(ckpt_dir: str, state: Any, step: int,
         extra: Optional[dict] = None, gang: bool = False) -> str:
    """Write ``state``'s tensors as ``step_<step>`` (replacing a dir of that
    step), then ``extra`` (a JSON-serializable sidecar, e.g. the epoch
    history) and ``COMPLETE``; then prune. Returns the step dir. ``gang``
    (every rank of the process group calls it with the same replicated
    state): rank 0 writes and every rank returns after the barrier that
    follows."""
    import torch.distributed as dist

    if gang:
        path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
        if dist.get_rank() == 0:
            _write(ckpt_dir, state, step, extra)
        dist.barrier()
        return path
    return _write(ckpt_dir, state, step, extra)


def _write(ckpt_dir: str, state: Any, step: int,
           extra: Optional[dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    arrays, manifest = {}, []
    for n, (key, t) in enumerate(_tensor_leaves(state)):
        name = f"a{n}"
        arrays[name] = _raw(t)
        manifest.append({"key": key, "arr": name,
                         "index": [[0, s] for s in t.shape],
                         "shape": list(t.shape),
                         "dtype": _dtype_name(t.dtype)})
    np.savez(os.path.join(path, "shard_0.npz"), **arrays)
    with open(os.path.join(path, "manifest_0.json"), "w") as f:
        json.dump(manifest, f)
    if extra is not None:
        _write_extra(path, ckpt_dir, step, extra)
    open(os.path.join(path, "COMPLETE"), "w").close()
    _prune(ckpt_dir, step)
    return path


def restore(ckpt_dir: str, template: Any, max_step: Optional[int] = None
            ) -> Optional[Tuple[Any, int]]:
    """Restore the latest complete checkpoint (at or below ``max_step``)
    into the structure of ``template``: each tensor leaf comes from the
    checkpoint, on the template leaf's device; every other leaf is the
    template's. Returns ``(state, step)`` or None."""
    latest = _latest_agreed(ckpt_dir, max_step=max_step)
    if latest is None:
        return None
    step, path = latest
    with open(os.path.join(path, "manifest_0.json")) as f:
        entries = {e["key"]: e for e in json.load(f)}
    with np.load(os.path.join(path, "shard_0.npz")) as npz:
        def load(key: str, leaf: torch.Tensor) -> torch.Tensor:
            e = entries.get(key)
            if e is None:
                raise KeyError(f"checkpoint at {path} is missing leaf {key}")
            return _entry_tensor(npz, e).to(leaf.device)

        return map_tensors(load, template), step


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The step of the latest complete checkpoint, or None."""
    latest = _latest_agreed(ckpt_dir)
    return None if latest is None else latest[0]


def restore_extra(ckpt_dir: str, max_step: Optional[int] = None
                  ) -> Optional[dict]:
    """The JSON sidecar of the latest complete checkpoint (at or below
    ``max_step``), or None."""
    latest = _latest_agreed(ckpt_dir, max_step=max_step)
    if latest is None:
        return None
    path = os.path.join(latest[1], "extra.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
