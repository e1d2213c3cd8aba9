"""Executor-resident serving replicas (the process half of the serving
plane) — the port of :mod:`raydp_tpu.serve.replica`.

One executor actor can host one or more replicas of a servable. Each replica
owns:

- a request queue fed by ``EtlExecutor.serve_predict`` — the dispatcher
  thread only enqueues and returns a
  :class:`~raydp_tpu_torch.runtime.rpc.DeferredReply`, so a slow model can
  never park the actor's bounded RPC dispatch pool (the same rule the
  pipelined shuffle's streaming tasks follow);
- a staging :class:`~raydp_tpu_torch.data.feed.DevicePrefetcher`: Arrow
  decode + pinned host staging + the ``non_blocking`` copy to the device
  for batch ``k+1`` run on the prefetcher thread while the worker thread
  runs the apply of batch ``k`` (the servable's stream and event rules
  order the two threads' work on the card);
- a dedicated worker thread running the applies in arrival order and
  completing each request's Future (which sends the RPC response).

The replica's servable lives on the device the driver asked for
(``None``: CUDA, raising without it): the process takes its CUDA context
here, at the first load, and never before. A load runs one row of zeros
through both threads before the replica takes traffic
(:meth:`_Replica._warm_up`), so no request pays the process's first
batch on the card.

The ``serve.predict`` fault site fires on the worker thread with key
``"<executor name>|<replica id>"`` — ``match=|<replica id>`` pins a chaos
rule to one replica (a seeded straggler for the hedging bench, a crash for
the re-route chaos leg) without touching its siblings.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict

import numpy as np
import pyarrow as pa

from raydp_tpu_torch import faults, knobs, profiler
from raydp_tpu_torch.device import DeviceLike
from raydp_tpu_torch.log import get_logger
from raydp_tpu_torch.serve.servable import Servable, load_servable
from raydp_tpu_torch.serve.session import _encode

logger = get_logger("serve.replica")


class ReplicaNotLoaded(KeyError):
    """``serve_predict`` hit a replica id this process does not hold — the
    executor restarted (fresh process, empty registry) or load never ran.
    The driver keys on this ``exc_type`` to re-route the request through the
    hedge path and reload the replica in the background."""


class _StopItem:
    pass


_STOP = _StopItem()


class _Replica:
    """One loaded servable + its staging pipeline and worker thread."""

    def __init__(self, replica_id: str, export_dir: str, actor_name: str,
                 prefetch: int, device: DeviceLike):
        self.replica_id = replica_id
        self.export_dir = export_dir
        self.actor_name = actor_name
        self.servable: Servable = load_servable(export_dir, device)
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self.batches = 0        # guarded-by: _lock
        self.rows = 0           # guarded-by: _lock
        self.requests = 0       # guarded-by: _lock
        self.apply_s = 0.0      # guarded-by: _lock
        self.queue_peak = 0     # guarded-by: _lock
        self.warm_up_s = 0.0
        self._stopped = False
        self._prefetch = max(1, prefetch)
        self._worker = threading.Thread(
            target=self._serve_loop, daemon=True,
            name=f"rdt-serve-{replica_id}")
        self._worker.start()
        try:
            self._warm_up()
        except BaseException:
            self.stop()
            raise

    def _warm_up(self) -> None:
        """Run one row of zeros through the staging and apply threads
        before the replica takes traffic: a process's first batch on the
        card pays its CUDA modules' loading and each thread's CUDA state,
        which would otherwise land on a live request, a hedge deadline or
        a rollout's judgment. Outside the counters and the fault site;
        ``stats()`` reports its seconds as ``warm_up_s``."""
        t0 = time.perf_counter()
        names = {}
        for cspec, dt in self.servable.columns.values():
            for c in ((cspec,) if isinstance(cspec, str) else cspec):
                names[c] = np.zeros(1, np.dtype(dt))
        fut: Future = Future()
        self._q.put((_encode(pa.table(names)), fut, None, True))
        fut.result()
        self.warm_up_s = time.perf_counter() - t0

    # -- dispatcher side (RPC thread): enqueue only ---------------------------
    def submit(self, payload: bytes) -> Future:
        fut: Future = Future()
        # the RPC dispatcher thread holds the driver's trace context (the
        # serve:batch span); the prefetcher and worker threads that carry
        # this request forward cannot inherit it — capture it into the
        # queue item so the staging decode and the apply trace as
        # children of the driver dispatch
        ctx = profiler.capture()
        with self._lock:
            if self._stopped:
                raise ReplicaNotLoaded(
                    f"replica {self.replica_id} is unloaded")
            self.requests += 1
            depth = self._q.qsize() + 1
            self.queue_peak = max(self.queue_peak, depth)
            # enqueue under the lock: stop() also holds it to append the
            # stop sentinel, so a request can never land BEHIND the
            # sentinel (its future would silently never complete — the
            # queue is unbounded, so the put cannot block here)
            self._q.put((payload, fut, ctx, False))
        return fut

    # -- staging (DevicePrefetcher thread) ------------------------------------
    def _items(self):
        while True:
            item = self._q.get()
            if isinstance(item, _StopItem):
                return
            yield item

    def _stage(self, item):
        """decode + place one request's batch; a per-item failure rides to
        the worker attached to ITS future instead of killing the pipeline."""
        payload, fut, ctx, warm = item
        try:
            with profiler.activate(ctx):
                table = pa.ipc.open_stream(pa.py_buffer(payload)).read_all()
                placed = self.servable.place(self.servable.decode(table))
            return placed, table.num_rows, fut, ctx, warm, None
        except BaseException as e:  # noqa: BLE001 - belongs to this request
            return None, 0, fut, ctx, warm, e

    # -- apply (worker thread) ------------------------------------------------
    def _serve_loop(self) -> None:
        from raydp_tpu_torch.data.feed import DevicePrefetcher

        staged = DevicePrefetcher(
            self._items(), fn=self._stage, depth=self._prefetch,
            name=f"rdt-serve-stage-{self.replica_id}")
        for placed, rows, fut, ctx, warm, err in staged:
            if err is not None:
                fut.set_exception(err)
                continue
            if warm:
                try:
                    fut.set_result(self.servable.apply(placed))
                except BaseException as e:  # noqa: BLE001 - fails the load
                    fut.set_exception(e)
                continue
            try:
                # the chaos plane's serving hook: a delay here models a slow
                # replica (what hedging exists for); a raise fails this one
                # request into the driver's re-route path; a crash is the
                # executor-died case (the actor supervisor restarts the
                # process and the driver reloads the replica)
                rule = faults.check(
                    "serve.predict",
                    key=f"{self.actor_name}|{self.replica_id}")
                if rule is not None:
                    faults.apply(rule, "serve.predict")
                t0 = time.perf_counter()
                with profiler.activate(ctx), \
                        profiler.trace("serve:apply", "serve",
                                       replica=self.replica_id, rows=rows):
                    preds = self.servable.apply(placed)
                dt = time.perf_counter() - t0
                with self._lock:
                    self.batches += 1
                    self.rows += rows
                    self.apply_s += dt
                fut.set_result(preds)
            except BaseException as e:  # noqa: BLE001 - serialize any failure
                fut.set_exception(e)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "replica": self.replica_id,
                "requests": self.requests,
                "batches": self.batches,
                "rows": self.rows,
                "apply_s": round(self.apply_s, 4),
                "queue_peak": self.queue_peak,
                "model_nbytes": self.servable.nbytes,
                "warm_up_s": round(self.warm_up_s, 4),
            }

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            self._q.put(_STOP)


_registry_lock = threading.Lock()
_registry: Dict[str, _Replica] = {}  # guarded-by: _registry_lock


def load(replica_id: str, export_dir: str, actor_name: str,
         device: DeviceLike = None) -> Dict[str, Any]:
    """(Re)load a replica in this process on ``device`` (``None``: CUDA,
    raising without it). Idempotent per (id, dir): a duplicate load of the
    same bundle keeps the live replica (a racing driver-side reload after
    a transient error must not tear down a serving pipeline mid-request);
    a different dir replaces it."""
    prefetch = int(knobs.get("RDT_SERVE_PREFETCH"))
    with _registry_lock:
        old = _registry.get(replica_id)
        if old is not None and old.export_dir == export_dir:
            return old.stats()
    rep = _Replica(replica_id, export_dir, actor_name, prefetch, device)
    with _registry_lock:
        old = _registry.get(replica_id)
        if old is not None and old.export_dir == export_dir:
            # two same-bundle loads raced (a reload probe vs a session
            # init): keep the replica already serving traffic — replacing
            # it would stop a live pipeline mid-request — and retire the
            # fresh idle twin instead
            keep, loser = old, rep
        else:
            _registry[replica_id] = rep
            keep, loser = rep, old
    if loser is not None:
        loser.stop()
    if keep is rep:
        logger.info("loaded serving replica %s from %s (%d weight bytes)",
                    replica_id, export_dir, rep.servable.nbytes)
    return keep.stats()


def predict(replica_id: str, payload: bytes):
    """Enqueue one encoded batch; returns a DeferredReply completing with
    the prediction array. Runs on an RPC dispatcher thread: enqueue only."""
    from raydp_tpu_torch.runtime.rpc import DeferredReply

    with _registry_lock:
        rep = _registry.get(replica_id)
    if rep is None:
        raise ReplicaNotLoaded(
            f"replica {replica_id} is not loaded in this process (executor "
            "restarted, or serve_load never ran here)")
    return DeferredReply(rep.submit(payload))


def unload(replica_id: str) -> bool:
    with _registry_lock:
        rep = _registry.pop(replica_id, None)
    if rep is not None:
        rep.stop()
    return rep is not None


def stats() -> Dict[str, Any]:
    with _registry_lock:
        reps = list(_registry.values())
    return {"replicas": [r.stats() for r in reps]}
