"""Serving replica autoscale: queue-depth-driven capacity, shed-free
bursts — the port of :mod:`raydp_tpu.serve.autoscale`.

:class:`ServingAutoscaler` is the serving-plane twin of
:class:`~raydp_tpu_torch.etl.autoscale.PoolAutoscaler` — the same
sustained-window + cooldown controller shape, pointed at
:meth:`ServingSession.serving_report` instead of ``pool.load()``:

- **grow** when dispatch pressure persists for ``RDT_SERVE_SCALE_UP_S``:
  queue depth beyond what the current replicas can hold in flight
  (``replicas × RDT_SERVE_MAX_INFLIGHT``), or the outstanding-request
  count past half of ``RDT_SERVE_MAX_QUEUE`` — the point of scaling on
  queue depth is to add capacity BEFORE the shed path
  (:class:`~raydp_tpu_torch.serve.session.ServingOverloaded`) fires, so the
  half-full admission queue is itself a pressure signal.
- **shrink** when the session has been fully idle (zero queued, zero
  outstanding) for ``RDT_SERVE_SCALE_IDLE_S``, through the retire path —
  drained replicas finish their in-flight dispatches before unloading.
- **hysteresis**: ``RDT_SERVE_SCALE_COOLDOWN_S`` after any event plus the
  sustained windows, so scale-up and the burst it absorbs cannot chase
  each other. Windows update even during the cooldown (a queue that
  builds mid-cooldown acts the moment it ends).

The actuator is :meth:`ServingSession.scale_replicas`, which sets EVERY
live version group to the same count — a mid-rollout canary scales with
the baseline, so it is never capacity-starved into a latency verdict.
Every knob is re-read per tick (the per-action contract of
doc/dev_lint.md).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from raydp_tpu_torch import knobs, metrics
from raydp_tpu_torch.log import get_logger

logger = get_logger("serve.autoscale")

__all__ = ["ServingAutoscaler"]


class ServingAutoscaler:
    """Grow/shrink a serving session's per-version replica counts from its
    dispatch queue depth. Construct via :meth:`ServingSession.autoscale`.
    ``events`` is a bounded in-order record of every scale decision
    ({ts, direction, replicas, reason}) — what the bench and tests
    assert on."""

    def __init__(self, serving, min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None):
        self._serving = serving
        self._min_arg = min_replicas
        self._max_arg = max_replicas
        mn, mx = self._bounds()
        if mx < max(1, mn):
            raise ValueError(
                f"serving autoscale needs max >= min >= 1 (got min={mn}, "
                f"max={mx}); set RDT_SERVE_MAX_REPLICAS or pass "
                "max_replicas=")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cooldown_until = 0.0
        self._pressure_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self.events: List[Dict[str, Any]] = []
        self._events_cap = 256

    # ---- knob views (re-read per tick) --------------------------------------
    def _bounds(self) -> tuple:
        mn = self._min_arg if self._min_arg is not None \
            else int(knobs.get("RDT_SERVE_MIN_REPLICAS"))
        mx = self._max_arg if self._max_arg is not None \
            else int(knobs.get("RDT_SERVE_MAX_REPLICAS"))
        return max(1, mn), mx

    # ---- lifecycle ----------------------------------------------------------
    def start(self) -> "ServingAutoscaler":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"rdt-serve-autoscaler-{self._serving.name}")
        self._thread.start()
        logger.info("serving autoscaler started (min=%d, max=%d)",
                    *self._bounds())
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=30.0)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(
                max(0.05,
                    float(knobs.get("RDT_SERVE_SCALE_INTERVAL_S")))):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 - the controller must survive
                logger.exception("serving autoscale tick failed; continuing")

    # ---- one decision -------------------------------------------------------
    def _tick(self) -> None:
        srv = self._serving
        if srv._closed:
            return
        rep = srv.serving_report()
        now = time.monotonic()
        # the PRIMARY group's replica count is the session's size (the
        # actuator keeps every group at the same count, so any group reads
        # the same — but a mid-scale add lands group by group)
        primary = next((v for v in rep.get("versions", [])
                        if v.get("primary")), None)
        if primary is None:
            return
        replicas = primary["replicas"]
        depth = rep["queue_depth"]
        outstanding = rep["outstanding"]
        capacity = replicas * max(1, rep.get("max_inflight", 1))
        max_queue = rep.get("max_queue", 0)
        mn, mx = self._bounds()
        pressure = depth > capacity or (max_queue > 0
                                        and outstanding >= max_queue // 2)
        # sustained-signal windows update even inside the cooldown, so a
        # burst that builds DURING the cooldown acts the moment it ends
        if pressure:
            self._pressure_since = self._pressure_since or now
            self._idle_since = None
        elif depth == 0 and outstanding == 0:
            self._idle_since = self._idle_since or now
            self._pressure_since = None
        else:
            self._pressure_since = None
            self._idle_since = None
        if now < self._cooldown_until:
            return
        if self._pressure_since is not None and replicas < mx \
                and now - self._pressure_since \
                >= float(knobs.get("RDT_SERVE_SCALE_UP_S")):
            self._grow(replicas, depth, outstanding)
        elif self._idle_since is not None and replicas > mn \
                and now - self._idle_since \
                >= float(knobs.get("RDT_SERVE_SCALE_IDLE_S")):
            self._shrink(replicas)

    def _note(self, direction: str, replicas: int, reason: str) -> None:
        self._cooldown_until = time.monotonic() + \
            float(knobs.get("RDT_SERVE_SCALE_COOLDOWN_S"))
        self._pressure_since = None
        self._idle_since = None
        ev = {"ts": time.time(), "direction": direction,
              "replicas": replicas, "reason": reason}
        self.events.append(ev)
        del self.events[:-self._events_cap]
        metrics.record_event("serve_scale", session=self._serving.name,
                             direction=direction, replicas=replicas,
                             reason=reason)

    def _grow(self, replicas: int, depth: int, outstanding: int) -> None:
        reason = f"queue_depth={depth} outstanding={outstanding}"
        logger.info("serving autoscale: growing %s replicas %d -> %d (%s)",
                    self._serving.name, replicas, replicas + 1, reason)
        try:
            self._serving.scale_replicas(replicas + 1)
        except Exception:  # noqa: BLE001 - retried at the cooldown cadence
            # a failed load (executor mid-restart) pays the cooldown too:
            # a broken control plane is retried at the hysteresis cadence,
            # never every tick
            logger.warning("serving autoscale grow failed", exc_info=True)
            self._note("up-failed", replicas, reason)
            return
        metrics.inc("serve_scaled_up_total")
        self._note("up", replicas + 1, reason)

    def _shrink(self, replicas: int) -> None:
        logger.info("serving autoscale: draining %s replicas %d -> %d "
                    "(idle)", self._serving.name, replicas, replicas - 1)
        try:
            self._serving.scale_replicas(replicas - 1)
        except Exception:  # noqa: BLE001 - retried at the cooldown cadence
            logger.warning("serving autoscale shrink failed", exc_info=True)
            self._note("down-failed", replicas, "idle")
            return
        metrics.inc("serve_scaled_down_total")
        self._note("down", replicas - 1, "idle")
