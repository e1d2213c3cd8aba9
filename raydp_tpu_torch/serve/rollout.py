"""Guarded rollouts: canary traffic, metrics-driven judgment,
auto-rollback — the port of :mod:`raydp_tpu.serve.rollout`.

:class:`RolloutController` turns :meth:`ServingSession.hot_swap`'s cliff
(100% of traffic the instant the load lands) into a guarded ramp:

1. **load** — the new servable joins the session as a live version group
   at ``RDT_SERVE_CANARY_WEIGHT`` of dispatch traffic
   (:meth:`ServingSession.load_version`).
2. **ramp** — the weight steps through ``RDT_SERVE_ROLLOUT_RAMP``
   (e.g. ``0.25,0.5,1.0``), holding each step for up to
   ``RDT_SERVE_ROLLOUT_STEP_S`` while the judgment window fills.
3. **judge** — at every poll the canary's per-version error-rate and p99
   (``serving_report()["versions"]`` — the windows the tentpole keeps per
   version precisely so a healthy baseline cannot mask a regressing
   canary) are compared against the baseline's over the SAME step:
   unhealthy when the canary's error rate exceeds the baseline's by more
   than ``RDT_SERVE_ROLLOUT_ERR_TOL``, or its p99 exceeds the baseline's
   by more than ``RDT_SERVE_ROLLOUT_P99_FACTOR``×. Both sides need
   ``RDT_SERVE_ROLLOUT_MIN_SAMPLES`` step-local samples first — a
   one-request blip must not kill a deploy. While the session is
   SHEDDING, judgment is suspended: saturation inflates both versions'
   windows, and rolling back a healthy canary for the pool's overload is
   the false positive this controller exists to not have.
4. **promote or roll back** — a ramp that reaches weight 1.0 healthy is
   promoted through the ordinary swap/retire machinery (the old primary
   drains, then unloads); the FIRST unhealthy verdict rolls back —
   weight→0, the canary group unloads, a typed ``rollout_rollback``
   event + flight-recorder blackbox bundle record why. Rollback is an
   OUTCOME, not an exception: ``run()`` returns a record either way, so
   a ``partial_fit`` loop shipping exports through ``rollout=`` keeps
   training past a bad epoch instead of dying on it.

A step that times out with NEITHER side reaching the min-sample floor
advances vacuously ("insufficient traffic" is no evidence of regression —
an idle session must still be able to deploy); an overall ``timeout``
rolls the whole rollout back. doc/serving.md "Guarded rollouts" documents
the state machine and the failure table rows.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from raydp_tpu_torch import knobs, metrics
from raydp_tpu_torch.log import get_logger
from raydp_tpu_torch.serve.session import ServingError, ServingSession

logger = get_logger("serve.rollout")

__all__ = ["RolloutController"]


def _parse_ramp(spec: str) -> List[float]:
    steps = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        w = float(part)
        if not 0.0 < w <= 1.0:
            raise ValueError(
                f"RDT_SERVE_ROLLOUT_RAMP step {w!r} outside (0, 1]")
        steps.append(w)
    if not steps:
        raise ValueError("RDT_SERVE_ROLLOUT_RAMP is empty")
    if steps != sorted(steps):
        raise ValueError(
            f"RDT_SERVE_ROLLOUT_RAMP must be non-decreasing: {spec!r}")
    return steps


class RolloutController:
    """One guarded deployment of one export (see module docstring).
    Construct-and-``run()``; all knobs are re-read per rollout, so a
    ``partial_fit`` loop picks up retuned thresholds between epochs.

        ctl = RolloutController(srv, "/shared/model-v2", tag="epoch-3")
        outcome = ctl.run()
        outcome["outcome"]  # "promoted" | "rolled_back"

    ``steps`` / ``initial_weight`` / thresholds may be overridden per call
    (tests and the bench pin fast schedules); production uses the knobs."""

    def __init__(self, serving: ServingSession, export_dir: str,
                 tag: Optional[str] = None,
                 timeout: Optional[float] = None,
                 initial_weight: Optional[float] = None,
                 steps: Optional[List[float]] = None,
                 step_s: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 err_tol: Optional[float] = None,
                 p99_factor: Optional[float] = None):
        self.serving = serving
        self.export_dir = export_dir
        self.tag = tag
        self.timeout = timeout
        w0 = (float(knobs.get("RDT_SERVE_CANARY_WEIGHT"))
              if initial_weight is None else float(initial_weight))
        if not 0.0 < w0 <= 1.0:
            raise ValueError(f"canary weight {w0!r} outside (0, 1]")
        ramp = (steps if steps is not None
                else _parse_ramp(knobs.get("RDT_SERVE_ROLLOUT_RAMP")))
        # the schedule: the canary weight, then every ramp step above it,
        # ending at full weight — judged at every step boundary
        self.steps = [w0] + [w for w in ramp if w > w0]
        if self.steps[-1] < 1.0:
            self.steps.append(1.0)
        self.step_s = (float(knobs.get("RDT_SERVE_ROLLOUT_STEP_S"))
                       if step_s is None else float(step_s))
        self.min_samples = max(
            1, int(knobs.get("RDT_SERVE_ROLLOUT_MIN_SAMPLES"))
            if min_samples is None else int(min_samples))
        self.err_tol = (float(knobs.get("RDT_SERVE_ROLLOUT_ERR_TOL"))
                        if err_tol is None else float(err_tol))
        self.p99_factor = (float(knobs.get("RDT_SERVE_ROLLOUT_P99_FACTOR"))
                           if p99_factor is None else float(p99_factor))
        self.version: Optional[int] = None
        #: per-step judgment records, returned in the outcome (and shipped
        #: in the rollback blackbox bundle: the postmortem must show WHICH
        #: step failed on WHAT numbers)
        self.history: List[Dict[str, Any]] = []

    # ---- the judgment -------------------------------------------------------
    def _vrow(self, report: Dict[str, Any],
              version: int) -> Optional[Dict[str, Any]]:
        for row in report.get("versions", []):
            if row["version"] == version:
                return row
        return None

    def _judge(self, base0, canary0, base1, canary1,
               shedding: bool) -> Dict[str, Any]:
        """One judgment over the step-local deltas (cumulative counters at
        the step's start vs now). Returns ``verdict``:
        ``healthy`` / ``unhealthy`` / ``insufficient`` (window not full) /
        ``suspended`` (shedding gate active)."""
        out: Dict[str, Any] = {
            "canary_requests": canary1["requests"] - canary0["requests"],
            "canary_failed": canary1["failed"] - canary0["failed"],
            "base_requests": base1["requests"] - base0["requests"],
            "base_failed": base1["failed"] - base0["failed"],
            "canary_p99_ms": canary1["p99_ms"],
            "base_p99_ms": base1["p99_ms"],
        }
        if shedding:
            out["verdict"] = "suspended"
            return out
        c_n = out["canary_requests"] + out["canary_failed"]
        b_n = out["base_requests"] + out["base_failed"]
        if c_n < self.min_samples or b_n < self.min_samples:
            out["verdict"] = "insufficient"
            return out
        c_err = out["canary_failed"] / c_n
        b_err = out["base_failed"] / b_n
        out["canary_err_rate"] = round(c_err, 4)
        out["base_err_rate"] = round(b_err, 4)
        if c_err > b_err + self.err_tol:
            out["verdict"] = "unhealthy"
            out["reason"] = (
                f"error rate {c_err:.3f} exceeds baseline {b_err:.3f} "
                f"+ tolerance {self.err_tol}")
            return out
        # the latency arm needs its own sample floor: the p99 is read off
        # the per-version latency window, which only failed-free requests
        # feed, so a crash-looping canary must be caught by the error arm
        # above, not produce a spurious latency verdict off 3 samples
        if canary1["lat_n"] >= self.min_samples \
                and base1["lat_n"] >= self.min_samples \
                and base1["p99_ms"] > 0 \
                and canary1["p99_ms"] > self.p99_factor * base1["p99_ms"]:
            out["verdict"] = "unhealthy"
            out["reason"] = (
                f"p99 {canary1['p99_ms']:.1f}ms exceeds "
                f"{self.p99_factor}x baseline {base1['p99_ms']:.1f}ms")
            return out
        out["verdict"] = "healthy"
        return out

    # ---- the ramp -----------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        """Execute the rollout to its terminal state. Returns
        ``{"outcome": "promoted" | "rolled_back", "version", "export_dir",
        "tag", "steps": [...], "reason"?}``. Raises only on setup errors
        (the load itself failing, a closed session) — a judged rollback is
        a RETURN, not an exception."""
        srv = self.serving
        t0 = time.monotonic()
        metrics.inc("serve_rollouts_total")
        info = srv.load_version(self.export_dir, weight=self.steps[0],
                                tag=self.tag)
        self.version = v = info["version"]
        logger.info("rollout of %s started as v%d at weight %.3g "
                    "(ramp %s)", self.export_dir, v, self.steps[0],
                    self.steps)
        baseline = srv.serving_report()["servable"]["version"]
        for step_i, weight in enumerate(self.steps):
            if step_i > 0:
                srv.set_weight(v, weight)
            step_t0 = time.monotonic()
            poll = max(0.05, self.step_s / 20.0)
            rep0 = srv.serving_report()
            base0 = self._vrow(rep0, baseline)
            canary0 = self._vrow(rep0, v)
            if base0 is None or canary0 is None:
                return self._rollback("baseline or canary version vanished "
                                      "mid-ramp")
            verdict: Dict[str, Any] = {"verdict": "insufficient"}
            while True:
                time.sleep(poll)
                rep1 = srv.serving_report()
                base1 = self._vrow(rep1, baseline)
                canary1 = self._vrow(rep1, v)
                if canary1 is None:
                    return self._rollback("canary version vanished "
                                          "mid-ramp")
                if base1 is None:
                    # the baseline group disappeared under us (a concurrent
                    # hot_swap replaced the primary): the comparison frame
                    # is gone — fail safe, roll the canary back
                    return self._rollback(
                        f"baseline v{baseline} vanished mid-ramp "
                        "(concurrent swap?)")
                verdict = self._judge(base0, canary0, base1, canary1,
                                      rep1.get("shedding", False))
                self.history.append({"step": step_i, "weight": weight,
                                     **verdict})
                if verdict["verdict"] == "unhealthy":
                    return self._rollback(verdict.get("reason", "unhealthy"),
                                          verdict)
                if verdict["verdict"] == "healthy":
                    break  # step cleared: ramp on
                if self.timeout is not None \
                        and time.monotonic() - t0 >= self.timeout:
                    return self._rollback(
                        f"rollout exceeded timeout={self.timeout:.0f}s "
                        f"at step {step_i} (weight {weight})", verdict)
                if time.monotonic() - step_t0 >= self.step_s:
                    # the window never filled (or stayed suspended):
                    # insufficient traffic is no evidence of regression —
                    # advance, or an idle session could never deploy
                    logger.info(
                        "rollout v%d step %d (weight %.3g) advancing on "
                        "%s after %.1fs", v, step_i, weight,
                        verdict["verdict"], self.step_s)
                    break
        return self._promote()

    def _promote(self) -> Dict[str, Any]:
        v = self.version
        self.serving.promote_version(v)
        metrics.record_event("rollout_promote", session=self.serving.name,
                             version=v, export_dir=self.export_dir,
                             tag=self.tag or "", steps=len(self.history))
        logger.info("rollout v%d (%s) promoted to primary after %d "
                    "judgment(s)", v, self.export_dir, len(self.history))
        return {"outcome": "promoted", "version": v,
                "export_dir": self.export_dir, "tag": self.tag,
                "steps": self.history}

    def _rollback(self, reason: str,
                  verdict: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
        v = self.version
        srv = self.serving
        logger.error("rollout v%d (%s) ROLLING BACK: %s", v,
                     self.export_dir, reason)
        try:
            # weight first (stop NEW traffic this dispatcher step), then
            # drop (in-flight canary dispatches complete, replicas retire)
            srv.set_weight(v, 0.0)
            srv.drop_version(v)
        except ServingError:
            # already gone (session closing / concurrent drop): the
            # outcome below still records why we bailed
            logger.warning("rollout v%d rollback: version already gone", v)
        metrics.inc("serve_rollouts_rolled_back_total")
        metrics.record_event("rollout_rollback", session=srv.name,
                             version=v, export_dir=self.export_dir,
                             tag=self.tag or "", reason=reason[:300])
        # the postmortem bundle: which step died on what numbers, plus
        # every process's recent event ring (best-effort by contract)
        try:
            path = metrics.write_blackbox(
                f"rollout-{srv.name}",
                extra={"version": v, "export_dir": self.export_dir,
                       "tag": self.tag, "reason": reason,
                       "verdict": verdict, "steps": self.history})
            if path:
                logger.error("rollout rollback flight-recorder bundle "
                             "written to %s", path)
        except Exception:  # noqa: BLE001 - never mask the rollback itself
            logger.warning("rollout rollback blackbox harvest failed",
                           exc_info=True)
        return {"outcome": "rolled_back", "version": v,
                "export_dir": self.export_dir, "tag": self.tag,
                "reason": reason, "steps": self.history}
