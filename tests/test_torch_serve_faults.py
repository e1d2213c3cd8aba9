"""Serving replicas under faults, on real executors: two of
``tests/test_chaos.py``'s serving legs with the same assertions, run
through the port's ``serve/replica.py`` and ``serve/servable.py`` in the
executors of a port ETL session (the replicas serve on the CPU).

- ``test_serving_replica_crash_reroutes_zero_dropped``: a seeded
  ``serve.predict:crash`` kills replica ``chaos-r0``'s executor mid-burst;
  every request completes through the re-route path, bit for bit what a
  fault-free session answers; the executor restarts and the replica
  reloads in the background.
- ``test_rollout_canary_executor_crash_mid_ramp_stays_unmixed``: the
  canary's executor crashes mid-ramp; the dispatch re-routes within its
  version, and every answer is exactly one version's, never a mix.

Each reference ``FlaxEstimator(MLP((8,)), optax.adam(1e-2), "mse")`` is the
port's ``TorchEstimator`` with the port's ``MLP`` and Adam 1e-2. Knobs and
fault specs are set before each session starts, so its executors inherit
them, and restored when it stops. The twins of the reference legs that
fail in some loaded test runs (the p99 rollback, admission with autoscale
and drain, the scale-down race) and the overload leg are in
``tests/test_torch_serve_admission.py``.
"""

import os
import threading

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import raydp_tpu_torch
from raydp_tpu_torch.models import MLP
from raydp_tpu_torch.train import TorchEstimator

SESSION = dict(num_executors=2, executor_cores=1, executor_memory="512MB")


def linear_rows(n=512):
    """The reference legs' seeded rows: ``(x, frame)``."""
    rng = np.random.RandomState(11)
    x = rng.random_sample((n, 2))
    y = x @ np.array([2.0, -3.0]) + 1.0
    return x, pd.DataFrame({"x1": x[:, 0], "x2": x[:, 1], "y": y})


def fit_and_export(session, pdf, export_dir, num_epochs=1):
    """The reference legs' estimator, fitted on ``pdf`` through the
    session's ETL and exported as a servable; returns the estimator."""
    df = session.createDataFrame(pdf, num_partitions=2)
    est = TorchEstimator(
        model=MLP(2, (8,), use_batch_norm=False, device="cpu"),
        optimizer=lambda p: torch.optim.Adam(p, lr=1e-2), loss="mse",
        feature_columns=["x1", "x2"], label_column="y", batch_size=64,
        num_epochs=num_epochs, device="cpu")
    est.fit_on_frame(df)
    est.export_serving(export_dir)
    return est


def rows(x, i, n):
    return {"x1": x[i:i + n, 0], "x2": x[i:i + n, 1]}


def guard_traffic(srv, x, n, out, timeout=120.0):
    """Sequential seeded load for the rollout legs: ``n`` 2-row predicts in
    a FIXED order, responses appended in that order — two runs (with and
    without a rollout in flight) produce position-comparable sequences."""
    for i in range(n):
        j = (2 * i) % 400
        out.append(srv.predict(rows(x, j, 2), timeout=timeout))


def test_serving_replica_crash_reroutes_zero_dropped(tmp_path):
    """A replica crash mid-stream under seeded load re-routes the in-flight
    (and every later) request through the hedge path — ZERO dropped
    requests, results byte-identical to a fault-free run. The crashed
    executor restarts (max_restarts=-1) and the replica reloads in the
    background; the once= sentinel keeps the restarted process from
    re-crashing on the inherited spec."""
    from raydp_tpu_torch.serve import ServingSession

    x, pdf = linear_rows()
    export_dir = str(tmp_path / "chaos-servable")
    sentinel = str(tmp_path / "serve_crash.sentinel")
    results, reports = {}, {}

    for mode in ("clean", "crash"):
        with pytest.MonkeyPatch.context() as mp:
            if mode == "crash":
                # the 2nd batch entering replica chaos-r0's worker kills its
                # executor process abruptly, mid-request (set BEFORE init so
                # the spawned executors inherit it)
                mp.setenv("RDT_FAULTS", "serve.predict:crash:nth=2:"
                          f"match=|chaos-r0:once={sentinel}")
            mp.setenv("RDT_SERVE_BATCH_TIMEOUT_MS", "10")
            s = raydp_tpu_torch.init(f"serve_chaos_{mode}", **SESSION)
            try:
                if mode == "clean":
                    fit_and_export(s, pdf, export_dir)
                srv = ServingSession(export_dir, session=s, name="chaos",
                                     device="cpu")
                try:
                    # seeded load: a concurrent burst (coalesces, and is
                    # what the crash lands in the middle of) + a sequential
                    # tail (proves the plane keeps serving after the loss)
                    futs = [srv.predict_async(rows(x, i, 2))
                            for i in range(0, 64, 2)]
                    burst = [f.result(timeout=120.0) for f in futs]
                    tail = [srv.predict(rows(x, 64 + i, 1), timeout=120.0)
                            for i in range(16)]
                    results[mode] = np.concatenate(burst + tail)
                    reports[mode] = srv.serving_report()
                finally:
                    srv.close()
            finally:
                raydp_tpu_torch.stop()

    # the injection actually fired, and every request still completed
    assert os.path.exists(sentinel), "crash schedule never fired"
    assert reports["crash"]["failed"] == 0
    assert reports["crash"]["rerouted"] >= 1, reports["crash"]
    assert len(results["crash"]) == len(results["clean"]) == 80
    # byte-identical to the fault-free run (every forward at the servable's
    # fixed batch rows: neither the crash nor the changed batch composition
    # may leak into the numbers)
    assert np.array_equal(results["clean"], results["crash"])


def test_rollout_canary_executor_crash_mid_ramp_stays_unmixed(tmp_path,
                                                              monkeypatch):
    """The canary's executor CRASHES mid-ramp (``nth=2`` on replica
    guardb-v2-r0, once= sentinel). The in-flight dispatch re-routes
    VERSION-LOCALLY to the canary's surviving sibling — the ramp then
    continues or rolls back on its own judgment, but no response ever mixes
    versions: every answer is checked row-for-row against locally computed
    reference predictions of model A and model B (two genuinely different
    trainings) and must equal exactly one of them."""
    from raydp_tpu_torch.serve import ServingSession, load_servable

    x, pdf = linear_rows()
    dir_a = str(tmp_path / "guardb-a")
    dir_b = str(tmp_path / "guardb-b")
    sentinel = str(tmp_path / "rollout_crash.sentinel")

    # the 2nd batch entering canary replica guardb-v2-r0 kills its executor
    # abruptly mid-request; the primary replica colocated on that executor
    # dies with it (both groups must re-route, each within its own version)
    monkeypatch.setenv("RDT_FAULTS", "serve.predict:crash:nth=2:"
                       f"match=|guardb-v2-r0:once={sentinel}")
    monkeypatch.setenv("RDT_SERVE_BATCH_TIMEOUT_MS", "10")
    monkeypatch.setenv("RDT_SERVE_HEDGE", "0")
    s = raydp_tpu_torch.init("serve_rollout_crash", **SESSION)
    try:
        # two genuinely different models: more epochs move the weights, and
        # the refs-differ assert below keeps the mixing check non-vacuous
        fit_and_export(s, pdf, dir_a, num_epochs=1)
        fit_and_export(s, pdf, dir_b, num_epochs=4)

        # per-request reference predictions, computed locally through the
        # SAME servable decode/place/apply path the replicas run
        sv_a = load_servable(dir_a, device="cpu")
        sv_b = load_servable(dir_b, device="cpu")
        batches = []
        refs_a, refs_b = [], []
        for i in range(120):
            j = (2 * i) % 400
            tbl = pa.table(rows(x, j, 2))
            batches.append(j)
            refs_a.append(sv_a.predict_table(tbl))
            refs_b.append(sv_b.predict_table(tbl))
        assert not np.array_equal(refs_a[0], refs_b[0]), \
            "models A and B predict identically; mixing check is vacuous"

        srv = ServingSession(dir_a, session=s, name="guardb", device="cpu")
        try:
            got = []
            t = threading.Thread(target=guard_traffic,
                                 args=(srv, x, 120, got))
            t.start()
            try:
                outcome = srv.rollout(
                    dir_b, tag="crashy-host", initial_weight=0.5,
                    steps=[0.5, 1.0], step_s=10.0, min_samples=4,
                    timeout=180.0)
            finally:
                t.join(timeout=240.0)
            assert not t.is_alive(), "traffic thread hung"
            report = srv.serving_report()
        finally:
            srv.close()
    finally:
        raydp_tpu_torch.stop()

    # the injection actually fired, mid-ramp
    assert os.path.exists(sentinel), "crash schedule never fired"
    # zero dropped: the crashed dispatch re-routed (version-locally) and
    # completed; the ramp reached a terminal verdict on its own
    assert outcome["outcome"] in ("promoted", "rolled_back"), outcome
    assert report["failed"] == 0, report
    assert report["rerouted"] >= 1, report
    assert len(got) == 120
    # NO response mixes versions: each answer equals model A's reference or
    # model B's reference for its batch, entirely
    from_a = from_b = 0
    for i, ans in enumerate(got):
        if np.array_equal(ans, refs_a[i]):
            from_a += 1
        elif np.array_equal(ans, refs_b[i]):
            from_b += 1
        else:
            raise AssertionError(
                f"response {i} (batch offset {batches[i]}) matches neither "
                f"version's reference — versions mixed in one response")
    # both versions actually took traffic (the canary held >= min_samples
    # requests before any terminal verdict)
    assert from_a >= 1 and from_b >= 1, (from_a, from_b)
