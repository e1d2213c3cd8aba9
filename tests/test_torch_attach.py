"""Attached drivers in the port: drivers that join a standalone head
(``python -m raydp_tpu_torch.runtime.head --listen``) through
``raydp_tpu_torch.init(address=...)`` — ``tests/test_attach.py``'s
``test_driver_inside_runtime_actor`` and ``tests/test_attach_matrix.py``'s
``test_full_stack_through_attached_driver`` with the same assertions, each
reference ``FlaxEstimator(MLP((8,)), optax.adam(1e-2), "mse")`` the port's
``TorchEstimator`` with the port's ``MLP`` and Adam 1e-2.

- A full driver session (init → ETL → fit → stop) runs INSIDE a runtime
  actor of the head. Its model starts from the Flax init that
  ``FlaxEstimator`` draws (``PRNGKey(0)``, carried across with
  ``mlp_variables_from_flax``) and trains unshuffled, so its train losses
  are also held to the reference's in-process ``FlaxEstimator.fit`` on the
  same rows in the same order, within 2e-4 (at Adam 1e-2 over its 32 steps
  the two optimizers' rounding stays far below that).
- One attached driver runs reads, expressions, groupBy/join/sort
  shuffles, dynamic allocation, conversion and a fit with an eval set.

Every head is the test's own, started in a session of its own and killed
in a ``finally`` (its process group). The drivers are subprocesses that
import nothing of the reference; the reference's in-process fit runs here,
and its session stops before any head starts.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pandas as pd
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 2e-4


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _start_head(log_path, extra_env=None):
    """A standalone head in a session of its own, its output in
    ``log_path`` (a file, so a long-lived head never blocks on a full
    pipe); returns it and the address it printed."""
    env = _env()
    env.update(extra_env or {})
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "raydp_tpu_torch.runtime.head",
             "--listen", "--port", "0"],
            env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True)
    deadline = time.time() + 60.0
    while time.time() < deadline and proc.poll() is None:
        with open(log_path) as log:
            for line in log:
                if line.startswith("RDT_HEAD_READY "):
                    return proc, line.split()[1].strip()
        time.sleep(0.1)
    _kill(proc)
    raise RuntimeError("standalone head never became ready")


def _kill(proc):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        try:
            proc.kill()
        except ProcessLookupError:
            pass
    proc.wait(timeout=30)


def _run_driver(body: str, constants: dict, timeout: float):
    """Run ``body`` as a fresh driver process, with ``constants`` defined
    at its top."""
    script = "".join(f"{k} = {v!r}\n" for k, v in constants.items()) \
        + textwrap.dedent(body)
    res = subprocess.run([sys.executable, "-c", script], env=_env(),
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, \
        f"driver failed:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}"
    return res


def _inner_pdf():
    """The reference test's rows."""
    rng = np.random.RandomState(0)
    return pd.DataFrame({"x": rng.rand(2000), "z": rng.rand(2000),
                         "y": rng.rand(2000)})


def _reference_inner_fit(pdf):
    """The reference's in-process fit of the inner driver's estimator,
    unshuffled, and the Flax init it drew; its session stops after."""
    import jax
    import jax.numpy as jnp
    import optax

    import raydp_tpu
    from raydp_tpu.data import from_frame
    from raydp_tpu.models import MLP as JaxMLP
    from raydp_tpu.train import FlaxEstimator

    model = JaxMLP(features=(8,), use_batch_norm=False)
    variables = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2)), train=False))
    s = raydp_tpu.init("pytest-attach-ref", num_executors=2,
                       executor_cores=1, executor_memory="256MB")
    try:
        df = s.createDataFrame(pdf, num_partitions=4)
        history = FlaxEstimator(
            model=model, optimizer=optax.adam(1e-2), loss="mse",
            feature_columns=["x", "z"], label_column="y", batch_size=128,
            num_epochs=2, seed=0, shuffle=False).fit(from_frame(df)).history
    finally:
        raydp_tpu.stop()
    return history, variables


def test_driver_inside_runtime_actor(tmp_path):
    """Cluster mode: a FULL driver session (init → ETL → fit → stop)
    running INSIDE a runtime actor, not in the attaching process (parity:
    the reference runs a Spark driver inside a Ray actor, reference
    test_spark_cluster.py:113-134)."""
    from raydp_tpu_torch.models import mlp_variables_from_flax

    reference, variables = _reference_inner_fit(_inner_pdf())
    state_path = str(tmp_path / "init.pt")
    torch.save(mlp_variables_from_flax(variables), state_path)
    out_path = str(tmp_path / "inner.json")

    head, address = _start_head(str(tmp_path / "head.log"))
    try:
        _run_driver("""
            import json
            import raydp_tpu_torch
            from raydp_tpu_torch.runtime import get_runtime

            class InnerDriver:
                def run(self, address, state_path):
                    # the actor process becomes a driver of the same head
                    import numpy as np
                    import pandas as pd
                    import torch
                    import raydp_tpu_torch
                    from raydp_tpu_torch.data import from_frame
                    from raydp_tpu_torch.models import MLP
                    from raydp_tpu_torch.train import TorchEstimator

                    s = raydp_tpu_torch.init(
                        "inner-app", num_executors=2, executor_cores=1,
                        executor_memory="256MB", address=address)
                    rng = np.random.RandomState(0)
                    pdf = pd.DataFrame({"x": rng.rand(2000),
                                        "z": rng.rand(2000),
                                        "y": rng.rand(2000)})
                    df = s.createDataFrame(pdf, num_partitions=4)
                    n = df.count()
                    model = MLP(2, (8,), use_batch_norm=False, device="cpu")
                    model.load_state_dict(torch.load(state_path))
                    est = TorchEstimator(
                        model=model,
                        optimizer=lambda p: torch.optim.Adam(p, lr=1e-2),
                        loss="mse", feature_columns=["x", "z"],
                        label_column="y", batch_size=128, num_epochs=2,
                        seed=0, shuffle=False, device="cpu")
                    result = est.fit(from_frame(df))
                    raydp_tpu_torch.stop()
                    return {"rows": n,
                            "epochs": len(result.history),
                            "loss": result.history[-1]["train_loss"],
                            "losses": [h["train_loss"]
                                       for h in result.history]}

            s = raydp_tpu_torch.init("outer", num_executors=1,
                                     executor_cores=1,
                                     executor_memory="256MB",
                                     address=ADDRESS)
            rt = get_runtime()
            actor = rt.create_actor(InnerDriver, name="inner-driver",
                                    resources={"CPU": 1.0})
            out = actor.call("run", ADDRESS, STATE, timeout=240.0)
            assert out["rows"] == 2000
            assert out["epochs"] == 2
            assert out["loss"] == out["loss"]  # finite
            with open(OUT, "w") as f:
                json.dump(out, f)
            raydp_tpu_torch.stop()
        """, {"ADDRESS": address, "STATE": state_path, "OUT": out_path},
            timeout=300)
    finally:
        _kill(head)

    with open(out_path) as f:
        out = json.load(f)
    np.testing.assert_allclose(
        out["losses"], [h["train_loss"] for h in reference], rtol=LOSS_RTOL,
        err_msg="the attached fit against the reference's in-process fit")


def test_full_stack_through_attached_driver(tmp_path):
    head, address = _start_head(str(tmp_path / "head.log"))
    try:
        _run_driver("""
            import numpy as np
            import pandas as pd
            import torch
            import raydp_tpu_torch
            from raydp_tpu_torch.data import from_frame
            from raydp_tpu_torch.etl import functions as F
            from raydp_tpu_torch.etl.expressions import col
            from raydp_tpu_torch.models import MLP
            from raydp_tpu_torch.train import TorchEstimator
            from raydp_tpu_torch.utils import random_split

            s = raydp_tpu_torch.init("matrix", num_executors=2,
                                     executor_cores=1,
                                     executor_memory="512MB",
                                     address=ADDRESS)

            # narrow + wide operators over the client session
            rng = np.random.RandomState(0)
            n = 4000
            pdf = pd.DataFrame({
                "k": rng.randint(0, 7, n),
                "x": rng.rand(n),
                "y": rng.rand(n) * 2.0,
            })
            df = s.createDataFrame(pdf, num_partitions=4)
            assert df.count() == n
            filtered = df.filter(col("x") > 0.5)
            assert 0 < filtered.count() < n

            agg = (df.groupBy("k").agg(F.mean("x").alias("mx"))
                   .to_pandas().set_index("k"))
            exp = pdf.groupby("k")["x"].mean()
            for k in exp.index:
                assert abs(agg.loc[k, "mx"] - exp[k]) < 1e-9

            srt = df.sort("k", "x").to_pandas().reset_index(drop=True)
            exp_s = pdf.sort_values(["k", "x"]).reset_index(drop=True)
            pd.testing.assert_frame_equal(srt, exp_s)

            right = s.createDataFrame(
                pd.DataFrame({"k": np.arange(7), "name": list("abcdefg")}),
                num_partitions=2)
            joined = df.join(right, on="k").count()
            assert joined == n

            # dynamic allocation over the client RPC
            assert s.request_total_executors(3) == 3
            assert s.request_total_executors(2) == 2

            # conversion + estimator training on the attached session
            train_df, test_df = random_split(df, [0.8, 0.2], seed=0)
            est = TorchEstimator(
                model=MLP(2, (8,), use_batch_norm=False, device="cpu"),
                optimizer=lambda p: torch.optim.Adam(p, lr=1e-2),
                loss="mse", feature_columns=["x", "k"], label_column="y",
                batch_size=128, num_epochs=2, seed=0, device="cpu")
            result = est.fit(from_frame(train_df), from_frame(test_df))
            assert len(result.history) == 2
            assert "eval_loss" in result.history[-1]

            raydp_tpu_torch.stop()
        """, {"ADDRESS": address}, timeout=600)
    finally:
        _kill(head)
