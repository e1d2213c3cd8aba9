"""Attach/client mode in the port: a standalone head
(``python -m raydp_tpu_torch.runtime.head --listen``) shared by sequential
drivers that join it through ``raydp_tpu_torch.init(address=...)``.

- Driver 1 converts a frame to a dataset owned by its master and detaches
  with ``cleanup_data=False``; driver 2, a separate process, attaches later
  and reads the same dataset out of the head's store.
- A driver that exits without detaching does not poison the head: the next
  driver attaches and works, and the crasher's actors are reaped once its
  heartbeats stop.
- A placement group made through an attached driver lives on the head's
  resource model, pins the executors, and ``stop()`` removes it.

The port's twin of ``tests/test_attach.py``'s two driver-lifetime cases and
``tests/test_attach_matrix.py``'s placement-group case, with the same
assertions (``test_torch_attach.py`` holds the estimator cases). Every head
is the test's own, logs to a file and is killed in a ``finally`` (its
process group); the drivers are subprocesses that import only the port.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _kill(proc):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        try:
            proc.kill()
        except ProcessLookupError:
            pass
    proc.wait(timeout=30)


def _start_head(log_path, extra_env=None):
    """A standalone head in a session of its own, its output in
    ``log_path``; returns it and the address it printed."""
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


def _run_driver(body: str, address: str, payload_path: str):
    script = textwrap.dedent(f"""
        ADDRESS = {address!r}
        PAYLOAD = {payload_path!r}
    """) + textwrap.dedent(body)
    res = subprocess.run([sys.executable, "-c", script], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, f"driver failed:\n{res.stdout}\n{res.stderr}"
    return res


def test_two_sequential_drivers_share_one_head(tmp_path):
    head, address = _start_head(str(tmp_path / "head.log"))
    payload_path = str(tmp_path / "payload.pkl")
    try:
        _run_driver("""
            import pickle
            import numpy as np
            import pandas as pd
            import raydp_tpu_torch
            from raydp_tpu_torch.data.dataset import from_frame

            s = raydp_tpu_torch.init("driver1", num_executors=2,
                                     executor_cores=1,
                                     executor_memory="256MB",
                                     address=ADDRESS)
            pdf = pd.DataFrame({"x": np.arange(1000, dtype=np.int64),
                                "y": np.arange(1000) * 2.0})
            df = s.createDataFrame(pdf, num_partitions=4)
            ds = from_frame(df)          # blocks owned by driver1's master
            with open(PAYLOAD, "wb") as f:
                pickle.dump(ds.portable(), f)
            # keep the master (and the data it owns) alive for driver 2
            raydp_tpu_torch.stop(cleanup_data=False)
        """, address, payload_path)

        _run_driver("""
            import pickle
            import numpy as np
            import raydp_tpu_torch
            from raydp_tpu_torch.data.dataset import DistributedDataset

            s = raydp_tpu_torch.init("driver2", num_executors=1,
                                     executor_cores=1,
                                     executor_memory="256MB",
                                     address=ADDRESS)
            with open(PAYLOAD, "rb") as f:
                payload = pickle.load(f)
            ds = DistributedDataset.from_portable(payload)
            assert ds.count() == 1000, ds.count()
            table = ds.to_arrow()
            x = np.sort(table.column("x").to_numpy())
            assert (x == np.arange(1000)).all()
            # driver1's master must still be resolvable by name
            from raydp_tpu_torch.runtime import get_runtime
            assert get_runtime().get_actor("driver1_MASTER") is not None
            raydp_tpu_torch.stop()
        """, address, payload_path)
    finally:
        _kill(head)


def test_driver_crash_leaves_head_usable_and_reaps_actors(tmp_path):
    """A driver that exits without detaching must not poison the head: the
    next driver attaches and works, and the crasher's still-bound actors are
    reaped once its heartbeats stop (Ray's non-detached-actor lifetime) —
    a long-lived head must not accumulate leaked sessions."""
    head, address = _start_head(str(tmp_path / "head.log"),
                                {"RDT_DRIVER_REAP_S": "8"})
    payload_path = str(tmp_path / "unused.pkl")
    try:
        script = textwrap.dedent(f"""
            import os
            import raydp_tpu_torch
            s = raydp_tpu_torch.init("crasher", num_executors=1,
                                     executor_cores=1,
                                     executor_memory="256MB",
                                     address={address!r})
            s.range(100).count()
            os._exit(1)  # die without stop()
        """)
        subprocess.run([sys.executable, "-c", script], env=_env(),
                       capture_output=True, timeout=300)

        _run_driver("""
            import time
            import raydp_tpu_torch
            s = raydp_tpu_torch.init("survivor", num_executors=1,
                                     executor_cores=1,
                                     executor_memory="256MB",
                                     address=ADDRESS)
            assert s.range(500).count() == 500
            # the crasher's session actors disappear after its heartbeats
            # lapse (head runs with RDT_DRIVER_REAP_S=8)
            from raydp_tpu_torch.runtime import get_runtime
            rt = get_runtime()
            deadline = time.time() + 60.0
            while time.time() < deadline:
                if rt.get_actor("crasher_MASTER") is None:
                    break
                time.sleep(1.0)
            assert rt.get_actor("crasher_MASTER") is None, \\
                "crashed driver's master leaked"
            raydp_tpu_torch.stop()
        """, address, payload_path)
    finally:
        _kill(head)


def test_placement_group_through_attached_driver(tmp_path):
    """Attach-mode pg pre-allocation: the group is created on the HEAD's
    resource model over RPC, executors pin to its bundles, and stop()
    removes it — parity with the reference's client-mode pg path (reference
    context.py:119-140, conftest.py:77-140)."""
    head, address = _start_head(str(tmp_path / "head.log"))
    try:
        script = textwrap.dedent(f"""
            import numpy as np
            import pandas as pd
            import raydp_tpu_torch
            from raydp_tpu_torch.runtime import get_runtime

            s = raydp_tpu_torch.init("pg-client", num_executors=2,
                                     executor_cores=1,
                                     executor_memory="256MB",
                                     placement_group_strategy="SPREAD",
                                     address={address!r})
            rt = get_runtime()
            groups = rt.head.call("list_placement_groups")
            assert len(groups) == 1, groups
            assert len(groups[0]["bundles"]) == 2
            assert all(b["node_id"] for b in groups[0]["bundles"])

            # the session actually works on the pg-pinned executors
            df = s.createDataFrame(
                pd.DataFrame({{"x": np.arange(500)}}), num_partitions=4)
            assert df.count() == 500
            raydp_tpu_torch.stop()
        """)
        res = subprocess.run([sys.executable, "-c", script], env=_env(),
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, \
            f"pg client-mode failed:\n{res.stdout[-2000:]}\n" \
            f"{res.stderr[-4000:]}"

        # a fresh driver sees no leftover group: stop() removed it on the head
        check = textwrap.dedent(f"""
            import raydp_tpu_torch
            from raydp_tpu_torch.runtime import get_runtime

            s = raydp_tpu_torch.init("pg-check", num_executors=1,
                                     executor_cores=1,
                                     executor_memory="256MB",
                                     address={address!r})
            assert get_runtime().head.call("list_placement_groups") == []
            raydp_tpu_torch.stop()
        """)
        res = subprocess.run([sys.executable, "-c", check], env=_env(),
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, \
            f"pg cleanup check failed:\n{res.stdout[-2000:]}\n" \
            f"{res.stderr[-4000:]}"
    finally:
        _kill(head)
