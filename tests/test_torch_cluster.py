"""Generic Cluster/ClusterMaster ABCs: the external-engine plug surface.

Parity: reference services.py:22-90 — engine-agnostic master+worker lifecycle
("such as SparkCluster, FlinkCluster") with the fail-safe add_worker contract.
The built-in ETL engine rides the same surface (EtlCluster, driven by the
Session), so these tests prove a third-party engine can too.

The port's twin of ``tests/test_cluster.py``: its cases, data, sizes and
assertions, run against ``raydp_tpu_torch``, whose copies of these planes
they guard against drift.
"""

import time

import pytest
from tests.torch_fixtures import runtime  # noqa: F401


def _wait_gone(rt, name, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if rt.get_actor(name) is None:
            return
        time.sleep(0.2)
    raise AssertionError(f"actor {name} still alive")


class ToyMaster:
    def __init__(self, tag):
        self.tag = tag

    def info(self):
        return f"master-{self.tag}"


class ToyWorker:
    def __init__(self, master_name, index):
        self.master_name = master_name
        self.index = index

    def whoami(self):
        return f"{self.master_name}/worker{self.index}"


def test_etl_cluster_lifecycle(runtime):
    from raydp_tpu_torch.cluster import EtlCluster

    cluster = EtlCluster("abc-app")
    try:
        assert cluster.get_cluster_url() == "abc-app_MASTER"
        assert runtime.get_actor("abc-app_MASTER") is not None
        cluster.add_worker({"CPU": 1.0})
        cluster.add_worker({"CPU": 1.0})
        assert cluster.num_workers == 2
        assert len(cluster.workers) == 2
        # workers are live executors bound to the master
        assert cluster.workers[0].ping() == "pong"
        cluster.remove_worker()
        assert cluster.num_workers == 1
    finally:
        cluster.stop()
    assert cluster.workers == []
    _wait_gone(runtime, "abc-app_MASTER")


def test_external_engine_subclass(runtime):
    """A non-ETL engine implements the same ABCs and gets supervised actors,
    naming, and teardown from the substrate."""
    from raydp_tpu_torch.cluster import Cluster

    class ToyCluster(Cluster):
        def __init__(self):
            self.master_handle = None
            self.worker_handles = []
            super().__init__({"CPU": 0.5})

        def _set_up_master(self, resources, kwargs):
            self.master_handle = runtime.create_actor(
                ToyMaster, ("t1",), name="toy-master", resources=resources)

        def _set_up_worker(self, resources, kwargs):
            i = len(self.worker_handles)
            self.worker_handles.append(runtime.create_actor(
                ToyWorker, ("toy-master", i), name=f"toy-worker-{i}",
                resources=resources))

        def get_cluster_url(self):
            return "toy://toy-master"

        def stop(self):
            for h in self.worker_handles:
                try:
                    h.kill(no_restart=True)
                except Exception:
                    pass
            self.worker_handles = []
            if self.master_handle is not None:
                self.master_handle.kill(no_restart=True)
                self.master_handle = None

    cluster = ToyCluster()
    try:
        assert cluster.master_handle.info() == "master-t1"
        cluster.add_worker({"CPU": 0.5})
        cluster.add_worker({"CPU": 0.5})
        assert cluster.worker_handles[1].whoami() == "toy-master/worker1"
        assert cluster.num_workers == 2
    finally:
        cluster.stop()
    _wait_gone(runtime, "toy-master")


def test_add_worker_failure_stops_cluster(runtime):
    """The fail-safe contract (reference services.py:40-52): a worker that
    cannot start tears the whole cluster down rather than leaking it."""
    from raydp_tpu_torch.cluster import Cluster

    stopped = []

    class FlakyCluster(Cluster):
        def _set_up_master(self, resources, kwargs):
            self.master_handle = runtime.create_actor(
                ToyMaster, ("t2",), name="flaky-master")

        def _set_up_worker(self, resources, kwargs):
            raise RuntimeError("no room for workers")

        def get_cluster_url(self):
            return "toy://flaky"

        def stop(self):
            stopped.append(True)
            if getattr(self, "master_handle", None) is not None:
                self.master_handle.kill(no_restart=True)
                self.master_handle = None

    cluster = FlakyCluster(None)
    with pytest.raises(RuntimeError, match="no room"):
        cluster.add_worker({"CPU": 1.0})
    assert stopped == [True]
    _wait_gone(runtime, "flaky-master")
