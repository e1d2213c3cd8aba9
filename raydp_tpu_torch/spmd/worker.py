"""Rank-process entry point (``python -m raydp_tpu_torch.spmd.worker``) —
the port of :mod:`raydp_tpu.spmd.worker`.

Parity: ``mpi_worker.py`` — rank from env (33-42), two-phase registration to the
driver (144-166), in-order function execution with ``func_id`` sequencing
(63-96), and joining the data plane the way each MPI rank re-joins Ray
(159-160): if this process inherited a runtime head address it connects an
object-store client before serving functions.

When ``RDT_SPMD_JAX_DISTRIBUTED=1`` (the reference's knob name) the rank
calls ``torch.distributed.init_process_group`` against the job's
``tcp://`` rendezvous before serving, with the backend the driver fixed by
its rule (:func:`raydp_tpu_torch.spmd.job.gang_backend`), so user
functions run inside one process group: ``torch.distributed`` collectives
replace the reference's XLA collectives over the global mesh. A rank of an
``nccl`` gang sees exactly its own card, which it makes current first.
"""

from __future__ import annotations

import os
import threading
import time
import traceback

import cloudpickle

from raydp_tpu_torch import knobs
from raydp_tpu_torch.log import get_logger, init_logging
from raydp_tpu_torch.runtime.rpc import RpcServer, connect_with_retry
from raydp_tpu_torch.spmd.job import (
    ENV_COORDINATOR, ENV_DRIVER, ENV_JOB_ID, ENV_RANK, ENV_TORCH_DIST,
    ENV_WORLD, WorkerContext, _free_port,
)

logger = get_logger("spmd.worker")


class _WorkerService:
    """Serves RunFunction/Stop (parity: WorkerService, network.proto:32-37)."""

    def __init__(self, ctx: WorkerContext):
        self._ctx = ctx
        self._last_func_id = 0
        self._lock = threading.Lock()

    def __call__(self, method: str, args: tuple, kwargs: dict):
        if method == "run_function":
            return self._run_function(*args)
        if method == "stop":
            threading.Thread(target=_delayed_exit, args=(self._lock,),
                             daemon=True).start()
            return True
        if method == "ping":
            return "pong"
        raise AttributeError(f"unknown worker method {method!r}")

    def _run_function(self, func_id: int, payload: bytes):
        with self._lock:  # functions run one at a time, in order
            if func_id != self._last_func_id + 1:
                return False, (f"out-of-order function: got {func_id}, "
                               f"expected {self._last_func_id + 1}")
            fn = cloudpickle.loads(payload)
            try:
                value = fn(self._ctx)
                self._last_func_id = func_id
                return True, value
            except BaseException:  # noqa: BLE001 - report any failure to driver
                self._last_func_id = func_id
                return False, traceback.format_exc()


def _delayed_exit(running: threading.Lock):
    """Leave the process group, then exit. A function still running (a
    collective whose peer died) holds ``running``: the group is then left
    to die with the process, since tearing it down under that collective
    could hang."""
    time.sleep(0.2)
    import sys

    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_initialized() \
            and running.acquire(blocking=False):
        dist.destroy_process_group()
    os._exit(0)


def _init_process_group(driver, rank: int, world_size: int,
                        backend: str) -> None:
    """Join the gang's process group: rank 0 picks the rendezvous port on
    its own routable interface moments before ``init_process_group`` binds
    it (narrowing the reuse race to this process's own window) and reports
    it to the other ranks through the driver."""
    import torch
    import torch.distributed as dist

    coordinator = knobs.get(ENV_COORDINATOR)  # test/ops override
    if not coordinator:
        if rank == 0:
            host = driver.local_host
            coordinator = f"{host}:{_free_port(host)}"
            driver.call("set_coordinator", coordinator)
        else:
            # first arg is the server-side wait; the kwarg is the client
            # deadline (RpcClient.call consumes `timeout=` itself)
            coordinator = driver.call("get_coordinator", 120.0,
                                      timeout=130.0)
    device_id = None
    if backend == "nccl":
        # the rank's bundle card is the only one it sees; binding the group
        # to it creates the communicator now, before any graph capture
        torch.cuda.set_device(0)
        device_id = torch.device("cuda", 0)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            rank=rank, world_size=world_size,
                            device_id=device_id)
    logger.info("rank %d/%d joined the %s process group at %s", rank,
                world_size, backend, coordinator)


def main() -> None:
    import faulthandler
    import signal

    # SIGUSR1 → dump all thread stacks to stderr (lands in the rank .out
    # file), so a hung collective can be diagnosed from outside
    faulthandler.register(signal.SIGUSR1, all_threads=True)

    job_id = str(knobs.require(ENV_JOB_ID))
    driver_url = str(knobs.require(ENV_DRIVER))
    rank = int(knobs.require(ENV_RANK))
    world_size = int(knobs.require(ENV_WORLD))

    init_logging(f"spmd-{job_id}-r{rank}", str(knobs.get("RDT_LOG_LEVEL")),
                 None, job_id)

    d_host, d_port = driver_url.rsplit(":", 1)
    driver = connect_with_retry((d_host, int(d_port)))
    reply = driver.call("register_worker", rank, os.getpid())
    if reply["world_size"] != world_size:
        raise RuntimeError(f"rank {rank} was spawned for a world of "
                           f"{world_size}, the driver's is "
                           f"{reply['world_size']}")

    if knobs.get(ENV_TORCH_DIST):
        _init_process_group(driver, rank, world_size, reply["backend"])

    # join the data plane if a runtime session is live (parity: ray.init in
    # every MPI rank, mpi_worker.py:159-160)
    from raydp_tpu_torch.runtime import head as head_mod
    from raydp_tpu_torch.runtime import object_store as objstore
    from raydp_tpu_torch.runtime.actor_main import StoreTableProxy

    head_url = os.environ.get(head_mod.ENV_HEAD)
    session_id = os.environ.get(head_mod.ENV_SESSION)
    if head_url and session_id:
        host, port = head_url.rsplit(":", 1)
        try:
            head_client = connect_with_retry((host, int(port)))
            store = objstore.ObjectStoreClient(
                StoreTableProxy(head_client), session_id,
                default_owner=f"spmd-{job_id}-r{rank}")
            objstore.set_client(store)
        except Exception as e:
            logger.warning(
                "rank %d could not join the object store at %s: %s "
                "(functions needing the data plane will fail)",
                rank, head_url, e)

    ctx = WorkerContext(job_id=job_id, rank=rank, world_size=world_size)

    server = RpcServer(_WorkerService(ctx), host=driver.local_host, port=0,
                       max_concurrency=2, name=f"spmd-r{rank}")
    driver.call("register_worker_service", rank, server.address[0],
                server.address[1])

    # die with the driver (parity: mpirun teardown kills ranks; here the rank
    # watches the control connection)
    try:
        while True:
            driver.call("ping", timeout=30.0)
            time.sleep(5.0)
    except Exception:
        pass
    finally:
        server.stop()
        os._exit(0)


if __name__ == "__main__":
    main()
