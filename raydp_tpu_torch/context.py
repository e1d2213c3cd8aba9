"""Session lifecycle: ``raydp_tpu_torch.init`` / ``raydp_tpu_torch.stop``.

Parity with the reference's ``raydp.init_spark`` / ``raydp.stop_spark``
(context.py:182-254): a lock-guarded global singleton context, placement-group
pre-allocation of one ``{CPU, memory}`` bundle per executor, ordered teardown, and
``atexit`` cleanup (context.py:257). Instead of launching a JVM gateway and a Spark
driver, ``init`` boots the built-in actor runtime, creates the ETL master actor, and
gang-starts executor actors; the returned :class:`~raydp_tpu_torch.etl.session.Session` is
the DataFrame entry point (the SparkSession analogue).
"""

from __future__ import annotations

import atexit
import threading
from typing import Dict, List, Optional, Union

from raydp_tpu_torch import config as cfg
from raydp_tpu_torch.config import Config
from raydp_tpu_torch.log import get_logger
from raydp_tpu_torch.utils import parse_memory_size

logger = get_logger("context")

_context_lock = threading.RLock()
_global_context: Optional["_Context"] = None


class _Context:
    """Holds the runtime + ETL session for one ``init()``...``stop()`` span."""

    def __init__(
        self,
        app_name: str,
        num_executors: int,
        executor_cores: int,
        executor_memory: Union[str, int],
        placement_group_strategy: Optional[str],
        configs: Optional[Dict[str, str]],
        virtual_nodes: Optional[List[Dict[str, float]]],
        address: Optional[str] = None,
    ):
        self.app_name = app_name
        self.num_executors = num_executors
        self.executor_cores = executor_cores
        self.executor_memory = parse_memory_size(executor_memory)
        self.placement_group_strategy = placement_group_strategy
        self.config = Config(configs)
        self.virtual_nodes = virtual_nodes
        self.address = address
        self.session = None
        self._placement_group = None
        self._kept_data = False  # a stop(cleanup_data=False) happened

    def get_or_create_session(self):
        if self.session is not None:
            return self.session
        from raydp_tpu_torch.etl.session import Session
        from raydp_tpu_torch.runtime import init_runtime

        if self.address is not None:
            # attach/client mode: join a standalone head's cluster instead of
            # booting an in-process runtime (parity: Ray-client mode,
            # reference conftest.py:77-140). Placement groups are created on
            # the HEAD's resource model over RPC, exactly like the
            # reference's pg pre-allocation under Ray client
            # (reference context.py:119-140).
            from raydp_tpu_torch.runtime.client import ClientContext
            from raydp_tpu_torch.runtime.head import adopt_runtime
            runtime = ClientContext(self.address)
            adopt_runtime(runtime)
            self._preallocate_group(runtime)
            self.session = Session(
                app_name=self.app_name,
                num_executors=self.num_executors,
                executor_cores=self.executor_cores,
                executor_memory=self.executor_memory,
                config=self.config,
                placement_group=self._placement_group,
            )
            self.session.start()
            return self.session

        runtime = init_runtime(config=self.config, virtual_nodes=self.virtual_nodes)
        self._preallocate_group(runtime)

        self.session = Session(
            app_name=self.app_name,
            num_executors=self.num_executors,
            executor_cores=self.executor_cores,
            executor_memory=self.executor_memory,
            config=self.config,
            placement_group=self._placement_group,
        )
        self.session.start()
        return self.session

    def _preallocate_group(self, runtime) -> None:
        """One {CPU, memory} bundle per executor (parity: context.py:119-140);
        works against the in-process ResourceManager and the client-mode RPC
        proxy alike."""
        if self.placement_group_strategy is None:
            return
        bundles = [
            {"CPU": float(self.executor_cores),
             "memory": float(self.executor_memory)}
            for _ in range(self.num_executors)
        ]
        group = runtime.resource_manager.create_group(
            bundles, self.placement_group_strategy)
        self._placement_group = group
        self.config.set(cfg.PLACEMENT_GROUP_KEY, group.group_id)
        self.config.set(
            cfg.PLACEMENT_GROUP_BUNDLE_INDEXES_KEY,
            ",".join(str(b.index) for b in group.bundles),
        )

    def stop(self, cleanup_data: bool = True) -> None:
        """Teardown order parity (context.py:152-169): master shutdown → session
        stop → remove placement group → runtime shutdown (unless data is kept)."""
        from raydp_tpu_torch.runtime import get_runtime, runtime_initialized, shutdown_runtime

        self._kept_data = not cleanup_data
        if self.session is not None:
            self.session.stop(cleanup_data=cleanup_data)
            if cleanup_data:
                self.session = None
        if runtime_initialized():
            if self._placement_group is not None:
                get_runtime().resource_manager.remove_group(
                    self._placement_group.group_id)
                self._placement_group = None
            if cleanup_data:
                shutdown_runtime()


def _submit_overrides() -> Dict:
    """Configuration packaged by ``rdt-submit`` (parity: conf flowing from
    bin/raydp-submit into the session). Explicit ``init`` arguments win;
    submitted values fill anything the script left at its default."""
    import json

    from raydp_tpu_torch import knobs

    raw = knobs.get_raw("RDT_SUBMIT_ARGS")
    if not raw:
        return {}
    try:
        return json.loads(raw)
    except ValueError:
        logger.warning("ignoring malformed RDT_SUBMIT_ARGS")
        return {}


def init(
    app_name: str,
    num_executors: Optional[int] = None,
    executor_cores: Optional[int] = None,
    executor_memory: Union[str, int, None] = None,
    placement_group_strategy: Optional[str] = None,
    configs: Optional[Dict[str, str]] = None,
    virtual_nodes: Optional[List[Dict[str, float]]] = None,
    address: Optional[str] = None,
):
    """Start the framework and return the ETL :class:`Session`.

    Signature parity with ``raydp.init_spark`` (context.py:182-254); defaults:
    1 executor × 1 core × 1GB. Under ``rdt-submit``, submitted values replace
    the defaults of any argument not set explicitly here. Extra
    knob beyond the reference's: ``virtual_nodes`` registers logical nodes to simulate
    a multi-host topology in tests (the reference's tests get this from
    ``ray.cluster_utils.Cluster``, test_spark_cluster.py:90-110).

    ``address="host:port"`` attaches to a standalone head
    (``python -m raydp_tpu_torch.runtime.head --listen``) instead of booting an
    in-process runtime — the Ray-client-mode analogue. The head, its actors,
    and stored data outlive this driver; ``stop(cleanup_data=False)`` leaves
    even this session's master alive for the next driver to read.
    """
    # re-arm the fault plane from the CURRENT env: the process-local registry
    # caches RDT_FAULTS on first check(), so a spec exported between two
    # sessions of one driver process would otherwise never load for
    # driver-side sites (rpc.call, store.get) and silently inject nothing.
    # Rules armed via faults.inject() before init survive (only env rules
    # reload)
    from raydp_tpu_torch import faults
    faults.reset()

    sub = _submit_overrides()
    app_name = app_name or sub.get("app_name") or "raydp-tpu"
    if num_executors is None:
        num_executors = int(sub.get("num_executors", 1))
    if executor_cores is None:
        executor_cores = int(sub.get("executor_cores", 1))
    if executor_memory is None:
        executor_memory = sub.get("executor_memory", "1GB")
    if placement_group_strategy is None:
        placement_group_strategy = sub.get("placement_group_strategy")
    if address is None:
        address = sub.get("address")
    merged_configs = dict(sub.get("configs", {}))
    merged_configs.update(configs or {})
    configs = merged_configs or None

    global _global_context
    with _context_lock:
        if _global_context is not None:
            raise RuntimeError("raydp_tpu_torch is already initialized; call stop() first")
        try:
            _global_context = _Context(
                app_name, num_executors, executor_cores, executor_memory,
                placement_group_strategy, configs, virtual_nodes,
                address=address)
            return _global_context.get_or_create_session()
        except BaseException:
            if _global_context is not None:
                try:
                    _global_context.stop()
                finally:
                    _global_context = None
            raise


def stop(cleanup_data: bool = True) -> None:
    """Stop the session. With ``cleanup_data=False`` the object store (and any
    datasets whose ownership was transferred to the master) survives, parity with
    ``stop_spark(cleanup_data=False)`` (context.py:152-162, dataset.py:146-158)."""
    global _global_context
    with _context_lock:
        if _global_context is not None:
            try:
                _global_context.stop(cleanup_data)
            finally:
                if cleanup_data:
                    _global_context = None


def active_session():
    with _context_lock:
        return _global_context.session if _global_context is not None else None


def _atexit_stop() -> None:
    """Process-exit sweep. Honors an earlier explicit
    ``stop(cleanup_data=False)``: the implicit exit must NOT reap the master
    that call deliberately kept — in attach mode that master (and the data it
    owns on the standalone head) is exactly what the next driver reads
    (parity: ownership survives driver exit, reference dataset.py:137-158)."""
    global _global_context
    with _context_lock:
        ctx = _global_context
        if ctx is None:
            return
        try:
            if ctx._kept_data:
                from raydp_tpu_torch.runtime import (
                    runtime_initialized, shutdown_runtime,
                )
                if runtime_initialized():
                    shutdown_runtime()  # client mode: detach only
            else:
                ctx.stop(True)
        except Exception:
            pass
        finally:
            _global_context = None


atexit.register(_atexit_stop)  # parity: context.py:257
