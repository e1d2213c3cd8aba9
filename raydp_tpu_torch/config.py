"""Configuration namespace — the port's copy of :mod:`raydp_tpu.config`.

The reference concentrates every tunable in a flat string-keyed conf under the
``spark.ray.*`` namespace (reference: core/raydp-main/src/main/java/org/apache/spark/
raydp/SparkOnRayConfigs.java:4-127, consumed at context.py:119-140 and
ray_cluster.py:126-189). We keep the same shape — a flat ``str -> str`` conf with a
``raydp.tpu.*`` namespace (the same keys as the reference) and typed getters —
so user programs can pass opaque configs through
``init_runtime(Config({...}))`` exactly like ``init_spark``.
"""

from __future__ import annotations

from typing import Dict, Optional

from raydp_tpu_torch.utils import parse_memory_size

# -- config keys (parity with SparkOnRayConfigs.java) --------------------------------
NAMESPACE = "raydp.tpu"

# executor actor resources, e.g. raydp.tpu.executor.actor.resource.cpu = 1.5
EXECUTOR_ACTOR_RESOURCE_PREFIX = f"{NAMESPACE}.executor.actor.resource"
# master actor resources (SparkOnRayConfigs.java: spark.ray.raydp_spark_master.actor.resource.*)
MASTER_ACTOR_RESOURCE_PREFIX = f"{NAMESPACE}.master.actor.resource"
# per-fetch-task resources for the recoverable dataset reader
# (reference: dataset.py:195-200, spark.ray.raydp_recoverable_fetch.task.resource.*)
RECOVERABLE_FETCH_TASK_RESOURCE_PREFIX = f"{NAMESPACE}.recoverable_fetch.task.resource"

PLACEMENT_GROUP_KEY = f"{NAMESPACE}.placement_group"
PLACEMENT_GROUP_BUNDLE_INDEXES_KEY = f"{NAMESPACE}.bundle_indexes"

EXECUTOR_RESTARTS_KEY = f"{NAMESPACE}.executor.max_restarts"   # default -1 (infinite)
OBJECT_STORE_MEMORY_KEY = f"{NAMESPACE}.object_store.memory"
OBJECT_STORE_DIR_KEY = f"{NAMESPACE}.object_store.dir"
LOG_DIR_KEY = f"{NAMESPACE}.log.dir"
LOG_LEVEL_KEY = f"{NAMESPACE}.log.level"
SHUFFLE_PARTITIONS_KEY = f"{NAMESPACE}.sql.shuffle.partitions"
BATCH_MAX_ROWS_KEY = f"{NAMESPACE}.arrow.batch.max_rows"
HEARTBEAT_INTERVAL_S_KEY = f"{NAMESPACE}.failure.heartbeat_interval_s"
HEARTBEAT_TIMEOUT_S_KEY = f"{NAMESPACE}.failure.heartbeat_timeout_s"
TRACE_DIR_KEY = f"{NAMESPACE}.trace.dir"
NATIVE_OBJECT_STORE_KEY = f"{NAMESPACE}.object_store.native"   # use C++ store core
#: shared-memory budget before sealed objects LRU-spill to disk; defaults to
#: the arena size (plasma eviction parity). "0" disables spilling.
SPILL_BUDGET_KEY = f"{NAMESPACE}.object_store.shm_budget"
SPILL_DIR_KEY = f"{NAMESPACE}.object_store.spill_dir"

_DEFAULTS: Dict[str, str] = {
    EXECUTOR_RESTARTS_KEY: "-1",
    SHUFFLE_PARTITIONS_KEY: "8",
    BATCH_MAX_ROWS_KEY: "65536",
    HEARTBEAT_INTERVAL_S_KEY: "1.0",
    HEARTBEAT_TIMEOUT_S_KEY: "10.0",
    LOG_LEVEL_KEY: "INFO",
    NATIVE_OBJECT_STORE_KEY: "auto",
}


class Config:
    """Flat string conf with typed getters (shape parity with Spark's ``SparkConf``)."""

    def __init__(self, configs: Optional[Dict[str, str]] = None):
        self._conf: Dict[str, str] = dict(_DEFAULTS)
        if configs:
            for k, v in configs.items():
                self._conf[str(k)] = str(v)

    def set(self, key: str, value) -> "Config":
        self._conf[key] = str(value)
        return self

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._conf.get(key, default)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self._conf.get(key)
        return default if v is None else int(v)

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self._conf.get(key)
        return default if v is None else float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._conf.get(key)
        if v is None:
            return default
        return v.strip().lower() in ("1", "true", "yes", "on")

    def get_memory(self, key: str, default: int = 0) -> int:
        v = self._conf.get(key)
        return default if v is None else parse_memory_size(v)

    def with_prefix(self, prefix: str) -> Dict[str, str]:
        """All entries under ``prefix.``, keyed by the suffix.

        Mirrors how the reference collects actor resources from
        ``spark.ray.raydp_spark_executor.actor.resource.*``
        (RayCoarseGrainedSchedulerBackend.scala:203-228).
        """
        p = prefix if prefix.endswith(".") else prefix + "."
        return {k[len(p):]: v for k, v in self._conf.items() if k.startswith(p)}

    def resource_map(self, prefix: str) -> Dict[str, float]:
        return {name: float(v) for name, v in self.with_prefix(prefix).items()}

    def items(self):
        return self._conf.items()

    def copy(self) -> "Config":
        c = Config()
        c._conf = dict(self._conf)
        return c
