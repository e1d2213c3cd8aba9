"""raydp_tpu_torch.runtime — the built-in actor runtime substrate, the
port's copy of the JAX package's runtime (no module here touches a device).

The reference delegates its substrate to Ray core: actors, named-actor lookup,
placement groups, the plasma shared-memory object store, cross-language calls, and
actor restart (SURVEY.md §1 L1; reference RayExecutorUtils.java:37-62 configures
``maxRestarts=-1`` executor actors). This package provides the same primitives
natively. Placement is copied unchanged: a ``TPU`` bundle stays host-granular,
and no ``GPU`` resource is declared yet.

- :mod:`rpc` — length-prefixed cloudpickle request/response over TCP.
- :mod:`object_store` — shared-memory Arrow object store with object ownership.
- :mod:`actor` — actor processes, handles, named lookup, restart protocol.
- :mod:`head` — driver-side control plane: registry, nodes, placement groups.
"""

from raydp_tpu_torch.runtime.head import (
    RuntimeContext,
    init_runtime,
    shutdown_runtime,
    get_runtime,
    runtime_initialized,
)
from raydp_tpu_torch.runtime.actor import ActorHandle, actor_context, current_actor_context
from raydp_tpu_torch.runtime.cluster_resources import ClusterResources
from raydp_tpu_torch.runtime.object_store import ObjectRef, ObjectStoreClient
from raydp_tpu_torch.runtime.placement import PlacementGroup, PlacementStrategy

__all__ = [
    "ClusterResources",
    "RuntimeContext",
    "init_runtime",
    "shutdown_runtime",
    "get_runtime",
    "runtime_initialized",
    "ActorHandle",
    "actor_context",
    "current_actor_context",
    "ObjectRef",
    "ObjectStoreClient",
    "PlacementGroup",
    "PlacementStrategy",
]
