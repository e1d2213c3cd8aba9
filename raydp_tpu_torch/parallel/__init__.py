"""raydp_tpu_torch.parallel — port of :mod:`raydp_tpu.parallel`: the mesh
over a process group's ranks and the partition specs (:mod:`mesh`), the
parameter roles, their specs and the rematerialization policy over them
(:mod:`roles`), the sharded train state and its collectives (:mod:`shard`)
and the collectives of a training gang (:mod:`gang`). The pipeline
schedule (``pipeline_apply``, ``stack_stage_params``) is not ported yet
(ROADMAP item 12d).
"""

from raydp_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    MeshSpec,
    batch_sharding,
    data_axes,
    make_mesh,
    param_sharding_rules,
    replicated,
    seq_extent,
    shard_params,
    stage_extent,
)
from raydp_tpu_torch.parallel.roles import (
    REMAT_MODES,
    REMAT_ROLES,
    addressable_nbytes,
    apply_remat,
    classify_param,
    describe_roles,
    parse_remat_policy,
    remat_mode_for_role,
    role_partition_spec,
    segment_role,
)
from raydp_tpu_torch.parallel.shard import ShardedModule

__all__ = [
    "AXES",
    "Mesh",
    "MeshSpec",
    "REMAT_MODES",
    "REMAT_ROLES",
    "ShardedModule",
    "addressable_nbytes",
    "apply_remat",
    "batch_sharding",
    "classify_param",
    "data_axes",
    "describe_roles",
    "make_mesh",
    "param_sharding_rules",
    "parse_remat_policy",
    "remat_mode_for_role",
    "replicated",
    "role_partition_spec",
    "segment_role",
    "seq_extent",
    "shard_params",
    "stage_extent",
]
