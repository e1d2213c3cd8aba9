"""raydp_tpu_torch.parallel — port of :mod:`raydp_tpu.parallel`: the mesh
over a process group's ranks and the partition specs (:mod:`mesh`), the
parameter roles, their specs and the rematerialization policy over them
(:mod:`roles`), the sharded train state, its collectives and the
neighbour exchange (:mod:`shard`), the GPipe schedule over the ``stage``
axis (:mod:`pipeline`) and the collectives of a training gang
(:mod:`gang`).
"""

from raydp_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    MeshSpec,
    axis_index,
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
from raydp_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stage_params,
)
from raydp_tpu_torch.parallel.shard import ShardedModule, ppermute

__all__ = [
    "AXES",
    "Mesh",
    "MeshSpec",
    "REMAT_MODES",
    "REMAT_ROLES",
    "ShardedModule",
    "addressable_nbytes",
    "apply_remat",
    "axis_index",
    "batch_sharding",
    "classify_param",
    "data_axes",
    "describe_roles",
    "make_mesh",
    "param_sharding_rules",
    "parse_remat_policy",
    "pipeline_apply",
    "ppermute",
    "remat_mode_for_role",
    "replicated",
    "role_partition_spec",
    "segment_role",
    "seq_extent",
    "shard_params",
    "stack_stage_params",
    "stage_extent",
]
