"""raydp_tpu_torch.parallel — the one-device half of
:mod:`raydp_tpu.parallel`: the parameter-role classification and the
rematerialization policy over it (:mod:`roles`). Meshes, shardings and the
pipeline schedule are not ported yet (ROADMAP item 12).
"""

from raydp_tpu_torch.parallel.roles import (
    REMAT_MODES,
    REMAT_ROLES,
    addressable_nbytes,
    apply_remat,
    classify_param,
    parse_remat_policy,
    remat_mode_for_role,
    segment_role,
)

__all__ = [
    "REMAT_MODES",
    "REMAT_ROLES",
    "addressable_nbytes",
    "apply_remat",
    "classify_param",
    "parse_remat_policy",
    "remat_mode_for_role",
    "segment_role",
]
