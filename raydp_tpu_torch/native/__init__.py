"""Native (C++) host code of the port. ``stage`` builds and binds
``raydp_tpu_torch/csrc/feed/stage.cpp``, the host-feed staging kernel;
``arena`` builds and binds ``raydp_tpu_torch/csrc/store/arena.cpp``, the
object store's shared-memory arena."""

from raydp_tpu_torch.native.arena import Arena, native_store_available
from raydp_tpu_torch.native.stage import native_stage_available, stage_table

__all__ = ["Arena", "native_stage_available", "native_store_available",
           "stage_table"]
