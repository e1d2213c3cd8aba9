"""Native (C++) host code of the port. ``stage`` builds and binds
``raydp_tpu_torch/csrc/feed/stage.cpp``, the host-feed staging kernel."""

from raydp_tpu_torch.native.stage import native_stage_available, stage_table

__all__ = ["native_stage_available", "stage_table"]
