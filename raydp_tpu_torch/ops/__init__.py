"""raydp_tpu_torch.ops — the port's attention ops, the row-sparse table
update, and their Hopper kernels.

- :mod:`flash_attention` — flash attention whose forward and backward are
  CUDA kernels written for Hopper (``csrc/flash_attention_fwd.cu``,
  ``csrc/flash_attention_bwd.cu``, sharing ``csrc/flash_attention_common.cuh``),
  with their plain PyTorch versions for CPU tensors;
- :mod:`ring_attention` — exact attention over a sequence split across a
  mesh's ``seq`` axis (K/V rotating around the ranks, each block folded by
  the flash kernels), and the dense reference attention;
- :mod:`row_sparse` — the update of embedding tables by a row-sparse
  gradient, one stable sort of every table's lookups, then a CUDA kernel
  (``csrc/row_sparse.cu``) that sums each id's rows and updates each
  distinct row once, with its plain PyTorch version for CPU tensors;
- :mod:`_build` — builds ``csrc/*.cu`` with ``nvcc`` at first use.
"""

from raydp_tpu_torch.ops.ring_attention import (
    ring_attention, ring_attention_sharded,
)

__all__ = ["ring_attention", "ring_attention_sharded"]
