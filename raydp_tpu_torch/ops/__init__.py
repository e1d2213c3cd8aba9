"""raydp_tpu_torch.ops — the port's attention ops and their Hopper kernels.

- :mod:`flash_attention` — flash attention whose forward and backward are
  CUDA kernels written for Hopper (``csrc/flash_attention_fwd.cu``,
  ``csrc/flash_attention_bwd.cu``, sharing ``csrc/flash_attention_common.cuh``),
  with their plain PyTorch versions for CPU tensors;
- :mod:`ring_attention` — so far the dense reference attention;
- :mod:`_build` — builds ``csrc/*.cu`` with ``nvcc`` at first use.
"""
