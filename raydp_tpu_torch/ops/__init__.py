"""raydp_tpu_torch.ops — the port's attention ops and their Hopper kernels.

- :mod:`flash_attention` — flash attention whose forward is a CUDA kernel
  written for Hopper (``csrc/flash_attention_fwd.cu``), with its plain
  PyTorch version for CPU tensors;
- :mod:`ring_attention` — so far the dense reference attention;
- :mod:`_build` — builds ``csrc/*.cu`` with ``nvcc`` at first use.
"""
