"""raydp_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of raydp_tpu.

The JAX package ``raydp_tpu`` is the reference; this package mirrors its
layout where a counterpart exists and imports nothing from it (nor JAX). Every
Pallas TPU kernel on a ported path becomes a kernel written by hand for
Hopper under ``raydp_tpu_torch/csrc/``, built at first use by
:mod:`raydp_tpu_torch.ops._build`.

Ported so far: the long-context ``TransformerLM``, inference and training
(:mod:`raydp_tpu_torch.models.transformer`), on the flash-attention forward
and backward kernels (:mod:`raydp_tpu_torch.ops.flash_attention`); the
training half of the main path (:mod:`raydp_tpu_torch.train`); the actor
runtime and the object store (:mod:`raydp_tpu_torch.runtime`) under the
store-backed :class:`~raydp_tpu_torch.data.DistributedDataset`; the ETL
engine (:mod:`raydp_tpu_torch.etl`), whose session :func:`init` starts and
:func:`stop` ends, and the frame conversions that feed its output to
``TorchEstimator.fit_on_frame``; the estimator's dispatch plane (CUDA
graphs of the resident epoch's step and of ``steps_per_dispatch`` chains,
:mod:`raydp_tpu_torch.train.step_graph`), ``remat``
(:mod:`raydp_tpu_torch.parallel`), ``partial_fit`` over the continuous
pipelines of :mod:`raydp_tpu_torch.stream`, the serving plane
(:mod:`raydp_tpu_torch.serve`: ``export_serving`` bundles served from
replicas in the ETL executors, on the card), gradient-boosted trees grown
on the card (:mod:`raydp_tpu_torch.models.gbdt`,
:class:`~raydp_tpu_torch.train.GBDTEstimator`), the data bridges to a
training loop of the user's (``to_torch_dataset``, ``to_tf_dataset``),
``rdt-submit-torch`` (:mod:`raydp_tpu_torch.cli.submit`), the headline
examples (``examples/nyctaxi_mlp.py``, ``examples/stroke_pipeline.py``),
the project's static analysis over the port
(:mod:`raydp_tpu_torch.tools.rdtlint`), and the gang runner
(:mod:`raydp_tpu_torch.spmd`, rank processes under one
``torch.distributed`` process group) with gang training on it
(``TorchEstimator.fit_gang``).

    import raydp_tpu_torch
    session = raydp_tpu_torch.init("nyc", num_executors=2,
                                   executor_cores=1, executor_memory="1GB")
    df = session.read.csv("data.csv")
    ds = raydp_tpu_torch.data.from_frame_recoverable(df)

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise instead of quietly using the CPU.
Importing the package does not import torch, so the runtime's actor
processes (the ETL executors among them) start without it.
"""

__version__ = "0.1.0"

from raydp_tpu_torch.context import active_session, init, stop

__all__ = ["__version__", "active_session", "init", "resolve_device", "stop"]


def __getattr__(name):
    if name == "resolve_device":
        from raydp_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
