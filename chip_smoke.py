#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (raydp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--baseline DIR]

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   port's CUDA kernels from ``raydp_tpu_torch/csrc`` for sm_90a (and, with
   ``--baseline DIR``, DIR's), one ``nvcc`` per source, all started
   together; checks that every bf16 (tensor-core) kernel instance has
   HGMMA instructions and spills nothing;
2. holds each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it (plus ragged and small shapes covering
   every compiled head dim), checks that two calls of each kernel agree
   bitwise, and times the kernel, the plain version and, as a yardstick the
   port never calls, PyTorch's ``scaled_dot_product_attention`` (its
   backward for the two backward kernels); with ``--baseline DIR`` it also
   times DIR's three kernels against this checkout's at the flagship shape,
   in turns;
3. full-width TransformerLM inference (dim 1024, 8 heads, 8 layers, vocab
   32768, bf16 activations, f32 params from a seeded generator) on three
   batches of B=2, T=8192 tokens through ``attention="flash"``; checks
   logits, ``lm_loss`` and ``lm_loss_fused``, and the flash model's logits
   against ``attention="dense"`` on a T=2048 batch;
4. LM training: full-width training of the same model with Adam(1e-3) on
   one repeated B=2, T=8192 batch, 4 steps on ``lm_loss`` and 2 on
   ``lm_loss_fused(remat=True)`` from the same initial weights; checks the
   losses, the launches of all three kernels and that remat lowers the peak
   memory; then the full model's parameter gradients through flash vs dense
   attention at T=2048 (f32 and bf16);
5. the main path, NYCTaxi: ``TorchEstimator`` fit -> checkpoint -> predict
   of ``NYCTaxiModel`` (25 features, 256-128-64-16-1 with BatchNorm, smooth
   L1, Adam 1e-3) at bench.py's size, 400,000 seeded rows in 8 blocks,
   batch 8192: 5 epochs on the device-resident path and 2 on the streaming
   feed, each in f32 and in bf16; prints every epoch's report, the peak
   memory and a profile of one steady epoch (device busy, idle share, top
   kernels); checks that the loss falls, that the first 20 f32 step losses
   on the card match the same fit on the CPU, the checkpoint dirs, that a
   fit whose callback raises once at epoch 2 (``max_retries=1``) ends as an
   uninterrupted one, that the resident and streaming paths give the same
   unshuffled epoch-0 loss, and that ``predict`` on a ragged row count is a
   plain forward of ``get_model()``;
6. the main path, DLRM at bench.py's widths (13 dense + 26 tables of 1,001
   rows, embedding 32, bottom 512-128-32, top 1024-1024-512-256-1,
   BCE-with-logits, the ``optax.adagrad(1e-2)`` mapping, bf16): 120,000
   seeded Criteo-shaped rows, batch 4096, 4 resident and 2 streaming
   epochs, the same lines and the falling loss;
7. the main path fed from the object store: the port's runtime (head and
   two actors, the arena of 1 GiB in /dev/shm required, its g++ build
   included) is started and timed, with one cold and one warm-forked actor
   spawn (and, to read them, a bare interpreter, the actor's imports and
   torch's); the actors write phases 5-6's NYCTaxi and DLRM blocks with
   ``put_arrow_many`` (MB/s, beside the IPC serialisation alone and one
   copy into fresh memory), whose ``DistributedDataset.to_arrow()`` must
   equal the source tables; then NYCTaxi f32 (streaming and resident) and
   DLRM bf16 (streaming) fit unshuffled for 2 epochs from the store-backed
   dataset and from a ``TableDataset`` of the same tables, in turns, each
   epoch's loss within 1e-6 of the first fit's; ``predict`` on a
   store-backed dataset is a plain forward; ``split_shards(2)`` reads every
   row once; the driver's put into fresh and into reused arena pages is
   timed; a warm-forked actor allocates on the card; and no segment of
   the session is left after ``shutdown_runtime``;
8. prints one JSON line of kernel results, then the last line
   ``{"ok": true, "device": {...}}``.

The phases run in the order 1, 2, 5, 6, 7, 3, 4: phases 5-7 are bound by
the host's kernel launches, so their timed fits come before any
``torch.profiler`` session of the process, and the two profiled epochs of
5-6 (one per model, in fits of their own) after the timed fits. Every
kernel launch counter is set to 0 just before each driven path (3, both
modes of 4, 5, 6 and 7) and read just after; 5-7 run no attention and must
launch none. Any failed check exits non-zero; so does a machine without
CUDA.
"""

from __future__ import annotations

import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# NVIDIA H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# kernel checks: (B, T, H, D, dtype, causal); the first is the main path's.
# Every compiled head dim of each dtype's kernels is checked, the bf16 ones
# at a T that is not a multiple of their 64- and 128-row tiles.
KERNEL_SHAPES = [(2, 8192, 8, 128, torch.bfloat16, True),
                 (2, 1000, 4, 64, torch.float32, False),
                 (1, 512, 2, 32, torch.float32, True),
                 (2, 300, 2, 16, torch.bfloat16, True),
                 (2, 1000, 4, 64, torch.bfloat16, False),
                 (1, 777, 2, 32, torch.bfloat16, True)]
# out is held elementwise: |out - plain| <= atol + rtol * |plain| (+ the
# bound below in bf16). Both sides compute the same f32 value in another
# summation order (a difference of ~1e-6) and bf16 rounds it: two
# neighbouring bf16 values are at most 2^-7 of the smaller apart, so bf16
# allows one rounding step and 1e-5 for the f32 sums. Typical |out| at
# T = 8192 is ~0.02, so an absolute bf16 limit would be as large as the
# values. The bf16 kernel also rounds p to bf16 before p·v, as the Pallas
# kernel does (`p.astype(v.dtype)`), while `_fwd_plain` keeps p in f32 and l
# is summed from the unrounded p on both sides: each rounded p errs by at
# most 2^-8 of itself, so out moves by at most 2^-8 softmax(s)·|v|
# elementwise (`_fwd_rounding_bound`), added to the bf16 limit. Without it
# the reference's own Pallas kernel uses up to 89 times the one-step limit
# against `_fwd_plain` on the CPU (outputs near zero, which have almost no
# relative room); with it at most 0.66. f32 out: f32 sums in another order.
# lse: O(10) magnitude in f32.
OUT_TOL = {torch.bfloat16: (1e-5, 2.0 ** -7), torch.float32: (1e-4, 0.0)}
LSE_ATOL = 1e-3
# dq, dk, dv are held elementwise: |got - plain| <= rtol (|plain| + rms(plain))
# (+ the bound below in bf16). A recomputed product rounded to bf16 errs by
# ~2^-9 per term with random sign, so over n terms by ~2^-9 of the result's
# rms; with the one final rounding to bf16 (2^-7 of the smaller neighbour)
# that is one bf16 step. f32: sums in another order. A dropped or doubled
# 64-row tile of an 8192-row sum moves elements by ~9 % of rms, far past
# either limit.
# The bf16 kernels also round p and ds to bf16 before the dv, dk and dq
# products, as the Pallas kernels do (`p.astype(do.dtype)`); `_bwd_plain`
# keeps them in f32. Each rounded value errs by at most 2^-8 of itself
# (bf16's unit roundoff), so each product moves by at most 2^-8 (|p|ᵀ|do|,
# |ds|ᵀ|q|, |ds||k|) elementwise: `_bwd_rounding_bound`, added to the bf16
# limit. Without it the reference's own Pallas kernels use up to 2.03 of the
# one-step limit against `_bwd_plain` on the CPU (causal rows with few keys,
# where few large p do not average out); with it the CUDA kernels used at
# most 0.65 of the limit at the flagship shape (PERF.md).
GRAD_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}

VOCAB, DIM, HEADS, LAYERS = 32768, 1024, 8, 8
BATCH, SEQ, BATCHES, SEED = 2, 8192, 3, 0
DENSE_SEQ = 2048
# training: bench.py's _lm_mode_run (Adam 1e-3, one repeated batch); steps on
# lm_loss over materialized logits, then on lm_loss_fused(remat=True)
LR, TRAIN_STEPS = 1e-3, {"lm_loss": 4, "lm_loss_fused": 2}
# a random-init model's cross entropy lies near ln(VOCAB) = 10.397
LOSS_RANGE = (9.0, 12.0)
# lm_loss runs the head in bf16, lm_loss_fused in f32: per logit a relative
# difference of up to 2^-8 (bf16), i.e. <= 0.02 at |logit| <= 5, which bounds
# the difference of the mean cross entropy
FUSED_LOSS_ATOL = 2e-2
# flash vs dense logits (relative L2). In f32 only the order of f32 sums
# differs. In bf16 both attentions are f32 inside and round to bf16, and
# single flipped roundings travel the 8-layer residual stream; two such bf16
# runs may differ by up to twice (√2 for independent errors, with margin) the
# bf16 model's own error against f32, which the run measures.
DENSE_REL_TOL_F32 = 1e-4
# flash vs dense parameter gradients (relative L2 over all of them): the same
# reasoning as for the logits
GRAD_REL_TOL_F32 = 1e-4
# NYCTaxi: the feature count of examples/nyctaxi_features.py's pipeline
# (pinned by tests/test_torch_estimator.py)
NYCTAXI_FEATURES = 25
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "flash_attention_fwd": ("raydp_tpu_torch/csrc/flash_attention_fwd.cu",
                            "raydp_tpu/ops/flash_attention.py:45"),
    "flash_attention_bwd_dkdv": (
        "raydp_tpu_torch/csrc/flash_attention_bwd.cu",
        "raydp_tpu/ops/flash_attention.py:190"),
    "flash_attention_bwd_dq": ("raydp_tpu_torch/csrc/flash_attention_bwd.cu",
                               "raydp_tpu/ops/flash_attention.py:227"),
}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(kernel: str, bh: int, t: int, d: int,
                    dtype: torch.dtype, causal: bool) -> dict:
    """Least time (ms) for one call of ``kernel``: its [BH, T, D] tensors and
    [BH, T] f32 rows read or written once; its [T, T] products over the
    (q, k) pairs this run's mask keeps (2·D operations per pair each).
    Returns ``bound_ms``, ``bound_by`` and the operation count ``flops``."""
    products, tensors, rows = {
        "flash_attention_fwd": (2, 4, 1),       # s, pv; q k v out; lse
        "flash_attention_bwd_dkdv": (4, 6, 2),  # s dp dv dk; q k v do dk dv
        "flash_attention_bwd_dq": (3, 5, 2),    # s dp dq; q k v do dq
    }[kernel]                                   # rows: lse (and delta)
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 2.0 * products * bh * d * pairs
    nbytes = (tensors * bh * t * d * torch.finfo(dtype).bits // 8
              + rows * bh * t * 4)
    op_ms = flops / PEAK_FLOPS[dtype] * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound = (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")
    return {"bound_ms": bound[0], "bound_by": bound[1], "flops": flops}


def rates(bound: dict, ms: float) -> dict:
    """The bound's keys for a kernel row, with the achieved ``tflops`` and
    ``bound_share`` = bound_ms / ms of a call that took ``ms``."""
    return {"bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "tflops": bound["flops"] / ms * 1e-9,
            "bound_share": bound["bound_ms"] / ms}


SOURCES = ("flash_attention_fwd", "flash_attention_bwd")
# the bf16 kernels that must run on the tensor cores, per source
TC_KERNELS = {"flash_attention_fwd": ("fwd_tc_kernel",),
              "flash_attention_bwd": ("dkdv_tc_kernel", "dq_tc_kernel")}


def build_kernels(fa, baseline_root=None):
    """Phase 1: one nvcc per source (and per baseline source), all started
    together; print each log; every tensor-core kernel instance must show
    HGMMA and no spills. Returns the baseline's entries (``{"fwd", "dkdv",
    "dq"}``) or None."""
    from raydp_tpu_torch.ops import _build

    def timed(build, name):
        t0 = time.perf_counter()
        return build(name), time.perf_counter() - t0

    jobs = [(_build.build, name) for name in SOURCES]
    if baseline_root is not None:
        jobs += [(lambda name: build_baseline(baseline_root, name), name)
                 for name in SOURCES]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: timed(*job), jobs))
    for i, ((_, name), (lib, seconds)) in enumerate(zip(jobs, built)):
        print(f"built {lib.name} in {seconds:.1f} s")
        if i < len(SOURCES):             # this checkout's: ptxas, SASS
            log = lib.with_suffix(".log").read_text().strip()
            print(log)
            check_tensor_cores(name, log, mma_counts(lib))
    fa._fwd_entry()
    fa._bwd_entries()
    if baseline_root is None:
        return None
    import ctypes
    libs = {name: ctypes.CDLL(str(lib))
            for (_, name), (lib, _) in zip(jobs[len(SOURCES):],
                                           built[len(SOURCES):])}
    return {"fwd": fa._fwd_bind(libs["flash_attention_fwd"]),
            **fa._bwd_bind(libs["flash_attention_bwd"])}


def kernel_label(mangled: str) -> str:
    """``fwd_tc_kernel<128>``, ``dq_kernel<float, 64>`` ... of a mangled
    kernel name (the name itself where it does not parse)."""
    import re

    m = re.search(r"\d+([A-Za-z_]+_kernel)I(f|13__nv_bfloat16)?Li(\d+)E",
                  mangled)
    if not m:
        return mangled
    dtype = {"f": "float, ", "13__nv_bfloat16": "bf16, "}.get(m[2], "")
    return f"{m[1]}<{dtype}{m[3]}>"


def mma_counts(lib):
    """{kernel label: (HGMMA, HMMA)} of a built library, from ``cuobjdump
    -sass`` (beside ``nvcc``; None where the toolkit lacks it): HGMMA is
    Hopper's warpgroup product, HMMA the warp-level one. Prints one line
    per kernel."""
    import re
    from pathlib import Path

    from raydp_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not tool.is_file():
        print(f"sass {lib.name}: no cuobjdump beside nvcc (not measured)")
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for section in sass.split("Function : ")[1:]:
        label = kernel_label(section.split(None, 1)[0])
        counts[label] = (len(re.findall(r"\bHGMMA", section)),
                         len(re.findall(r"\bHMMA", section)))
        print(f"sass {label}: {counts[label][0]} HGMMA, "
              f"{counts[label][1]} HMMA")
    return counts


def check_tensor_cores(name: str, ptxas_log: str, counts) -> None:
    """Every tensor-core kernel of source ``name``, at every compiled head
    dim, spills nothing (ptxas) and, where the SASS was read, has HGMMA."""
    import re

    spills, kernel = {}, None
    for line in ptxas_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            kernel = kernel_label(m[1])
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and kernel:
            spills[kernel] = int(m[1]) + int(m[2])
    for base in TC_KERNELS[name]:
        for d in (16, 32, 64, 128):
            label = f"{base}<{d}>"
            require(spills.get(label) == 0,
                    f"{label}: spills {spills.get(label)} bytes (ptxas)")
            if counts is not None:
                require(counts.get(label, (0, 0))[0] > 0,
                        f"{label}: no HGMMA in its SASS")


def zero_launches(fa) -> None:
    fa.FWD_LAUNCHES = fa.DKDV_LAUNCHES = fa.DQ_LAUNCHES = 0


def launches(fa) -> dict:
    return {"flash_attention_fwd": fa.FWD_LAUNCHES,
            "flash_attention_bwd_dkdv": fa.DKDV_LAUNCHES,
            "flash_attention_bwd_dq": fa.DQ_LAUNCHES}


def check_kernel(fa, device, gen, baseline=None) -> dict:
    """Phase 2: the flash forward kernel vs ``_fwd_plain`` at each shape; a
    second call must give bitwise the same out and lse. With ``baseline``
    (the entries built from another checkout), the kernel at the flagship
    shape is timed against the baseline's in turns. Returns the flagship
    shape's row."""
    import torch.nn.functional as F

    main = None
    for b, t, h, d, dtype, causal in KERNEL_SHAPES:
        q3, k3, v3 = [torch.randn(b * h, t, d, generator=gen, device=device)
                      .to(dtype) for _ in range(3)]
        scale = 1.0 / math.sqrt(d)
        out, lse = fa._fwd_cuda(q3, k3, v3, scale, causal)
        again = fa._fwd_cuda(q3, k3, v3, scale, causal)
        ref_out, ref_lse = fa._fwd_plain(q3, k3, v3, scale, causal)
        bound = (fa._fwd_rounding_bound(q3, k3, v3, scale, causal)
                 if dtype == torch.bfloat16 else 0.0)
        torch.cuda.synchronize()
        repeatable = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        diff = (out.float() - ref_out.float()).abs()
        atol, rtol = OUT_TOL[dtype]
        err_out = diff.max().item()
        # the largest share of its limit that any element uses (<= 1 passes),
        # and of the one-step limit without the p-rounding bound
        one_step = atol + rtol * ref_out.float().abs()
        tol_used = (diff / (one_step + bound)).max().item()
        one_step_used = (diff / one_step).max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        del again, bound, one_step
        ms = time_ms(lambda: fa._fwd_cuda(q3, k3, v3, scale, causal))
        plain_ms = time_ms(lambda: fa._fwd_plain(q3, k3, v3, scale, causal),
                           reps=5)
        q4, k4, v4 = (x.view(b, h, t, d) for x in (q3, k3, v3))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale))
        bound = attention_bound("flash_attention_fwd", b * h, t, d, dtype,
                                causal)
        ab = {}
        if baseline is not None and main is None:
            outs = (torch.empty_like(q3),
                    torch.empty((b * h, t), device=device))

            def entry(fn):
                return lambda: require(fn(
                    *(x.data_ptr() for x in (q3, k3, v3, *outs)), b * h, t,
                    d, scale, int(causal), fa._KERNEL_DTYPES[dtype],
                    torch.cuda.current_stream().cuda_stream) == 0,
                    "forward launch failed")

            ab = ab_turns("flash_attention_fwd", entry(baseline["fwd"]),
                          entry(fa._fwd_entry()))
            del outs
        row = {"shape": [b, t, h, d], "dtype": str(dtype).split(".")[-1],
               "causal": causal, "max_abs_err": err_out,
               "out_tol": [atol, rtol], "out_tol_used": tol_used,
               "out_one_step_used": one_step_used,
               "lse_max_abs_err": err_lse, "repeatable": repeatable,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               **rates(bound, ms), **ab}
        print("kernel flash_attention_fwd " + json.dumps(row))
        require(bool(torch.isfinite(out.float()).all()), f"non-finite out {row}")
        require(tol_used <= 1.0, f"out differs from plain: {row}")
        require(err_lse <= LSE_ATOL, f"lse differs from plain: {row}")
        require(repeatable, f"two forward calls differ: {row}")
        main = main or row
        del q3, k3, v3, q4, k4, v4, out, lse, ref_out, ref_lse, diff
        torch.cuda.empty_cache()
    return main


def rel_err(got: torch.Tensor, ref: torch.Tensor, rtol: float,
            bound=0.0) -> dict:
    """Largest |got - ref| and the largest share of the elementwise limit
    rtol (|ref| + rms(ref)) + bound that any element uses (<= 1 passes)."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    limit = rtol * (ref.abs() + ref.square().mean().sqrt()) + bound
    return {"max_abs_err": diff.max().item(),
            "tol_used": (diff / limit).max().item(),
            "finite": bool(torch.isfinite(got).all())}


def check_bwd_kernels(fa, device, gen, baseline=None) -> dict:
    """Phase 2: the dk/dv and dq kernels vs ``_bwd_plain`` at each shape,
    from identical inputs (``do`` seeded, ``out`` and ``lse`` from the plain
    forward); a second call must give bitwise the same dq, dk and dv. With
    ``baseline`` (the backward library built from another checkout), each
    kernel at the flagship shape is timed against it in turns (baseline,
    this, this, baseline). Returns the flagship shape's row of each
    kernel."""
    import torch.nn.functional as F

    main = {}
    for b, t, h, d, dtype, causal in KERNEL_SHAPES:
        bh, scale = b * h, 1.0 / math.sqrt(d)
        q3, k3, v3, do = [torch.randn(bh, t, d, generator=gen, device=device)
                          .to(dtype) for _ in range(4)]
        out, lse = fa._fwd_plain(q3, k3, v3, scale, causal)
        got = fa._bwd_cuda(q3, k3, v3, out, lse, do, scale, causal)
        again = fa._bwd_cuda(q3, k3, v3, out, lse, do, scale, causal)
        ref = fa._bwd_plain(q3, k3, v3, out, lse, do, scale, causal,
                            fa.DEFAULT_BLOCK_K)
        bounds = (fa._bwd_rounding_bound(q3, k3, v3, out, lse, do, scale,
                                         causal)
                  if dtype == torch.bfloat16 else (0.0, 0.0, 0.0))
        torch.cuda.synchronize()
        errs = {name: rel_err(g, r, GRAD_RTOL[dtype], bd)
                for name, g, r, bd in zip(("dq", "dk", "dv"), got, ref,
                                          bounds)}
        repeatable = all(torch.equal(x, y) for x, y in zip(got, again))
        del got, again, ref, bounds

        # each kernel alone on the inputs _bwd_cuda checked
        delta = (do.float() * out.float()).sum(-1)
        dq, dk, dv = (torch.empty_like(q3) for _ in range(3))
        inputs = (q3, k3, v3, do, lse, delta)
        calls = {"flash_attention_bwd_dkdv": ("dkdv", (dk, dv)),
                 "flash_attention_bwd_dq": ("dq", (dq,))}
        ms = {name: time_ms(lambda: fa._launch_bwd(
                  kernel, *inputs, outs, scale, causal))
              for name, (kernel, outs) in calls.items()}
        plain_ms = time_ms(lambda: fa._bwd_plain(
            q3, k3, v3, out, lse, do, scale, causal, fa.DEFAULT_BLOCK_K),
            reps=5)
        q4, k4, v4 = (x.view(b, h, t, d).detach().requires_grad_()
                      for x in (q3, k3, v3))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                              scale=scale)
        do4 = do.view(b, h, t, d)
        library_ms = time_ms(lambda: torch.autograd.grad(
            out4, (q4, k4, v4), do4, retain_graph=True))
        shape = {"shape": [b, t, h, d], "dtype": str(dtype).split(".")[-1],
                 "causal": causal, "grad_rtol": GRAD_RTOL[dtype],
                 "repeatable": repeatable, **{
                     f"{n}_{k}": v for n, e in errs.items()
                     for k, v in e.items() if k != "finite"}}
        ab = {}
        if baseline is not None and not main:
            ab = compare_baseline(fa, baseline, calls, inputs, scale, causal)
        for name, kernel_ms in ms.items():
            bound = attention_bound(name, bh, t, d, dtype, causal)
            outputs = ("dk", "dv") if name.endswith("dkdv") else ("dq",)
            row = {**shape, "ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, **rates(bound, kernel_ms),
                   "max_abs_err": max(errs[o]["max_abs_err"]
                                      for o in outputs), **ab.get(name, {})}
            print(f"kernel {name} " + json.dumps(row))
            main.setdefault(name, row)
        for name, e in errs.items():
            require(e["finite"], f"non-finite {name} at {shape['shape']}")
            require(e["tol_used"] <= 1.0,
                    f"{name} differs from plain: {shape}")
        require(repeatable, f"two backward calls differ: {shape}")
        del q3, k3, v3, do, out, lse, delta, dq, dk, dv, q4, k4, v4, out4
        torch.cuda.empty_cache()
    return main


def build_baseline(root: str, name: str):
    """The library built from ``root``'s ``raydp_tpu_torch/csrc/<name>.cu``
    (whose C signature is this checkout's) with this checkout's flags, into
    this checkout's git-ignored build directory."""
    from pathlib import Path

    from raydp_tpu_torch.ops import _build

    src = Path(root) / "raydp_tpu_torch" / "csrc" / f"{name}.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _build.BUILD_DIR / f"baseline_{name}.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    str(lib_path), str(src)], check=True, capture_output=True)
    return lib_path


def ab_turns(name: str, theirs, ours) -> dict:
    """``theirs`` and ``ours`` (one launch each) timed in turns (baseline,
    this, this, baseline). Returns {"baseline_ms", "ab_ms", "speedup",
    "ab_turns_ms"}."""
    turns = [time_ms(fn) for fn in (theirs, ours, ours, theirs)]
    base = statistics.mean(turns[0::3])
    this = statistics.mean(turns[1:3])
    print(f"ab {name}: baseline {turns[0]:.3f}, this {turns[1]:.3f}, "
          f"this {turns[2]:.3f}, baseline {turns[3]:.3f} ms; speedup "
          f"{base / this:.2f}x")
    return {"baseline_ms": base, "ab_ms": this, "speedup": base / this,
            "ab_turns_ms": turns}


def compare_baseline(fa, baseline, calls, inputs, scale, causal) -> dict:
    """Each backward kernel and the baseline's at the same inputs, timed in
    turns (:func:`ab_turns`); the baseline's launches are not counted.
    Returns {name: ab_turns' dict}."""
    q3 = inputs[0]
    bh, t, d = q3.shape
    result = {}
    for name, (kernel, outs) in calls.items():
        def theirs():
            err = baseline[kernel](
                *(x.data_ptr() for x in (*inputs, *outs)), bh, t, d, scale,
                int(causal), fa._KERNEL_DTYPES[q3.dtype],
                torch.cuda.current_stream().cuda_stream)
            require(err == 0, f"baseline {kernel} launch failed: {err}")

        def ours():
            fa._launch_bwd(kernel, *inputs, outs, scale, causal)

        result[name] = ab_turns(name, theirs, ours)
    return result


def profile_step(label: str, fn) -> None:
    """Device time by kernel for one call of ``fn`` (torch.profiler,
    CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        print("profile: no device time recorded (not measured)")
        return
    print(f"profile: {label} device time {total_us / 1e3:.3f} ms by kernel")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms "
              f"{100 * e.self_device_time_total / total_us:5.1f}% "
              f"x{e.count:<4d} {e.key[:90]}")


def make_model(device, attention: str = "flash",
               dtype: torch.dtype = torch.bfloat16):
    """The full-width model; the seeded generator gives every call the same
    initial weights."""
    from raydp_tpu_torch.models import TransformerLM

    return TransformerLM(
        VOCAB, dim=DIM, num_heads=HEADS, num_layers=LAYERS,
        attention=attention, dtype=dtype, device=device,
        generator=torch.Generator(device=device).manual_seed(SEED))


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def run_lm(fa, device) -> dict:
    """Phase 3: full-width TransformerLM inference."""
    from raydp_tpu_torch.models import lm_loss, lm_loss_fused

    def make(attention: str, dtype: torch.dtype = torch.bfloat16):
        return make_model(device, attention, dtype).eval()

    model = make("flash")
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(SEED)
    batches = [torch.from_numpy(rng.randint(0, VOCAB, size=(BATCH, SEQ)))
               .to(device) for _ in range(BATCHES)]
    print(f"lm: {n_params / 1e6:.1f}M params, dim {DIM}, {LAYERS} layers, "
          f"{HEADS} heads, vocab {VOCAB}, bf16 activations; "
          f"{BATCHES} batches of {BATCH}x{SEQ} tokens")

    torch.cuda.synchronize()
    zero_launches(fa)
    seconds, results = [], []
    with torch.inference_mode():
        for tokens in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hidden = model(tokens, return_hidden=True)
            logits = model.lm_head(hidden).float()   # == model(tokens)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            results.append((bool(torch.isfinite(logits).all()),
                            tuple(logits.shape),
                            lm_loss(logits, tokens).item(),
                            lm_loss_fused(hidden, model.lm_head.kernel,
                                          tokens).item()))
            del logits, hidden
    counts = launches(fa)
    launched = counts["flash_attention_fwd"]

    for i, (finite, shape, loss, fused) in enumerate(results):
        print(f"lm batch {i}: forward {seconds[i] * 1e3:.3f} ms, "
              f"{BATCH * SEQ / seconds[i]:.1f} tokens/s, lm_loss {loss:.6f}, "
              f"lm_loss_fused {fused:.6f}, |diff| {abs(loss - fused):.3e}")
        require(shape == (BATCH, SEQ, VOCAB), f"logits shape {shape}")
        require(finite, f"batch {i}: non-finite logits")
        require(LOSS_RANGE[0] <= loss <= LOSS_RANGE[1], f"batch {i}: lm_loss "
                f"{loss} not near ln({VOCAB}) = {math.log(VOCAB):.3f}")
        require(abs(loss - fused) <= FUSED_LOSS_ATOL,
                f"batch {i}: lm_loss_fused {fused} vs lm_loss {loss}")
    expected = {"flash_attention_fwd": LAYERS * BATCHES,
                "flash_attention_bwd_dkdv": 0, "flash_attention_bwd_dq": 0}
    require(counts == expected,
            f"inference launched {counts}, expected {expected}")
    steady = statistics.median(seconds[1:])
    print(f"lm forward: {BATCH * SEQ / steady:.1f} tokens/s steady "
          f"(median of batches 1..{BATCHES - 1}, {steady * 1e3:.3f} ms), "
          f"first batch {seconds[0] * 1e3:.3f} ms; flash launches {launched}")

    # reference check on a shorter batch, same weights: flash vs dense
    # attention in f32 (the wiring), and in bf16 against bf16's own error
    tokens = batches[0][:, :DENSE_SEQ]
    logits = {}
    with torch.inference_mode():
        logits["flash", torch.bfloat16] = model(tokens)
        for attention, dtype in (("dense", torch.bfloat16),
                                 ("flash", torch.float32),
                                 ("dense", torch.float32)):
            other = make(attention, dtype)
            other.load_state_dict(model.state_dict())
            logits[attention, dtype] = other(tokens)
            del other

    def rel(a, b):
        return ((logits[a] - logits[b]).norm() / logits[b].norm()).item()

    bf16, f32 = torch.bfloat16, torch.float32
    rel_f32 = rel(("flash", f32), ("dense", f32))
    rel_bf16 = rel(("flash", bf16), ("dense", bf16))
    floor = rel(("dense", bf16), ("dense", f32))
    print(f"lm flash vs dense logits at T={DENSE_SEQ}, relative L2: f32 "
          f"{rel_f32:.3e}; bf16 {rel_bf16:.3e} (bf16 dense vs f32 dense "
          f"{floor:.3e})")
    require(rel_f32 <= DENSE_REL_TOL_F32,
            f"f32 flash vs dense relative error {rel_f32}")
    require(rel_bf16 <= 2 * floor,
            f"bf16 flash vs dense relative error {rel_bf16} > 2 x {floor}")
    del logits

    def forward():
        with torch.inference_mode():
            model.lm_head(model(batches[1], return_hidden=True)).float()

    profile_step("forward", forward)
    return {"launches": launched, "tokens_per_s": BATCH * SEQ / steady}


def train_step(model, opt, tokens, mode: str) -> torch.Tensor:
    """One Adam step on ``lm_loss`` (materialized logits) or on
    ``lm_loss_fused(remat=True)``; returns the loss before the step."""
    from raydp_tpu_torch.models import lm_loss, lm_loss_fused

    opt.zero_grad(set_to_none=True)
    if mode == "lm_loss":
        loss = lm_loss(model(tokens), tokens)
    else:
        loss = lm_loss_fused(model(tokens, return_hidden=True),
                             model.lm_head.kernel, tokens, remat=True)
    loss.backward()
    opt.step()
    return loss


def run_train(fa, device) -> dict:
    """Phase 4, the main path: full-width training, the counterpart of
    bench.py's ``_lm_mode_run``. Each mode starts from the same seeded
    initial weights on a freshly emptied card; the launch counters are set
    to 0 just before each mode's steps and read just after."""
    tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, VOCAB, size=(BATCH, SEQ))).to(device)
    result = {"launches": dict.fromkeys(launches(fa), 0)}
    for mode, steps in TRAIN_STEPS.items():
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        model = make_model(device)
        opt = torch.optim.Adam(model.parameters(), lr=LR,
                               betas=(0.9, 0.999), eps=1e-8)
        torch.cuda.synchronize()
        zero_launches(fa)
        losses, seconds = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(train_step(model, opt, tokens, mode).item())
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        counts = launches(fa)
        peak = torch.cuda.max_memory_allocated()
        steady = statistics.median(seconds[1:])
        for i, (loss, sec) in enumerate(zip(losses, seconds)):
            print(f"train {mode} step {i}: loss {loss:.6f}, "
                  f"{sec * 1e3:.3f} ms, {BATCH * SEQ / sec:.1f} tokens/s")
        print(f"train {mode}: {BATCH * SEQ / steady:.1f} tokens/s steady "
              f"(median of steps 1..{steps - 1}, {steady * 1e3:.3f} ms), "
              f"first step {seconds[0] * 1e3:.3f} ms; peak memory "
              f"{peak / 2 ** 30:.3f} GiB; launches {counts}")
        require(all(map(math.isfinite, losses)), f"{mode}: losses {losses}")
        require(LOSS_RANGE[0] <= losses[0] <= LOSS_RANGE[1], f"{mode}: step-0 "
                f"loss {losses[0]} not near ln({VOCAB}) = "
                f"{math.log(VOCAB):.3f}")
        require(all(n == LAYERS * steps for n in counts.values()),
                f"{mode}: launches {counts}, expected {LAYERS * steps} each")
        for name, n in counts.items():
            result["launches"][name] += n
        result[mode] = {"losses": losses, "peak_bytes": peak,
                        "tokens_per_s": BATCH * SEQ / steady}
        if mode == "lm_loss":
            require(losses[-1] < losses[0],
                    f"lm_loss did not fall on the repeated batch: {losses}")
            profile_step("train step (lm_loss)",
                         lambda: train_step(model, opt, tokens, mode))
        del model, opt
    a, b = result["lm_loss"], result["lm_loss_fused"]
    require(abs(a["losses"][0] - b["losses"][0]) <= FUSED_LOSS_ATOL,
            f"step-0 losses differ: lm_loss {a['losses'][0]}, "
            f"lm_loss_fused {b['losses'][0]}")
    require(b["peak_bytes"] < a["peak_bytes"],
            f"remat peak {b['peak_bytes']} not below materialized "
            f"{a['peak_bytes']}")
    return result


def check_grads(device) -> None:
    """Phase 5: all parameter gradients of ``lm_loss`` at T=2048, same
    initial weights, through flash vs dense attention: in f32 the wiring of
    the backward kernels; in bf16 against bf16's own distance from f32."""
    from raydp_tpu_torch.models import lm_loss

    tokens = torch.from_numpy(np.random.RandomState(SEED + 1).randint(
        0, VOCAB, size=(BATCH, DENSE_SEQ))).to(device)
    grads = {}
    for attention in ("flash", "dense"):
        for dtype in (torch.bfloat16, torch.float32):
            model = make_model(device, attention, dtype)
            lm_loss(model(tokens), tokens).backward()
            grads[attention, dtype] = torch.cat(
                [p.grad.flatten() for p in model.parameters()])
            del model
            free_memory()

    def rel(a, b):
        return ((grads[a] - grads[b]).norm() / grads[b].norm()).item()

    bf16, f32 = torch.bfloat16, torch.float32
    rel_f32 = rel(("flash", f32), ("dense", f32))
    rel_bf16 = rel(("flash", bf16), ("dense", bf16))
    floor = rel(("dense", bf16), ("dense", f32))
    print(f"lm flash vs dense parameter gradients at T={DENSE_SEQ}, relative "
          f"L2: f32 {rel_f32:.3e}; bf16 {rel_bf16:.3e} (bf16 dense vs f32 "
          f"dense {floor:.3e})")
    require(all(bool(torch.isfinite(g).all()) for g in grads.values()),
            "non-finite parameter gradients")
    require(rel_f32 <= GRAD_REL_TOL_F32,
            f"f32 flash vs dense gradient relative error {rel_f32}")
    require(rel_bf16 <= 2 * floor,
            f"bf16 flash vs dense gradient relative error {rel_bf16} > "
            f"2 x {floor}")


# ---------------------------------------------------------------------------
# phases 5-6: the main path, TorchEstimator fit -> checkpoint -> predict on
# NYCTaxiModel and DLRM at bench.py's sizes (bench.py:49-52, 243-253,
# 289-303)

NYC_ROWS, NYC_BLOCKS, NYC_BATCH = 400_000, 8, 8192
NYC_EPOCHS, NYC_STREAM_EPOCHS = 5, 2
NYC_LABEL = "fare_amount"
NYC_COLUMNS = [f"feature_{i}" for i in range(NYCTAXI_FEATURES)]
DLRM_ROWS, DLRM_BLOCKS, DLRM_BATCH, DLRM_EPOCHS, DLRM_STREAM_EPOCHS = (
    120_000, 8, 4096, 4, 2)
# examples/dlrm_criteo.py's schema: label _c0, 13 dense, 26 categorical;
# ids zipf(1.3) % 1000 (+ the ETL's 0 for rare ids) -> 1,001 rows a table
DLRM_DENSE = [f"_c{i}" for i in range(1, 14)]
DLRM_CATS = [f"_c{i}" for i in range(14, 40)]
DLRM_VOCAB = 1001
CPU_STEPS = 20
# card vs CPU, the first CPU_STEPS f32 step losses of one fit (same initial
# weights, same unshuffled batches, TF32 off): each step's GEMMs (K <= 256)
# and 8192-row means sum f32 values in another order, which moves a loss by
# ~sqrt(8192) * 2^-24 = 5e-6 of itself at most; Adam normalises its update,
# so a step adds no more than its own share, and 20 steps stay below
# 20 * 5e-6 = 1e-4
CPU_LOSS_RTOL = 1e-4
# resident vs streaming (same card, same batches in the same order) and a
# retried fit vs an uninterrupted one (the same restored state, the same
# seeded permutations): the same kernels on the same values, so only a
# kernel choice that depends on a pointer's alignment could change a sum;
# 1e-6 of the loss
SAME_PATH_RTOL = 1e-6
# predict (batches of 8192 and a ragged 1,809) vs one forward of all rows:
# f32 GEMMs whose M differs may sum in another order; |diff| <= 1e-5 of
# (|plain| + rms(plain))
PREDICT_RTOL = 1e-5
PREDICT_ROWS = NYC_BATCH + 1809


def nyctaxi_tables(rows: int, blocks: int, seed: int):
    """NYCTaxi-shaped blocks: NYCTAXI_FEATURES float32 features and a fare
    that is a fixed noisy function of them (NYC-like: mean ~11 dollars,
    clipped to [2.5, 249] as examples/generate_nyctaxi.py clips)."""
    import pyarrow as pa

    weights = np.random.RandomState(12345).randn(NYCTAXI_FEATURES)
    weights /= np.linalg.norm(weights)
    rng = np.random.RandomState(seed)
    out = []
    for n in np.diff(np.linspace(0, rows, blocks + 1).astype(int)):
        x = rng.randn(n, NYCTAXI_FEATURES).astype(np.float32)
        fare = (11.0 + 6.0 * (x @ weights) + 2.0 * np.sin(2.0 * x[:, 0])
                + rng.randn(n))
        cols = {c: x[:, i] for i, c in enumerate(NYC_COLUMNS)}
        cols[NYC_LABEL] = np.clip(fare, 2.5, 249.0).astype(np.float32)
        out.append(pa.table(cols))
    return out


def criteo_tables(rows: int, blocks: int, seed: int):
    """Criteo-shaped blocks in examples/dlrm_criteo.py's distribution after
    its pre_process: dense log1p(poisson(8)) with 10 % missing values as 0,
    categorical ids zipf(1.3) % 1000, label Bernoulli(0.25)."""
    import pyarrow as pa

    rng = np.random.RandomState(seed)
    out = []
    for n in np.diff(np.linspace(0, rows, blocks + 1).astype(int)):
        cols = {"_c0": (rng.random_sample(n) < 0.25).astype(np.float32)}
        dense = rng.poisson(8, size=(n, len(DLRM_DENSE))).astype(np.float64)
        dense[rng.random_sample(dense.shape) < 0.1] = 0.0
        dense = np.log1p(dense)
        for i, c in enumerate(DLRM_DENSE):
            cols[c] = dense[:, i]
        for c in DLRM_CATS:
            cols[c] = rng.zipf(1.3, size=n) % 1000
        out.append(pa.table(cols))
    return out


class EpochProfile:
    """Estimator callback that profiles one epoch: ``torch.profiler`` starts
    at the report of epoch ``epoch - 1`` and stops at epoch ``epoch``'s
    (whose loss read has waited for the device), so the window is that
    epoch's train loop and its report. Keep checkpoints out of the window
    (``checkpoint_interval`` = the fit's epochs)."""

    def __init__(self, epoch: int):
        self.epoch = epoch
        self.prof = None
        self.wall_s = 0.0

    def __call__(self, report: dict) -> None:
        from torch.profiler import ProfilerActivity, profile

        if report["epoch"] == self.epoch - 1:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        elif report["epoch"] == self.epoch:
            torch.cuda.synchronize()
            self.wall_s = time.perf_counter() - self.t0
            self.prof.stop()

    def summary(self, label: str, steady_wall_s: float) -> dict:
        """Print the window's wall, the device's busy time (the union of
        its kernel and copy intervals; user annotations such as
        ``Optimizer.step#Adam.step`` span gaps between kernels and are left
        out), the idle share against the window and against
        ``steady_wall_s`` (an unprofiled epoch's wall: the profiler's own
        host work lengthens the window) and the top kernels; return the
        numbers."""
        cuda = torch.autograd.DeviceType.CUDA
        events = [e for e in self.prof.events() if e.device_type == cuda]
        notes = {e.name for e in events if e.is_user_annotation}
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in events if not e.is_user_annotation)
        busy_us, end = 0.0, -math.inf
        for start, stop in spans:
            if stop > end:
                busy_us += stop - max(start, end)
                end = stop
        wall_ms = self.wall_s * 1e3
        if busy_us <= 0:
            print(f"profile {label}: wall {wall_ms:.3f} ms, no device time "
                  "recorded (not measured)")
            return {"wall_ms": wall_ms}
        kernels = [e for e in self.prof.key_averages()
                   if e.device_type == cuda and e.key not in notes]
        total_us = sum(e.self_device_time_total for e in kernels)
        busy_ms = busy_us / 1e3
        out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
               "idle_share": 1.0 - busy_ms / wall_ms,
               "steady_wall_ms": steady_wall_s * 1e3,
               "idle_share_steady": 1.0 - busy_ms / (steady_wall_s * 1e3),
               "kernel_ms": total_us / 1e3,
               "device_ops": sum(e.count for e in kernels)}
        print(f"profile {label}: wall {wall_ms:.3f} ms (unprofiled epoch "
              f"{out['steady_wall_ms']:.3f} ms), device busy {busy_ms:.3f} "
              f"ms, idle {100 * out['idle_share']:.1f} % of the window, "
              f"{100 * out['idle_share_steady']:.1f} % of the unprofiled "
              f"epoch; {out['device_ops']} device operations, "
              f"{out['kernel_ms']:.3f} ms by kernel:")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  {e.self_device_time_total / 1e3:10.3f} ms "
                  f"{100 * e.self_device_time_total / total_us:5.1f}% "
                  f"x{e.count:<5d} {e.key[:90]}")
        return out


def fit_and_report(label: str, make_estimator, dataset, epochs: int,
                   *, cache: bool = True, profile_epoch=None,
                   steady_wall_s=None, max_retries: int = 0):
    """One TorchEstimator fit on the card, the residency gate forced
    (``cache``); prints each epoch's report, the peak device memory and,
    with ``profile_epoch``, that epoch's profile (its idle share also
    against ``steady_wall_s``, an unprofiled epoch's wall). Returns
    (estimator, result, numbers)."""
    import os

    prof = EpochProfile(profile_epoch) if profile_epoch is not None else None
    est = make_estimator([prof] if prof else [])
    old = os.environ.get("RDT_DEVICE_CACHE")
    os.environ["RDT_DEVICE_CACHE"] = "1" if cache else "0"
    try:
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = est.fit(dataset, max_retries=max_retries)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        if old is None:
            del os.environ["RDT_DEVICE_CACHE"]
        else:
            os.environ["RDT_DEVICE_CACHE"] = old
    for r in result.history:
        print(f"{label} epoch {r['epoch']}: " + json.dumps(
            {k: (round(v, 6) if isinstance(v, float) else v)
             for k, v in r.items() if k != "epoch"}))
    losses = [r["train_loss"] for r in result.history]
    # steady state: the epochs after the first (the first builds the
    # resident arrays or fills the decode cache), the profiled one left out
    steady = [r for r in result.history[1:]
              if r["epoch"] != profile_epoch] or result.history
    walls = [r["epoch_time_s"] for r in steady]
    samples = sum(r["samples_per_s"] * r["epoch_time_s"] for r in steady)
    numbers = {"samples_per_s_steady": samples / sum(walls),
               "steady_epochs": [r["epoch"] for r in steady],
               "steady_epoch_s": statistics.median(walls),
               "fit_wall_s": wall, "peak_bytes": peak, "losses": losses}
    print(f"{label}: {numbers['samples_per_s_steady']:.1f} samples/s steady "
          f"(epochs {numbers['steady_epochs']}), fit {wall:.3f} s, peak "
          f"memory {peak / 2 ** 20:.1f} MiB, loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}")
    require(len(losses) == epochs and all(map(math.isfinite, losses)),
            f"{label}: losses {losses}")
    require(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    if prof is not None:
        numbers["profile"] = prof.summary(
            f"{label} epoch {profile_epoch}",
            steady_wall_s or numbers["steady_epoch_s"])
    return est, result, numbers


def nyctaxi_estimator(model, dtype, epochs, *, shuffle=True, callbacks=(),
                      loss="smooth_l1", device=None, **kw):
    """bench.py's NYCTaxi estimator: smooth L1, Adam 1e-3 (the default),
    batch 8192."""
    from raydp_tpu_torch.train import TorchEstimator

    return TorchEstimator(
        model=model, loss=loss, feature_columns=NYC_COLUMNS,
        label_column=NYC_LABEL, batch_size=NYC_BATCH, num_epochs=epochs,
        shuffle=shuffle, compute_dtype=dtype, callbacks=list(callbacks),
        metrics=["mae"], device=device, **kw)


def check_card_against_cpu(model, dataset) -> dict:
    """The first CPU_STEPS step losses of one unshuffled f32 fit, on the
    card and on the CPU, from the same weights and batches. The loss
    callable records each step's loss tensor (no host read in the loop)."""
    from raydp_tpu_torch.data import TableDataset
    from raydp_tpu_torch.train.torch_estimator import _resolve_loss

    first = TableDataset([dataset.to_arrow().slice(0, CPU_STEPS * NYC_BATCH)])
    smooth_l1 = _resolve_loss("smooth_l1")
    losses = {}
    for device in ("cuda", "cpu"):
        record = []

        def loss(preds, labels, mask=None):
            value = smooth_l1(preds, labels, mask=mask)
            record.append(value.detach())
            return value

        nyctaxi_estimator(model, None, 1, shuffle=False, loss=loss,
                          device=device).fit(first)
        losses[device] = [float(v) for v in record]
    card, cpu = losses["cuda"], losses["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    print(f"nyctaxi card vs cpu, {CPU_STEPS} f32 steps: largest relative "
          f"loss difference {rel:.3e} (limit {CPU_LOSS_RTOL}); card "
          f"{card[0]:.6f} -> {card[-1]:.6f}, cpu {cpu[0]:.6f} -> "
          f"{cpu[-1]:.6f}")
    require(len(card) == len(cpu) == CPU_STEPS,
            f"steps: card {len(card)}, cpu {len(cpu)}")
    require(rel <= CPU_LOSS_RTOL, f"card vs cpu losses: {card} vs {cpu}")
    return {"steps": CPU_STEPS, "max_rel_diff": rel}


def check_predict(label: str, est, rows) -> float:
    """``est.predict(rows)`` on a ragged row count vs one plain forward of
    ``get_model()`` over all of them; returns the share of the limit
    used."""
    got = est.predict(rows)
    table = rows.to_arrow()
    x = torch.tensor(np.stack([table[c].to_numpy() for c in NYC_COLUMNS], 1),
                     device=est.device)
    with torch.no_grad():
        plain = est.get_model()(x)[:, 0].cpu().numpy()
    limit = PREDICT_RTOL * (np.abs(plain) + np.sqrt(np.mean(plain ** 2)))
    used = float(np.max(np.abs(got - plain) / limit))
    print(f"{label} predict: {got.shape[0]} rows in batches of {NYC_BATCH}, "
          f"max |predict - forward| {np.max(np.abs(got - plain)):.3e}, "
          f"{used:.3f} of the limit")
    require(got.shape == plain.shape == (PREDICT_ROWS,),
            f"{label} predict shape {got.shape}")
    require(bool(np.isfinite(got).all()) and used <= 1.0,
            f"{label} predict differs from a plain forward")
    return used


def check_checkpoints(label: str, ckpt_dir: str) -> list:
    """The dir holds complete step dirs in the reference's layout, at most
    _KEEP of them."""
    import os

    from raydp_tpu_torch.train import checkpoint as ckpt

    steps = sorted(os.listdir(ckpt_dir))
    print(f"{label} checkpoints: {steps}")
    require(0 < len(steps) <= ckpt._KEEP, f"{label}: step dirs {steps}")
    for step in steps:
        files = sorted(os.listdir(os.path.join(ckpt_dir, step)))
        require(files == ["COMPLETE", "extra.json", "manifest_0.json",
                          "shard_0.npz"], f"{label} {step}: {files}")
    return steps


def run_nyctaxi(fa, tmp: str):
    """Phase 5: NYCTaxiModel at bench.py's size through TorchEstimator.
    Returns the numbers and a function that profiles one steady bf16
    resident epoch (called after every timed fit of phases 5-6)."""
    import os

    from raydp_tpu_torch.data import TableDataset
    from raydp_tpu_torch.models import NYCTaxiModel

    dataset = TableDataset(nyctaxi_tables(NYC_ROWS, NYC_BLOCKS, SEED))
    # one set of initial weights, built on the CPU; every fit copies it
    model = NYCTaxiModel(NYCTAXI_FEATURES, device="cpu",
                         generator=torch.Generator().manual_seed(SEED))
    model16 = NYCTaxiModel(NYCTAXI_FEATURES, dtype=torch.bfloat16,
                           device="cpu")
    model16.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"nyctaxi: {n_params} params, {NYC_ROWS} rows in {NYC_BLOCKS} "
          f"blocks, {NYCTAXI_FEATURES} features, batch {NYC_BATCH}")
    out = {"params": n_params}
    ckpt_a = os.path.join(tmp, "nyctaxi_f32")
    zero_launches(fa)
    est, clean, out["f32_resident"] = fit_and_report(
        "nyctaxi f32 resident", lambda cb: nyctaxi_estimator(
            model, None, NYC_EPOCHS, callbacks=cb, checkpoint_dir=ckpt_a),
        dataset, NYC_EPOCHS)
    def bf16_resident(epochs):
        return lambda cb: nyctaxi_estimator(
            model16, torch.bfloat16, epochs, callbacks=cb,
            checkpoint_interval=epochs)

    _, _, out["bf16_resident"] = fit_and_report(
        "nyctaxi bf16 resident", bf16_resident(NYC_EPOCHS), dataset,
        NYC_EPOCHS)
    for dtype, m in ((None, model), (torch.bfloat16, model16)):
        name = "f32" if dtype is None else "bf16"
        _, _, out[f"{name}_streaming"] = fit_and_report(
            f"nyctaxi {name} streaming", lambda cb: nyctaxi_estimator(
                m, dtype, NYC_STREAM_EPOCHS, callbacks=cb,
                checkpoint_interval=NYC_STREAM_EPOCHS),
            dataset, NYC_STREAM_EPOCHS, cache=False)
    counts = launches(fa)
    print(f"nyctaxi launches of the flash kernels: {counts}")
    require(not any(counts.values()), f"nyctaxi launched {counts}")
    check_checkpoints("nyctaxi f32 resident", ckpt_a)

    # retry: a callback raises once at epoch 2, before epoch 2's checkpoint
    raised = []

    def fail_once(report):
        if report["epoch"] == 2 and not raised:
            raised.append(report["train_loss"])
            raise RuntimeError("injected failure at epoch 2")

    ckpt_b = os.path.join(tmp, "nyctaxi_retry")
    _, retried, _ = fit_and_report(
        "nyctaxi f32 retried", lambda cb: nyctaxi_estimator(
            model, None, NYC_EPOCHS, callbacks=[fail_once, *cb],
            checkpoint_dir=ckpt_b),
        dataset, NYC_EPOCHS, max_retries=1)
    check_checkpoints("nyctaxi f32 retried", ckpt_b)
    a = [r["train_loss"] for r in clean.history]
    b = [r["train_loss"] for r in retried.history]
    print(f"nyctaxi retry: failed epoch 2 at loss {raised}, replayed from "
          f"step_1: epoch 2 {b[2]:.6f} (uninterrupted {a[2]:.6f}, epoch 3 "
          f"{a[3]:.6f}), final {b[-1]:.6f} (uninterrupted {a[-1]:.6f})")
    require(len(raised) == 1 and len(b) == len(a) == NYC_EPOCHS,
            f"retry history {b}")
    for i in (2, len(a) - 1):
        require(abs(b[i] - a[i]) <= SAME_PATH_RTOL * abs(a[i]),
                f"retried epoch {i} loss {b[i]} vs uninterrupted {a[i]}")
    require(abs(a[3] - a[2]) > 10 * SAME_PATH_RTOL * abs(a[2]),
            "epochs 2 and 3 too close to tell a restore from none")

    # resident == streaming, unshuffled, epoch 0
    first = {}
    for cache in (True, False):
        os.environ["RDT_DEVICE_CACHE"] = "1" if cache else "0"
        try:
            first[cache] = nyctaxi_estimator(
                model, None, 1, shuffle=False).fit(dataset).history[0][
                    "train_loss"]
        finally:
            del os.environ["RDT_DEVICE_CACHE"]
    print(f"nyctaxi unshuffled epoch 0: resident {first[True]:.9f}, "
          f"streaming {first[False]:.9f}")
    require(abs(first[True] - first[False])
            <= SAME_PATH_RTOL * abs(first[False]),
            f"resident {first[True]} vs streaming {first[False]}")

    out["card_vs_cpu"] = check_card_against_cpu(model, dataset)
    check_predict("nyctaxi", est, TableDataset(
        nyctaxi_tables(PREDICT_ROWS, 3, SEED + 2)))

    def profile():
        return fit_and_report(
            "nyctaxi bf16 resident profiled", bf16_resident(2), dataset, 2,
            profile_epoch=1,
            steady_wall_s=out["bf16_resident"]["steady_epoch_s"])[2][
                "profile"]

    return out, profile


def dlrm_model():
    """bench.py's DLRM widths, bf16, seeded weights built on the CPU."""
    from raydp_tpu_torch.models import DLRM

    return DLRM([DLRM_VOCAB] * len(DLRM_CATS), num_dense=len(DLRM_DENSE),
                embedding_dim=32, bottom_mlp=(512, 128, 32),
                top_mlp=(1024, 1024, 512, 256, 1), dtype=torch.bfloat16,
                device="cpu", generator=torch.Generator().manual_seed(SEED))


def dlrm_estimator(model, epochs, callbacks, shuffle=True):
    """bench.py's DLRM estimator: BCE with logits, the optax.adagrad(1e-2)
    mapping, bf16 compute, batch 4096."""
    from raydp_tpu_torch.models import criteo_batch_preprocessor
    from raydp_tpu_torch.train import TorchEstimator

    return TorchEstimator(
        model=model, optimizer=lambda p: torch.optim.Adagrad(
            p, lr=1e-2, initial_accumulator_value=0.1, eps=0.0),
        loss="bce_with_logits", feature_columns=DLRM_DENSE + DLRM_CATS,
        label_column="_c0", feature_dtype=np.float64,
        batch_size=DLRM_BATCH, num_epochs=epochs, shuffle=shuffle,
        batch_preprocessor=criteo_batch_preprocessor(len(DLRM_DENSE)),
        compute_dtype=torch.bfloat16, metrics=["accuracy"],
        callbacks=list(callbacks), checkpoint_interval=epochs)


def run_dlrm(fa):
    """Phase 6: DLRM at bench.py's widths through TorchEstimator, bf16
    compute, the optax.adagrad(1e-2) mapping. Returns the numbers and a
    function that profiles one steady resident epoch."""
    from raydp_tpu_torch.data import TableDataset

    dataset = TableDataset(criteo_tables(DLRM_ROWS, DLRM_BLOCKS, SEED))
    model = dlrm_model()
    n_params = sum(p.numel() for p in model.parameters())
    n_tables = DLRM_VOCAB * 32 * len(DLRM_CATS)
    print(f"dlrm: {n_params} params ({n_params - n_tables} dense, {n_tables} "
          f"in {len(DLRM_CATS)} tables), {DLRM_ROWS} rows in {DLRM_BLOCKS} "
          f"blocks, batch {DLRM_BATCH}")

    def make(epochs):
        return lambda cb: dlrm_estimator(model, epochs, cb)

    out = {"params": n_params}
    zero_launches(fa)
    _, _, out["bf16_resident"] = fit_and_report(
        "dlrm bf16 resident", make(DLRM_EPOCHS), dataset, DLRM_EPOCHS)
    _, _, out["bf16_streaming"] = fit_and_report(
        "dlrm bf16 streaming", make(DLRM_STREAM_EPOCHS), dataset,
        DLRM_STREAM_EPOCHS, cache=False)
    counts = launches(fa)
    require(not any(counts.values()), f"dlrm launched {counts}")

    def profile():
        return fit_and_report(
            "dlrm bf16 resident profiled", make(2), dataset, 2,
            profile_epoch=1,
            steady_wall_s=out["bf16_resident"]["steady_epoch_s"])[2][
                "profile"]

    return out, profile


# ---------------------------------------------------------------------------
# phase 7: the main path fed from the object store. The port's runtime (head
# and two actors) writes the phases' blocks into the shared-memory arena with
# put_arrow_many, and TorchEstimator reads store-backed DistributedDatasets
# (get_block(zero_copy=True)), in turns with TableDatasets of the same tables

# the phase's blocks (~42 MB NYCTaxi, ~38 MB DLRM, ~1 MB to predict) fit
# with room to spare; the arena is required, never the per-object fallback
STORE_ARENA_BYTES = 1 << 30
STORE_ACTORS, STORE_EPOCHS = 2, 2
# the same store, the same tables: fits from either dataset see the same
# batches, so their losses agree as resident and streaming do
STORE_LOSS_RTOL = SAME_PATH_RTOL
FEED_KEYS = ("decode_time_s", "stage_time_s", "h2d_time_s", "feed_time_s")


class StoreWriter:
    """An actor of the phase: makes the seeded blocks and writes some of
    them into the store, timing the write alone; or allocates on the card.
    Its methods import torch themselves: cloudpickle ships the class by
    value, and a module global of a method would be imported at spawn."""

    def write(self, kind: str, rows: int, blocks: int, seed: int,
              indices: list) -> dict:
        import pyarrow as pa

        from raydp_tpu_torch.runtime.object_store import get_client

        make = nyctaxi_tables if kind == "nyctaxi" else criteo_tables
        tables = make(rows, blocks, seed)
        tables = [tables[i] for i in indices]
        client = get_client()
        client.free([client.put_arrow(tables[0].slice(0, 1000))])  # warm-up
        t0 = time.perf_counter()
        refs = client.put_arrow_many(tables)
        put_s = time.perf_counter() - t0
        # the driver owns the blocks: they outlive this actor
        client.transfer_ownership(refs, "__driver__")
        # what the write is made of: the IPC serialisation alone, and one
        # copy of the serialised bytes into fresh (never touched) memory
        t0 = time.perf_counter()
        bufs = []
        for table in tables:
            sink = pa.BufferOutputStream()
            with pa.ipc.new_stream(sink, table.schema) as writer:
                writer.write_table(table)
            bufs.append(sink.getvalue())
        serialize_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for buf in bufs:
            np.copyto(np.empty(buf.size, np.uint8),
                      np.frombuffer(buf, np.uint8))
        fresh_copy_s = time.perf_counter() - t0
        return {"refs": refs, "rows": [t.num_rows for t in tables],
                "bytes": sum(t.nbytes for t in tables),
                "ipc_bytes": sum(b.size for b in bufs), "put_s": put_s,
                "serialize_s": serialize_s, "fresh_copy_s": fresh_copy_s}

    def cuda_sum(self, n: int) -> dict:
        import os

        import torch

        before = torch.cuda.is_initialized()
        total = float(torch.arange(n, device="cuda",
                                   dtype=torch.float64).sum())
        return {"cuda_initialized_before": before, "sum": total,
                "warm_forked": os.environ.get("RDT_WARM_FORKED"),
                "device": torch.cuda.get_device_name(0)}


def write_through_actors(rt, actors, kind, rows, blocks, seed):
    """The actors write ``blocks`` seeded blocks between them, concurrently;
    returns the store-backed dataset (blocks in order) and the numbers."""
    from raydp_tpu_torch.data import BlockMeta, DistributedDataset

    shares = [list(range(blocks))[a::len(actors)] for a in range(len(actors))]
    t0 = time.perf_counter()
    futs = [h.submit("write", kind, rows, blocks, seed, idx)
            for h, idx in zip(actors, shares)]
    results = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    metas = {}
    for idx, res in zip(shares, results):
        for i, ref, n in zip(idx, res["refs"], res["rows"]):
            metas[i] = BlockMeta(num_rows=n, ref=ref)
    schema = rt.store_client.get(metas[0].ref, zero_copy=True).schema
    ds = DistributedDataset([metas[i] for i in range(blocks)], schema)
    mb = sum(r["bytes"] for r in results) / 1e6
    put_s = max(r["put_s"] for r in results)
    info = rt.store_server.arena_info()
    for i in range(blocks):
        seg, _, _, offset, _, _ = rt.store_server.lookup(
            ds.get_block_ref(i).id)
        require(seg == info["segment"] and offset >= 0,
                f"{kind} block {i} is not in the arena ({seg}, {offset})")
    numbers = {"mb": mb, "put_s": put_s, "put_mb_per_s": mb / put_s,
               "per_actor_mb_per_s": [r["bytes"] / 1e6 / r["put_s"]
                                      for r in results],
               "ipc_mb": sum(r["ipc_bytes"] for r in results) / 1e6,
               "per_actor": [{k: r[k] for k in ("put_s", "serialize_s",
                                                "fresh_copy_s")}
                             for r in results],
               "call_wall_s": wall}
    print(f"store {kind}: {blocks} blocks, {sum(ds.block_sizes())} rows, "
          f"{mb:.3f} MB written by {len(actors)} actors in {put_s:.4f} s "
          f"({numbers['put_mb_per_s']:.1f} MB/s; per actor "
          f"{[round(x, 1) for x in numbers['per_actor_mb_per_s']]}; "
          f"put / IPC serialisation alone / a copy into fresh memory "
          f"{[[round(v, 4) for v in a.values()] for a in numbers['per_actor']]}"
          f" s), call wall {wall:.3f} s with the blocks' generation")
    return ds, numbers


def fits_in_turns(label: str, make_estimator, datasets: dict,
                  cache: bool = False):
    """Fits (streaming, or resident with ``cache``) from the store-backed
    and the in-process dataset in turns (store, table, table, store, store,
    table); every fit's per-epoch losses must agree with the first's within
    STORE_LOSS_RTOL. Returns each side's numbers and the last estimator."""
    runs = []
    for side in ("store", "table", "table", "store", "store", "table"):
        est, result, numbers = fit_and_report(
            f"{label} from {side}", make_estimator, datasets[side],
            STORE_EPOCHS, cache=cache)
        runs.append((side, result.history, numbers))
    first = [r["train_loss"] for r in runs[0][1]]
    out = {}
    for side, history, numbers in runs:
        losses = [r["train_loss"] for r in history]
        for a, b in zip(losses, first):
            require(abs(a - b) <= STORE_LOSS_RTOL * abs(b),
                    f"{label}: {side} losses {losses} vs store {first}")
        entry = out.setdefault(side, {"samples_per_s_steady": [],
                                      "epoch0_s": [],
                                      **{k: [] for k in FEED_KEYS}})
        entry["samples_per_s_steady"].append(numbers["samples_per_s_steady"])
        entry["epoch0_s"].append(history[0]["epoch_time_s"])
        for k in FEED_KEYS:
            entry[k].append([r[k] for r in history])
    for side in ("store", "table"):
        e = out[side]
        split = ", ".join(
            f"{k[:-7]} {statistics.mean(v for run in e[k] for v in run):.6f}"
            for k in FEED_KEYS)
        print(f"{label}: {side} "
              f"{[round(v, 1) for v in e['samples_per_s_steady']]} samples/s"
              f" steady, epoch 0 {[round(v, 6) for v in e['epoch0_s']]} s; "
              f"mean per epoch {split} s")
    print(f"{label}: store and table losses agree within "
          f"{STORE_LOSS_RTOL} ({first})")
    return out, est


def attribute_put(rt, tables) -> dict:
    """The driver's own ``put_arrow_many`` of ``tables``, first into arena
    space never touched, then, freed and reclaimed at once, into the same
    space again: the difference is the first touch of the shared pages."""
    client = rt.store_client
    mb = sum(t.nbytes for t in tables) / 1e6
    out = {}
    for name in ("fresh", "reused"):
        t0 = time.perf_counter()
        refs = client.put_arrow_many(tables)
        out[f"{name}_mb_per_s"] = mb / (time.perf_counter() - t0)
        client.free(refs)
        rt.store_server.host._reap_deferred(everything=True)
    print(f"store: the driver's put of {mb:.3f} MB into fresh arena pages "
          f"{out['fresh_mb_per_s']:.1f} MB/s, into the same pages again "
          f"{out['reused_mb_per_s']:.1f} MB/s")
    return out


def check_split_shards(ds) -> list:
    """``split_shards(2)`` of the NYCTaxi dataset: equal rank sizes, and
    every row of every block in exactly one rank."""
    plans = ds.split_shards(2)
    seen = [np.zeros(n, np.int64) for n in ds.block_sizes()]
    for plan in plans:
        for block, off, n in plan:
            seen[block][off:off + n] += 1
    sizes = [sum(n for _, _, n in plan) for plan in plans]
    print(f"store split_shards(2): rank rows {sizes}, every row once: "
          f"{all((s == 1).all() for s in seen)}")
    require(all((s == 1).all() for s in seen) and len(set(sizes)) == 1,
            f"split_shards(2) plans {plans}")
    return sizes


def run_store(fa, card: str) -> dict:
    """Phase 7: the port's runtime and object store under the main path."""
    import os

    from raydp_tpu_torch import config as cfg
    from raydp_tpu_torch.data import TableDataset
    from raydp_tpu_torch.models import NYCTaxiModel
    from raydp_tpu_torch.runtime import init_runtime, shutdown_runtime

    st = os.statvfs("/dev/shm")
    out = {"card": card, "shm_bytes": st.f_blocks * st.f_frsize,
           "shm_free_bytes": st.f_bavail * st.f_frsize,
           "arena_bytes": STORE_ARENA_BYTES}
    print(f"store: {card}; /dev/shm {out['shm_bytes']} bytes "
          f"({out['shm_free_bytes']} free), arena {STORE_ARENA_BYTES} bytes")
    require(out["shm_free_bytes"] >= STORE_ARENA_BYTES,
            "/dev/shm has no room for the store's arena")
    # what a cold actor spawn is made of: an interpreter, the imports of
    # the actor's bootstrap; torch for comparison (the warm prototype's)
    out["interpreter_s"] = {}
    for name, code in (("bare", "pass"),
                       ("actor_imports",
                        "import raydp_tpu_torch.runtime.actor_main"),
                       ("torch", "import torch")):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
        out["interpreter_s"][name] = time.perf_counter() - t0
    print(f"store: a fresh interpreter that imports nothing / the actor's "
          f"bootstrap / torch: {out['interpreter_s']} s")
    zero_launches(fa)
    t0 = time.perf_counter()
    rt = init_runtime(cfg.Config({
        cfg.OBJECT_STORE_MEMORY_KEY: str(STORE_ARENA_BYTES),
        cfg.NATIVE_OBJECT_STORE_KEY: "on"}))
    out["init_runtime_s"] = time.perf_counter() - t0
    prefix = f"rdt{rt.session_id[:8]}"
    try:
        info = rt.store_server.arena_info()
        print(f"store: init_runtime {out['init_runtime_s']:.4f} s, arena "
              f"{info}")
        require(info is not None and info["size"] == STORE_ARENA_BYTES,
                f"the store's arena is not in use: {info}")
        actors, out["cold_spawn_s"] = [], []
        for i in range(STORE_ACTORS):
            t0 = time.perf_counter()
            actors.append(rt.create_actor(StoreWriter, name=f"writer-{i}"))
            out["cold_spawn_s"].append(time.perf_counter() - t0)
        print(f"store: cold actor spawns {out['cold_spawn_s']} s")

        nyc_store, out["nyctaxi_put"] = write_through_actors(
            rt, actors, "nyctaxi", NYC_ROWS, NYC_BLOCKS, SEED)
        nyc_table = TableDataset(nyctaxi_tables(NYC_ROWS, NYC_BLOCKS, SEED))
        require(nyc_store.to_arrow().equals(nyc_table.to_arrow()),
                "the store's NYCTaxi rows differ from the source tables")
        dlrm_store, out["dlrm_put"] = write_through_actors(
            rt, actors, "dlrm", DLRM_ROWS, DLRM_BLOCKS, SEED)
        dlrm_table = TableDataset(criteo_tables(DLRM_ROWS, DLRM_BLOCKS, SEED))
        require(dlrm_store.to_arrow().equals(dlrm_table.to_arrow()),
                "the store's DLRM rows differ from the source tables")
        stats = rt.store_server.stats()
        out["spilled_objects"] = stats["spilled_objects"]
        print(f"store: {stats['num_objects']} objects, "
              f"{stats['spilled_objects']} spilled, arena "
              f"{rt.store_server.arena_stats()}")
        require(stats["spilled_objects"] == 0, f"the store spilled: {stats}")

        model = NYCTaxiModel(NYCTAXI_FEATURES, device="cpu",
                             generator=torch.Generator().manual_seed(SEED))
        nyc = {"store": nyc_store, "table": nyc_table}

        def nyc_estimator(cb):
            return nyctaxi_estimator(
                model, None, STORE_EPOCHS, shuffle=False, callbacks=cb,
                checkpoint_interval=STORE_EPOCHS)

        out["nyctaxi_f32_streaming"], _ = fits_in_turns(
            "store nyctaxi f32 streaming", nyc_estimator, nyc)
        out["nyctaxi_f32_resident"], est = fits_in_turns(
            "store nyctaxi f32 resident", nyc_estimator, nyc, cache=True)
        dmodel = dlrm_model()
        out["dlrm_bf16_streaming"], _ = fits_in_turns(
            "store dlrm bf16 streaming", lambda cb: dlrm_estimator(
                dmodel, STORE_EPOCHS, cb, shuffle=False),
            {"store": dlrm_store, "table": dlrm_table})
        counts = launches(fa)
        require(not any(counts.values()), f"store phase launched {counts}")

        rows, _ = write_through_actors(rt, actors[:1], "nyctaxi",
                                       PREDICT_ROWS, 3, SEED + 2)
        out["predict_limit_used"] = check_predict("store nyctaxi", est, rows)
        out["split_shards_rows"] = check_split_shards(nyc_store)
        out["driver_put"] = attribute_put(rt, nyc_table.blocks()[::2])

        # a warm-forked actor on the card: the first warm spawn starts the
        # prototype (a cold interpreter importing torch), the second forks
        os.environ["RDT_WARM_FORK"] = "1"
        try:
            t0 = time.perf_counter()
            rt.create_actor(StoreWriter, name="warm-0")
            out["prototype_spawn_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            warm = rt.create_actor(StoreWriter, name="warm-1")
            out["warm_spawn_s"] = time.perf_counter() - t0
        finally:
            del os.environ["RDT_WARM_FORK"]
        n = 1 << 20
        got = warm.cuda_sum(n)
        print(f"store: warm-forked spawn {out['warm_spawn_s']:.4f} s (the "
              f"first, starting the prototype, {out['prototype_spawn_s']:.4f}"
              f" s); on the card: {got}")
        require(got["warm_forked"] == "1", f"not warm-forked: {got}")
        require(got["cuda_initialized_before"] is False
                and got["sum"] == n * (n - 1) / 2, f"warm fork on CUDA: {got}")
    finally:
        shutdown_runtime()
    left = [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]
    print(f"store: after shutdown_runtime, segments of the session left: "
          f"{left}")
    require(not left, f"segments left after shutdown: {left}")
    print("store phase " + json.dumps(out))
    return out


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--baseline", metavar="DIR",
        help="another checkout (e.g. the parent commit unpacked with git "
             "archive) whose three kernels are built and timed against "
             "this checkout's at the flagship shape, in turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 1
    from raydp_tpu_torch import resolve_device
    from raydp_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    device = resolve_device()

    baseline = build_kernels(fa, args.baseline)
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = {"flash_attention_fwd": check_kernel(fa, device, gen, baseline),
            **check_bwd_kernels(fa, device, gen, baseline)}
    # phases 5-7 are bound by the host's kernel launches: their timed fits
    # run before any torch.profiler session of this process (phases 3-4
    # profile, and so do 5-6 at their end), so no profiler hook is left in
    # the launch path while they are timed
    tmp = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        free_memory()
        nyctaxi, profile_nyctaxi = run_nyctaxi(fa, tmp)
        free_memory()
        dlrm, profile_dlrm = run_dlrm(fa)
        free_memory()
        store = run_store(fa, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    nyctaxi["profile"] = profile_nyctaxi()
    dlrm["profile"] = profile_dlrm()
    print("main path " + json.dumps({"nyctaxi": nyctaxi, "dlrm": dlrm,
                                     "store": store}))
    free_memory()
    lm = run_lm(fa, device)
    free_memory()
    train = run_train(fa, device)
    free_memory()
    check_grads(device)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": train["launches"][name],
            **{k: rows[name][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "tflops", "bound_share", "baseline_ms",
                "speedup") if k in rows[name]}})
    kernels[0]["launches_inference"] = lm["launches"]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
