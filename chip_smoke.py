#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (raydp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--baseline DIR]

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   port's CUDA kernels from ``raydp_tpu_torch/csrc`` for sm_90a, one
   ``nvcc`` per source, all started together;
2. holds each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it (plus ragged and small shapes covering
   every compiled head dim), checks that two backward calls agree bitwise,
   and times the kernel, the plain version and, as a yardstick the port
   never calls, PyTorch's ``scaled_dot_product_attention`` (its backward for
   the two backward kernels); with ``--baseline DIR`` it also builds DIR's
   backward kernels and times them against this checkout's in turns;
3. full-width TransformerLM inference (dim 1024, 8 heads, 8 layers, vocab
   32768, bf16 activations, f32 params from a seeded generator) on three
   batches of B=2, T=8192 tokens through ``attention="flash"``; checks
   logits, ``lm_loss`` and ``lm_loss_fused``, and the flash model's logits
   against ``attention="dense"`` on a T=2048 batch;
4. the main path: full-width training of the same model with Adam(1e-3) on
   one repeated B=2, T=8192 batch, 4 steps on ``lm_loss`` and 2 on
   ``lm_loss_fused(remat=True)`` from the same initial weights; checks the
   losses, the launches of all three kernels and that remat lowers the peak
   memory;
5. the full model's parameter gradients through flash vs dense attention at
   T=2048 (f32 and bf16);
6. prints one JSON line of kernel results, then the last line
   ``{"ok": true, "device": {...}}``.

Every kernel launch counter is set to 0 just before each driven path (3 and
both modes of 4) and read just after. Any failed check exits non-zero; so
does a machine without CUDA.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
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
# out is held elementwise: |out - plain| <= atol + rtol * |plain|. Both sides
# compute the same f32 value in another summation order (a difference of
# ~1e-6) and bf16 rounds it: two neighbouring bf16 values are at most 2^-7 of
# the smaller apart, so bf16 allows one rounding step and 1e-5 for the f32
# sums. Typical |out| at T = 8192 is ~0.02, so an absolute bf16 limit would be
# as large as the values. f32 out: f32 sums in another order. lse: O(10)
# magnitude in f32.
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


def build_kernels(fa) -> None:
    """Phase 1: one nvcc per source, all started together; print each log."""
    from raydp_tpu_torch.ops import _build

    def timed(name):
        t0 = time.perf_counter()
        return _build.build(name), time.perf_counter() - t0

    names = ("flash_attention_fwd", "flash_attention_bwd")
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(timed, names))
    for lib, seconds in built:
        print(f"built {lib.name} in {seconds:.1f} s")
        print(lib.with_suffix(".log").read_text().strip())
        print_mma_counts(lib)
    fa._fwd_entry()
    fa._bwd_entries()


def print_mma_counts(lib) -> None:
    """Tensor-core instructions in each kernel of a built library, from
    ``cuobjdump -sass`` (beside ``nvcc``; skipped where the toolkit lacks
    it): HGMMA is Hopper's warpgroup product, HMMA the warp-level one."""
    import re
    from pathlib import Path

    from raydp_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not tool.is_file():
        print(f"sass {lib.name}: no cuobjdump beside nvcc (not measured)")
        return
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for section in sass.split("Function : ")[1:]:
        mangled = section.split(None, 1)[0]
        m = re.search(r"\d+([A-Za-z_]+_kernel)I(f|13__nv_bfloat16)?Li(\d+)E",
                      mangled)
        label = mangled
        if m:
            dtype = {"f": "float, ", "13__nv_bfloat16": "bf16, "}.get(m[2], "")
            label = f"{m[1]}<{dtype}{m[3]}>"
        hgmma = len(re.findall(r"\bHGMMA", section))
        hmma = len(re.findall(r"\bHMMA", section))
        print(f"sass {label}: {hgmma} HGMMA, {hmma} HMMA")


def zero_launches(fa) -> None:
    fa.FWD_LAUNCHES = fa.DKDV_LAUNCHES = fa.DQ_LAUNCHES = 0


def launches(fa) -> dict:
    return {"flash_attention_fwd": fa.FWD_LAUNCHES,
            "flash_attention_bwd_dkdv": fa.DKDV_LAUNCHES,
            "flash_attention_bwd_dq": fa.DQ_LAUNCHES}


def check_kernel(fa, device, gen) -> dict:
    """Phase 2: flash forward kernel vs its plain version at each shape."""
    import torch.nn.functional as F

    main = None
    for b, t, h, d, dtype, causal in KERNEL_SHAPES:
        q3, k3, v3 = [torch.randn(b * h, t, d, generator=gen, device=device)
                      .to(dtype) for _ in range(3)]
        scale = 1.0 / math.sqrt(d)
        out, lse = fa._fwd_cuda(q3, k3, v3, scale, causal)
        ref_out, ref_lse = fa._fwd_plain(q3, k3, v3, scale, causal)
        torch.cuda.synchronize()
        diff = (out.float() - ref_out.float()).abs()
        atol, rtol = OUT_TOL[dtype]
        err_out = diff.max().item()
        # the largest share of its limit that any element uses (<= 1 passes)
        tol_used = (diff / (atol + rtol * ref_out.float().abs())).max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        ms = time_ms(lambda: fa._fwd_cuda(q3, k3, v3, scale, causal))
        plain_ms = time_ms(lambda: fa._fwd_plain(q3, k3, v3, scale, causal),
                           reps=5)
        q4, k4, v4 = (x.view(b, h, t, d) for x in (q3, k3, v3))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale))
        bound = attention_bound("flash_attention_fwd", b * h, t, d, dtype,
                                causal)
        row = {"shape": [b, t, h, d], "dtype": str(dtype).split(".")[-1],
               "causal": causal, "max_abs_err": err_out,
               "out_tol": [atol, rtol], "out_tol_used": tol_used,
               "lse_max_abs_err": err_lse, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, **rates(bound, ms)}
        print("kernel flash_attention_fwd " + json.dumps(row))
        require(bool(torch.isfinite(out.float()).all()), f"non-finite out {row}")
        require(tol_used <= 1.0, f"out differs from plain: {row}")
        require(err_lse <= LSE_ATOL, f"lse differs from plain: {row}")
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


def build_baseline(fa, root: str) -> dict:
    """The entries of the backward library built from ``root``'s
    ``raydp_tpu_torch/csrc/flash_attention_bwd.cu`` (whose C signatures are
    this checkout's) with this checkout's flags, into this checkout's
    git-ignored build directory."""
    import ctypes
    from pathlib import Path

    from raydp_tpu_torch.ops import _build

    src = Path(root) / "raydp_tpu_torch" / "csrc" / "flash_attention_bwd.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _build.BUILD_DIR / "baseline_flash_attention_bwd.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    str(lib_path), str(src)], check=True, capture_output=True)
    print(f"built baseline backward from {src}")
    return fa._bwd_bind(ctypes.CDLL(str(lib_path)))


def compare_baseline(fa, baseline, calls, inputs, scale, causal) -> dict:
    """Each kernel and the baseline's at the same inputs, timed in turns
    (baseline, this, this, baseline); the baseline's launches are not
    counted. Returns {name: {"baseline_ms", "ab_ms", "speedup",
    "ab_turns_ms"}}."""
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

        turns = [time_ms(fn) for fn in (theirs, ours, ours, theirs)]
        base = statistics.mean(turns[0::3])
        this = statistics.mean(turns[1:3])
        result[name] = {"baseline_ms": base, "ab_ms": this,
                        "speedup": base / this, "ab_turns_ms": turns}
        print(f"ab {name}: baseline {turns[0]:.3f}, this {turns[1]:.3f}, "
              f"this {turns[2]:.3f}, baseline {turns[3]:.3f} ms; speedup "
              f"{base / this:.2f}x")
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


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--baseline", metavar="DIR",
        help="another checkout (e.g. the parent commit unpacked with git "
             "archive) whose backward kernels are built and timed against "
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

    build_kernels(fa)
    baseline = build_baseline(fa, args.baseline) if args.baseline else None
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = {"flash_attention_fwd": check_kernel(fa, device, gen),
            **check_bwd_kernels(fa, device, gen, baseline)}
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
