#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (raydp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   port's CUDA kernels from ``raydp_tpu_torch/csrc`` for sm_90a;
2. holds each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it (plus a ragged and a small shape), and times
   the kernel, the plain version and, as a yardstick the port never calls,
   PyTorch's ``scaled_dot_product_attention``;
3. drives the main path: full-width TransformerLM inference (dim 1024,
   8 heads, 8 layers, vocab 32768, bf16 activations, f32 params from a
   seeded generator) on three batches of B=2, T=8192 tokens through
   ``attention="flash"``, with the kernel launch counters set to 0 just
   before and read just after; checks logits, ``lm_loss`` and
   ``lm_loss_fused``, and the flash model's logits against
   ``attention="dense"`` on a T=2048 batch;
4. prints one JSON line of kernel results, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# NVIDIA H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# kernel checks: (B, T, H, D, dtype, causal); the first is the main path's
KERNEL_SHAPES = [(2, 8192, 8, 128, torch.bfloat16, True),
                 (2, 1000, 4, 64, torch.float32, False),
                 (1, 512, 2, 32, torch.float32, True),
                 (2, 300, 2, 16, torch.bfloat16, True)]
# out is held elementwise: |out - plain| <= atol + rtol * |plain|. Both sides
# compute the same f32 value in another summation order (a difference of
# ~1e-6) and bf16 rounds it: two neighbouring bf16 values are at most 2^-7 of
# the smaller apart, so bf16 allows one rounding step and 1e-5 for the f32
# sums. Typical |out| at T = 8192 is ~0.02, so an absolute bf16 limit would be
# as large as the values. f32 out: f32 sums in another order. lse: O(10)
# magnitude in f32.
OUT_TOL = {torch.bfloat16: (1e-5, 2.0 ** -7), torch.float32: (1e-4, 0.0)}
LSE_ATOL = 1e-3

VOCAB, DIM, HEADS, LAYERS = 32768, 1024, 8, 8
BATCH, SEQ, BATCHES, SEED = 2, 8192, 3, 0
DENSE_SEQ = 2048
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


def attention_bound(bh: int, t: int, d: int, dtype: torch.dtype,
                    causal: bool) -> tuple[float, str]:
    """Least time (ms) for one forward: q/k/v read and out/lse written once;
    QKᵀ and PV over the (q, k) pairs this run's mask keeps."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4.0 * bh * d * pairs
    nbytes = 4 * bh * t * d * torch.finfo(dtype).bits // 8 + bh * t * 4
    op_ms = flops / PEAK_FLOPS[dtype] * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


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
        bound_ms, bound_by = attention_bound(b * h, t, d, dtype, causal)
        row = {"shape": [b, t, h, d], "dtype": str(dtype).split(".")[-1],
               "causal": causal, "max_abs_err": err_out,
               "out_tol": [atol, rtol], "out_tol_used": tol_used,
               "lse_max_abs_err": err_lse, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        print("kernel flash_attention_fwd " + json.dumps(row))
        require(bool(torch.isfinite(out.float()).all()), f"non-finite out {row}")
        require(tol_used <= 1.0, f"out differs from plain: {row}")
        require(err_lse <= LSE_ATOL, f"lse differs from plain: {row}")
        main = main or row
        del q3, k3, v3, q4, k4, v4, out, lse, ref_out, ref_lse, diff
        torch.cuda.empty_cache()
    return main


def profile_forward(model, tokens) -> None:
    """Device time by kernel for one forward (torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.lm_head(model(tokens, return_hidden=True)).float()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        print("profile: no device time recorded (not measured)")
        return
    print(f"profile: forward device time {total_us / 1e3:.3f} ms by kernel")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms "
              f"{100 * e.self_device_time_total / total_us:5.1f}% "
              f"x{e.count:<4d} {e.key[:90]}")


def run_lm(fa, device) -> dict:
    """Phase 3: full-width TransformerLM inference, the main path."""
    from raydp_tpu_torch.models import TransformerLM, lm_loss, lm_loss_fused

    def make(attention: str, dtype: torch.dtype = torch.bfloat16):
        return TransformerLM(
            VOCAB, dim=DIM, num_heads=HEADS, num_layers=LAYERS,
            attention=attention, dtype=dtype, device=device,
            generator=torch.Generator(device=device).manual_seed(SEED)).eval()

    model = make("flash")
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(SEED)
    batches = [torch.from_numpy(rng.randint(0, VOCAB, size=(BATCH, SEQ)))
               .to(device) for _ in range(BATCHES)]
    print(f"lm: {n_params / 1e6:.1f}M params, dim {DIM}, {LAYERS} layers, "
          f"{HEADS} heads, vocab {VOCAB}, bf16 activations; "
          f"{BATCHES} batches of {BATCH}x{SEQ} tokens")

    torch.cuda.synchronize()
    fa.FWD_LAUNCHES = 0
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
    launches = fa.FWD_LAUNCHES

    for i, (finite, shape, loss, fused) in enumerate(results):
        print(f"lm batch {i}: forward {seconds[i] * 1e3:.3f} ms, "
              f"{BATCH * SEQ / seconds[i]:.1f} tokens/s, lm_loss {loss:.6f}, "
              f"lm_loss_fused {fused:.6f}, |diff| {abs(loss - fused):.3e}")
        require(shape == (BATCH, SEQ, VOCAB), f"logits shape {shape}")
        require(finite, f"batch {i}: non-finite logits")
        require(9.0 <= loss <= 12.0, f"batch {i}: lm_loss {loss} not near "
                f"ln({VOCAB}) = {math.log(VOCAB):.3f}")
        require(abs(loss - fused) <= FUSED_LOSS_ATOL,
                f"batch {i}: lm_loss_fused {fused} vs lm_loss {loss}")
    require(launches == LAYERS * BATCHES,
            f"flash forward kernel launched {launches} times on the main "
            f"path, expected {LAYERS * BATCHES}")
    steady = statistics.median(seconds[1:])
    print(f"lm forward: {BATCH * SEQ / steady:.1f} tokens/s steady "
          f"(median of batches 1..{BATCHES - 1}, {steady * 1e3:.3f} ms), "
          f"first batch {seconds[0] * 1e3:.3f} ms; flash launches {launches}")

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

    profile_forward(model, batches[1])
    return {"launches": launches, "tokens_per_s": BATCH * SEQ / steady}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 1
    from raydp_tpu_torch import resolve_device
    from raydp_tpu_torch.ops import _build
    from raydp_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    device = resolve_device()

    t0 = time.perf_counter()
    lib = _build.build("flash_attention_fwd")
    fa._fwd_entry()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    print(lib.with_suffix(".log").read_text().strip())

    main_row = check_kernel(fa, device, torch.Generator(device=device)
                            .manual_seed(SEED))
    lm = run_lm(fa, device)

    kernel = {"name": "flash_attention_fwd", "route": "cuda",
              "source": "raydp_tpu_torch/csrc/flash_attention_fwd.cu",
              "replaces": "raydp_tpu/ops/flash_attention.py:45",
              "launches": lm["launches"],
              **{k: main_row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")}}
    print(card)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
