#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (raydp_tpu_torch) on one CUDA card,
or, with phase 16, on four cards of one host.

    python3 chip_smoke.py [--baseline DIR] [--phases N,N,...]

With no ``--phases`` it runs phases 1-15 on one card. ``--phases`` runs
phase 1 and only the phases named (16 only when named: it needs four
cards and fails on fewer); a phase whose input comes from one not named
computes that input itself (13 runs the NYCTaxi example for its
single-process losses, 14 and 16 fit the in-process NYCTaxi run on
phase 13's frames), and a rate printed only as a yardstick from one not
named prints as nan. Phases 13-15 hold the same checks on any number of
cards: a gang takes one card a rank under nccl when the host has a card
for every rank (``fit_gang``'s rule), else its ranks share the cards
under gloo, and only what belongs to one backend (how a line names the
ranks' layout) follows the backend the gang reports. The jobs that ask
for ``gpus_per_process`` themselves (13 (a), 14 (d), (f), 15 (a)-(c))
keep their backend.

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
8. the main path end to end, CSV -> ETL -> train: the port's ETL session
   (``raydp_tpu_torch.init``, two executors of 2 cores on the host, which
   import no torch and hold no CUDA context) reads a seeded 400,000-row
   NYCTaxi CSV (the port's ``generate``), runs ``nyc_taxi_preprocess`` and
   ``TorchEstimator.fit_on_frame`` (NYCTaxiModel f32, smooth L1, Adam 1e-3,
   batch 8192, 5 epochs, shuffled: the resident path); then a seeded
   120,000-row Criteo TSV through ``pre_process`` (26 groupBy collects) and
   a streaming bf16 DLRM ``fit_on_frame`` (phase 6's model, batch 4096,
   ``RDT_DEVICE_CACHE=0``: the engine's ``random_shuffle`` first). Prints
   the ETL's split (read + preprocess, the rest of
   ``from_frame_recoverable``, the engine shuffle, DLRM's collects), rows,
   features, each epoch's report and steady samples/s beside phases 5-6's
   of the same model and dtype in this call. Checks: 25 features and the
   row count of a plain pandas filter, falling losses, an unshuffled
   ``fit_on_frame`` equal to a fit from a ``TableDataset`` of its blocks
   (1e-6), ``predict`` on a frame-converted dataset is a plain forward, no
   executor pid in ``nvidia-smi --query-compute-apps`` while the ETL runs
   and no CUDA library in an executor, a fit with
   ``stop_etl_after_conversion``, no flash launch, no segment left after
   ``stop()``;
9. the estimator's dispatch plane, at the widths of phases 5-6: on the
   card a resident fit replays one CUDA graph a step and a streaming fit
   with ``steps_per_dispatch=k`` one graph a stack of ``k`` batches (every
   resident fit of phases 5-8 replays graphs too). NYCTaxi f32 and bf16
   and DLRM bf16, unshuffled: graphed resident against eager streaming
   fits in turns (3 epochs each; f32 losses equal within 1e-6) and
   ``steps_per_dispatch=8`` (bench.py's CHAIN) against 1 in turns (the
   reference's rtol 1e-5, atol 1e-6), each with samples/s, peak memory,
   the capture's wall and the graph replays of every epoch (one a step or
   a stack, none skipped, each step run once); DLRM under remat none, dots
   and full (equal losses, peak memory, the captured step's activation
   bytes) and the optimizer step its checkpoint records after a graphed
   fit; a graphed NYCTaxi fit retried after the fault plane raises at
   ``estimator.epoch`` in epoch 2 (``max_retries=1``), equal to an
   uninterrupted one; ``partial_fit`` of 3 stream epochs of NYCTaxi rows
   through the port's ``ContinuousPipeline`` on its ETL session, equal to
   one fit over the same rows;
10. the serving plane: NYCTaxi f32 and DLRM bf16 at the widths of phases
    5-6, trained 2 resident epochs here and exported with
    ``export_serving``; ``load_servable`` in the driver, on the card,
    bitwise equal to ``predict`` over the same batches (a ragged tail
    included); a port ETL session of two executors, which hold no CUDA
    context (``nvidia-smi --query-compute-apps`` and their maps) until a
    ``ServingSession`` loads two replicas of each model into them (then
    three processes on the card: the driver and the two executors, each
    executor mapping ``libcuda``); ``benchmarks/serve_bench.py``'s open
    loop (a request every 10 ms in bursts of 4, hedging on, the default
    5 ms batch timeout), 400 NYCTaxi requests of 2 rows and 400 DLRM
    requests of 64 after an unmeasured first pass of 100, then the same
    unhedged: request p50/p99 (and the first pass's), requests vs
    batches, hedges, each replica's apply seconds, one request's split
    from the spans, zero dropped, served rows bitwise equal to
    ``predict`` over other batches (every forward runs at the estimator's
    batch size), hedged against unhedged, two replicas given the same
    batch bitwise equal; a closed-loop ceiling (8
    clients of 256-row NYCTaxi requests for 5 s, rows/s); ``partial_fit
    (export_every=1, serving=...)`` over 2 stream epochs of the port's
    ``ContinuousPipeline`` hot-swapping two exports under traffic, zero
    dropped, then answers bitwise equal to the second export's own
    servable; ``serve_bench.py --rollout``'s guarded rollouts
    (``RDT_SERVE_ROLLOUT_STEP_S`` 5 s): a clean canary promoted, a canary
    stalled 500 ms a batch by a seeded ``serve.predict:delay`` rule rolled
    back with a blackbox bundle, both under open-loop load with zero
    dropped; a seeded ``serve.predict`` crash once on one replica: zero
    dropped, the restarted executor reloading its replica on the card; no
    flash launch and no segment left after ``close()`` and ``stop()``;
11. GBDT on the card at bench.py's GBDT configuration: a seeded
    200,000-row NYCTaxi CSV through the port's ETL session (two executors
    of 2 cores), ``random_split([0.9, 0.1], 0)`` and
    ``GBDTEstimator(params={"tree_method": "hist", "max_depth": 6})``
    ``fit_on_frame`` for 10 rounds of 256 bins with the per-round eval
    (the fused path: one captured round replayed); prints train and eval
    RMSE, rows x rounds / fit wall (bench.py's definition) and the wall's
    split (materialize, binning, copy to the card, capture, rounds, table
    fetch); ``predict`` on the eval frame equal to a plain numpy routing of
    ``get_model()``'s tables; the same 10-round fit graphed and eager in
    turns (all four bitwise equal, so two graphed fits are too); the port
    on the CPU against the card (at most 5 % of split nodes differ,
    margins within rtol 1e-3, atol 1e-4) for ``reg:squarederror``,
    ``binary:logistic``, ``multi:softprob`` (K = 4, fare quantiles) and an
    early-stopping fit (the same best iteration, a truncated forest);
    ``examples/torch_loop_nyctaxi.py``'s loop for 2 epochs on the card from
    ``to_torch_dataset`` (the loss falls), then on the CPU over the same
    bridge batches from the same seed, both runs' per-epoch train and eval
    losses printed side by side; no flash launch, no segment left after
    ``stop()``; then ``raydp_tpu_torch/examples/gbdt_nyctaxi.py``'s
    100 rounds launched through ``python -m raydp_tpu_torch.cli.submit
    --num-executors 2 --executor-cores 2`` as a child process (exit 0, the
    child's session took the submitted values, its rows x rounds / s); one
    replayed round profiled after the timed work of every phase;
12. the headline examples on the card:
    ``raydp_tpu_torch/examples/nyctaxi_mlp.py``'s ``main`` in this process
    at its defaults (100,000 generated rows, 2 executors, the full-width
    ``NYCTaxiModel``, batch 1024, 5 epochs) with ``--trace``: each epoch's
    report, the steady samples/s beside phase 8's fit_on_frame, the wall
    split (CSV, session start, the ETL inside fit_on_frame, the fit, trace,
    dump, stop), the merged trace's flow events and actor lanes; the loss
    falls and the trace and the metrics dump are written; then
    ``stroke_pipeline.py`` at its defaults (6,000 rows, 6 epochs, batch
    256) through ``python -m raydp_tpu_torch.cli.submit`` as a child
    process on the card, then on the CPU: each exits 0, its last line shows
    the train loss fell, its wall and final losses are printed, and the
    card's losses are within 1e-3 of the CPU's (the example draws its
    weights on the host);
13. the gang (``raydp_tpu_torch.spmd`` and ``TorchEstimator.fit_gang``):
    (a) the runner: a 2-rank plain job runs, stops and restarts; a 1-rank
    ``torch_distributed`` job with a card of its own (nccl) and a 2-rank
    job whose ranks share the card (gloo) each all-reduce CUDA tensors
    (``[1.0, 1.0]``, ``[3.0, 3.0]``), with each backend, start wall and the
    card's free memory before, with the ranks and after; (c)
    ``nyctaxi_mlp.py``'s ``main`` with ``--num-workers 2`` at its defaults,
    ``--epochs 2`` on one card (two ranks sharing it: gloo, eager; the cut
    keeps the default run inside 900 s) against phase 12's
    single-process
    run on the same rows: every epoch of both, epoch 0's train loss within
    ``GANG_EXAMPLE_RTOL`` (the two visit the rows in different orders; the
    eval losses printed),
    the steady rate, the wall split (gang start, the ranks' store reads,
    epochs) and the host wall of its ``all_reduce`` calls; then on a
    100,000-row ETL session's frames: (b) ``fit_gang(num_workers=1)`` under
    nccl with ``steps_per_dispatch=8``, unshuffled, its chains captured as
    CUDA graphs (replays > 0), against the in-process streaming fit with
    the same k (losses within 1e-6); (d) a 2-rank gang whose rank 1 exits
    at epoch 1, once (``max_retries=1``, 4 epochs, unshuffled, with the
    eval set), rank 1 spawned by a node agent on this host (SPREAD over
    the head's node and the agent's; on more than one card the agent holds
    the last one): the agent is rank 1's parent and spawns the crashed
    rank again, rank 0 is this process's child, the agent's join wall is
    printed; history ``[0, 1, 2, 3]``, the checkpoint's sidecar holds the
    pre-crash epochs, the train losses equal an in-process fit's on the
    same rows and order within ``GANG_RESUME_RTOL``, the last eval loss
    equals the driver's ``predict`` with the returned state within
    ``GANG_EVAL_RTOL``, and a shuffled in-process fit shows what the row
    order alone does to the losses; no flash launch;
14. the sharding plane (``parallel/mesh.py``, ``parallel/shard.py``):
    on phase 13's frames, (a) phase 13 (b)'s 1-rank nccl gang with
    ``mesh_spec=MeshSpec()``, a world-1 mesh: graphs replayed, losses
    bitwise (b)'s; (b) ``NYCTaxiModel`` at full width under
    ``mesh_spec=dict(fsdp=2)``, two ranks (sharing one card: gloo),
    unshuffled,
    2 epochs: train losses within ``GANG_RESUME_RTOL`` of 13 (d)'s
    in-process fit on the same rows in the same order, each rank's
    parameters, buffers and Adam moments at most ``SHARD_BYTES_LIMIT`` of
    the whole state's, the gathered state's ``predict`` against the last
    eval within ``GANG_EVAL_RTOL``; (c) DLRM at bench widths with 26
    tables of 1,002 rows under ``dlrm_param_rules("expert")`` on
    ``expert=2``, 120,000 rows, 2 epochs: 501 rows a table a rank, losses
    within ``SHARD_DLRM_RTOL`` of the in-process fit; (d) TransformerLM
    at full width cut to 2 layers and T = 2048 under
    ``transformer_param_rules("tensor")`` on ``tensor=2``: one SGD 1e-1
    step against the replicated step (loss within ``TP_LOSS_RTOL``, the
    parameters within ``TP_PARAM_BF16_STEPS`` × bf16's own distance from
    it), a q kernel of 4 heads a rank and each rank's flash kernels
    launched at H=4; (e) (b)'s gang for 4 epochs (3 on one card, where
    its ranks share it under gloo), crashed once at epoch 1 and resumed
    from the sharded multi-writer checkpoint (2 manifests, ``COMPLETE``,
    history ``[0, 1, 2, 3]`` or ``[0, 1, 2]``, the driver's restore bitwise
    the gang's state and its ``predict`` against the last eval); (f)
    ``fit_gbdt(mesh=)`` on two ranks at phase 11's configuration against
    the in-process fit (phase 11's split and margin limits). Each line
    prints the ranks' bytes and ``memory_allocated``, the steady rate, the
    host wall of the collective calls (their time under gloo, their
    enqueue under nccl) and the gang starts; then the phase's wall;
15. the seq and stage axes, on two ranks sharing the card (gloo): (a)
    ``ring_attention`` at the flagship shape (B=2, T=8192, H=8, D=128,
    bf16, causal) over ``seq=2``, its output and q/k/v gradients held
    against one ``flash_attention`` call within ``SPLIT_BF16_STEPS`` ×
    bf16's own distance from the f32 dense run (relative L2), the flash
    launches a rank (forward 1 and 2 under the causal skip), the ring's
    wall and the bytes each rank sent; (b) the TransformerLM at full width
    cut to 2 layers, T=8192 over ``seq=2``, one SGD step against the
    unsharded step with phase 14 (d)'s gates; (c) ``pipeline_apply`` over
    two full-width Blocks, one a stage of ``stage=2``, 4 microbatches of
    1 × 2048 tokens, outputs and both stages' gradients against the
    blocks in order, 5 launches of each kernel a rank (every tick); (d)
    ``fit_gang(mesh_spec={"stage": 2})`` of the reference test's
    ``PipelineModel`` against ``fit`` (rtol 5e-4) and the
    ``train_pipeline_stages`` gauge; (e) ``examples/longcontext_lm.py
    --seq-parallel 2``: the loss falls; then the phase's wall;
16. one card a rank, under nccl (only when named; fails on fewer than
    ``CARD_RANKS`` = 4 cards): (a) a 4-rank ``gpus_per_process=1`` job,
    every rank nccl on its own card (four distinct UUIDs), an all_reduce
    of ones ``[4.0, 4.0]``, and what this process holds on card 0, which
    rank 0 shares; on phase 13's frames, at ``steps_per_dispatch=8`` with
    the chains captured, ``CARD_EPOCHS`` = 3 epochs a gang (epoch 1's
    first chain profiled, so the steady rate is epoch 2's): (b) the
    replicated NYCTaxi gang of 2 ranks
    (losses within ``GANG_RESUME_RTOL`` of 13 (d)'s in-process fit), then
    (j), run next: (b)'s gang again with rank 1 on a node agent that holds
    card 3 (``CUDA_VISIBLE_DEVICES=3``, ``--resource GPU=1``): rank 1 the
    agent's child on card 3's UUID, rank 0 on another card, replays, and
    the train losses bitwise (b)'s; (c)
    14 (b)'s fsdp=2 gang, replays in every epoch and eager only the
    warm-up chain and each epoch's remainder, against the same gang at
    k=1 (eager) within ``SAME_PATH_RTOL`` and the in-process fit within
    ``GANG_RESUME_RTOL``, each rank's bytes within ``SHARD_BYTES_LIMIT``,
    peak ``memory_allocated`` captured against eager; (d) the same on
    ``{"data": 2, "fsdp": 2}`` over four ranks, the one case that needs
    four cards; (e) 14 (c)'s expert=2 DLRM, captured, within
    ``SHARD_DLRM_RTOL``; (f) the TransformerLM at
    bench.py's full width
    and depth (8 layers, B=2, T=8192) under ``tensor=2``, then ``seq=2``,
    two Adam steps against the unsharded steps on rank 0's card: the
    losses within ``TP_LOSS_RTOL``, each step's gradients a parameter
    within ``TP_PARAM_BF16_STEPS`` times bf16's own distance (from f32
    flash steps), each rank's
    flash launches (16 of each under tensor; 16 and 32 under the causal
    ring); (g) 15 (a)'s ring at the flagship shape; (h) 15 (d)'s staged
    ``PipelineModel`` in chains of ``PIPE_EST_CHAIN``, captured; (i) 14
    (e)'s crash and resume, captured, with the retry's wall. Each gang's
    nccl kernels' share of one replayed chain's device time a rank (a
    ``torch.profiler`` trace after a host barrier), and (f)'s and (g)'s of
    a profiled step; then the phase's wall;
17. prints the cards again, one JSON line of kernel results (with each
    kernel's launches a rank in 14 (d), ``launches_tensor_parallel``, 15
    (b), ``launches_ring``, 15 (c), ``launches_pipeline``, and in 16 (f),
    ``launches_nccl_tensor`` and ``launches_nccl_seq``, for the phases
    that ran), then the last line ``{"ok": true, "device": {...}}``.

The phases run in the order 1, 2, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
16, 3, 4: phases 5-16 are bound by the host's kernel launches, so their
timed fits and requests come before any ``torch.profiler`` session of
the process (16's traces run in its ranks), and the profiled epochs of
5-6 (one per model, in fits of their own, replaying graphs) and phase
11's profiled round after them. Every kernel launch counter is set to 0
just before each driven path (3, both modes of 4, 5, 6, 7, 8, 9, 10, 11,
12, 13, 14, 15 and 16) and read just after; 5-16 run no attention in
this process and must launch none; the ranks of 14 (d), 15 and 16 (f),
(g) count their own launches, each case's from 0. Any failed check exits
non-zero; so does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
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
from typing import Optional

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


class HostClock:
    """What the driver's host spends beside a call's own thread: cyclic
    garbage-collection pauses (``gc.callbacks``; a pause stops every
    thread), with the count of full (generation 2) collections, and the
    CPU seconds of the process's other threads (process time less this
    thread's). A resident fit has no feed thread, so there the other
    threads are the runtime's and anything else the process runs."""

    def __enter__(self):
        self.gc_s, self.full_collections, self._t = 0.0, 0, None
        gc.callbacks.append(self._collect)
        self._cpu = time.process_time() - time.thread_time()
        return self

    def _collect(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.full_collections += info["generation"] == 2
            self._t = None

    def __exit__(self, *exc):
        gc.callbacks.remove(self._collect)
        self.other_threads_cpu_s = (time.process_time() - time.thread_time()
                                    - self._cpu)


@contextlib.contextmanager
def env_knobs(**values):
    """Environment knobs set for the block (read by what starts in it: a
    serving session, a rollout, spawned executors), then restored."""
    import os

    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def device_cache(on: bool):
    """``RDT_DEVICE_CACHE`` set to ``on`` (the residency gate forced) for
    the block, and back to what it was after it."""
    return env_knobs(RDT_DEVICE_CACHE="1" if on else "0")


def steady_rate(epochs: list) -> float:
    """Samples/s over the given epochs' reports, weighted by their
    walls."""
    return sum(r["samples_per_s"] * r["epoch_time_s"] for r in epochs) \
        / sum(r["epoch_time_s"] for r in epochs)


def fit_and_report(label: str, make_estimator, dataset, epochs: int,
                   *, cache: bool = True, profile_epoch=None,
                   steady_wall_s=None, max_retries: int = 0,
                   frame_kw=None):
    """One TorchEstimator fit on the card, the residency gate forced
    (``cache``); prints each epoch's report, the peak device memory and,
    with ``profile_epoch``, that epoch's profile (its idle share also
    against ``steady_wall_s``, an unprofiled epoch's wall). With
    ``frame_kw`` (a dict, maybe empty) ``dataset`` is an ETL DataFrame and
    the fit is ``fit_on_frame(dataset, **frame_kw)``. Returns (estimator,
    result, numbers)."""
    prof = EpochProfile(profile_epoch) if profile_epoch is not None else None
    est = make_estimator([prof] if prof else [])
    with device_cache(cache):
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with HostClock() as host:
            if frame_kw is None:
                result = est.fit(dataset, max_retries=max_retries)
            else:
                result = est.fit_on_frame(dataset, max_retries=max_retries,
                                          **frame_kw)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
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
    numbers = {"samples_per_s_steady": steady_rate(steady),
               "steady_epochs": [r["epoch"] for r in steady],
               "steady_epoch_s": statistics.median(walls),
               "fit_wall_s": wall, "peak_bytes": peak, "losses": losses,
               "gc_s": host.gc_s, "full_collections": host.full_collections,
               "other_threads_cpu_s": host.other_threads_cpu_s}
    numbers["dispatch"] = result.dispatch
    replays = [d["graph_replays"] for d in result.dispatch]
    eager = [d["eager_steps"] for d in result.dispatch]
    capture = sum(d["capture_s"] for d in result.dispatch)
    print(f"{label}: {numbers['samples_per_s_steady']:.1f} samples/s steady "
          f"(epochs {numbers['steady_epochs']}), fit {wall:.3f} s, peak "
          f"memory {peak / 2 ** 20:.1f} MiB, loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}; host: gc {host.gc_s:.4f} s "
          f"({host.full_collections} full), other threads' CPU "
          f"{host.other_threads_cpu_s:.3f} s; graph replays {replays}, "
          f"eager steps {eager}, capture {capture:.4f} s")
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
    """The CPU_STEPS step losses of one unshuffled f32 fit, from the same
    weights and batches: on the CPU, on the card's eager streaming path
    and on the card's graphed resident path, each step held against the
    CPU's. The loss callable writes each step's loss into a device buffer
    at a cursor kept on the device, so the replays of a graph record their
    steps as the eager steps do (no host read in the loop)."""
    from raydp_tpu_torch.data import TableDataset
    from raydp_tpu_torch.train.torch_estimator import _resolve_loss

    first = TableDataset([dataset.to_arrow().slice(0, CPU_STEPS * NYC_BATCH)])
    smooth_l1 = _resolve_loss("smooth_l1")

    def step_losses(device, cache):
        rec = {}

        def loss(preds, labels, mask=None):
            value = smooth_l1(preds, labels, mask=mask)
            if not rec:   # the fit's first step is eager: not in a capture
                rec["losses"] = torch.zeros(2 * CPU_STEPS,
                                            device=value.device)
                rec["cursor"] = torch.zeros(1, dtype=torch.long,
                                            device=value.device)
            rec["losses"].index_copy_(0, rec["cursor"],
                                      value.detach().float().reshape(1))
            rec["cursor"].add_(1)
            return value

        with device_cache(cache):
            result = nyctaxi_estimator(model, None, 1, shuffle=False,
                                       loss=loss, device=device).fit(first)
        n = int(rec["cursor"])
        require(n == CPU_STEPS, f"{device} cache={cache}: {n} steps recorded")
        return result, [float(v) for v in rec["losses"][:n].cpu()]

    _, cpu = step_losses("cpu", False)
    _, card = step_losses("cuda", False)
    graphed, card_graphed = step_losses("cuda", True)

    def largest(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    rel, rel_graphed = largest(card, cpu), largest(card_graphed, cpu)
    print(f"nyctaxi card vs cpu, {CPU_STEPS} f32 steps: largest relative "
          f"loss difference {rel:.3e} eager streaming, {rel_graphed:.3e} "
          f"graphed resident (limit {CPU_LOSS_RTOL}; graphed vs eager "
          f"{largest(card_graphed, card):.3e}); card {card[0]:.6f} -> "
          f"{card[-1]:.6f}, cpu {cpu[0]:.6f} -> {cpu[-1]:.6f}; dispatch "
          f"{graphed.dispatch}")
    require(graphed.dispatch[0]["graph_steps"] == CPU_STEPS - 1,
            f"graphed card fit dispatch {graphed.dispatch}")
    require(rel <= CPU_LOSS_RTOL, f"card vs cpu losses: {card} vs {cpu}")
    require(rel_graphed <= CPU_LOSS_RTOL,
            f"graphed card vs cpu losses: {card_graphed} vs {cpu}")
    return {"steps": CPU_STEPS, "max_rel_diff": rel,
            "graphed_rel_diff": rel_graphed}


def check_predict(label: str, est, rows, columns=NYC_COLUMNS) -> float:
    """``est.predict(rows)`` on a ragged row count vs one plain forward of
    ``get_model()`` over all of them (``columns``, as float32); returns the
    share of the limit used."""
    got = est.predict(rows)
    table = rows.to_arrow()
    x = torch.tensor(np.stack([table[c].to_numpy().astype(np.float32)
                               for c in columns], 1), device=est.device)
    with torch.no_grad():
        plain = est.get_model()(x)[:, 0].cpu().numpy()
    limit = PREDICT_RTOL * (np.abs(plain) + np.sqrt(np.mean(plain ** 2)))
    used = float(np.max(np.abs(got - plain) / limit))
    print(f"{label} predict: {got.shape[0]} rows in batches of {NYC_BATCH}, "
          f"max |predict - forward| {np.max(np.abs(got - plain)):.3e}, "
          f"{used:.3f} of the limit")
    require(got.shape == plain.shape == (rows.count(),),
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
        with device_cache(cache):
            first[cache] = nyctaxi_estimator(
                model, None, 1, shuffle=False).fit(dataset).history[0][
                    "train_loss"]
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


def dlrm_model(vocab: int = DLRM_VOCAB):
    """bench.py's DLRM widths, bf16, seeded weights built on the CPU."""
    from raydp_tpu_torch.models import DLRM

    return DLRM([vocab] * len(DLRM_CATS), num_dense=len(DLRM_DENSE),
                embedding_dim=32, bottom_mlp=(512, 128, 32),
                top_mlp=(1024, 1024, 512, 256, 1), dtype=torch.bfloat16,
                device="cpu", generator=torch.Generator().manual_seed(SEED))


def dlrm_estimator(model, epochs, callbacks, shuffle=True, **kw):
    """bench.py's DLRM estimator: BCE with logits, the optax.adagrad(1e-2)
    mapping, bf16 compute, batch 4096 (``kw``: more estimator
    arguments)."""
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
        callbacks=list(callbacks), checkpoint_interval=epochs, **kw)


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


# ---------------------------------------------------------------------------
# phase 8: the main path end to end, the workload BASELINE.json names: CSV ->
# the port's ETL (two executors on the host, off the card) ->
# from_frame_recoverable -> TorchEstimator.fit_on_frame -> predict, for
# NYCTaxi (bench.py:225-253) and DLRM (bench.py:258-303, with dlrm_stream's
# RDT_DEVICE_CACHE=0 so the fit streams behind the engine's shuffle)

ETL_SESSION = dict(num_executors=2, executor_cores=2, executor_memory="2GB")
ETL_PARTITIONS, ETL_CHECK_EPOCHS = 4, 2
# fit_on_frame's dataset and a TableDataset of the same blocks feed the same
# batches in the same order: the same kernels on the same values, as
# resident and streaming do
ETL_LOSS_RTOL = SAME_PATH_RTOL


class CallClock:
    """Wall seconds spent in some of the port's functions, by label, while
    a user's call (``fit_on_frame``) runs them: each wrapped function adds
    the wall of its calls to its label, keeps its last arguments and runs
    inside ``during`` (a context manager) if given. ``restore`` puts the
    functions back."""

    def __init__(self):
        self.seconds, self.last_args, self._undo = {}, {}, []
        #: each call's wall, by label, never reset
        self.calls = {}

    def wrap(self, owner, attr: str, label: str, during=None) -> None:
        real = getattr(owner, attr)

        def timed(*args, **kwargs):
            self.last_args[label] = args
            t0 = time.perf_counter()
            try:
                if during is None:
                    return real(*args, **kwargs)
                with during:
                    return real(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                self.seconds[label] = self.seconds.get(label, 0.0) + dt
                self.calls.setdefault(label, []).append(dt)

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, real))

    def take(self) -> dict:
        out, self.seconds = self.seconds, {}
        return out

    def restore(self) -> None:
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)
        self._undo = []


class ComputeApps:
    """The pids ``nvidia-smi --query-compute-apps=pid`` lists, sampled about
    once a second in a thread while the body runs, and the most processes
    one sample listed (in a container the pids may be another namespace's,
    so the count is what shows a second process on the card). Only the ETL
    runs under it: an nvidia-smi call while a fit runs slows the fit."""

    def __init__(self):
        self.pids, self.samples, self.most = set(), 0, 0

    def _run(self) -> None:
        while True:
            got = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60)
            pids = [int(p) for p in got.stdout.split() if p.isdigit()]
            self.pids.update(pids)
            self.most = max(self.most, len(pids))
            self.samples += 1
            if self._stop.wait(1.0):
                return

    def __enter__(self):
        import threading

        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=120)
        require(not self._thread.is_alive(), "nvidia-smi sampler hung")


def clean_up_rows(csv: str) -> int:
    """A plain pandas count of the rows nyctaxi_features.clean_up keeps."""
    import pandas as pd

    d = pd.read_csv(csv)
    keep = ((d.pickup_longitude <= -72) & (d.pickup_longitude >= -76)
            & (d.dropoff_longitude <= -72) & (d.dropoff_longitude >= -76)
            & (d.pickup_latitude <= 42) & (d.pickup_latitude >= 38)
            & (d.dropoff_latitude <= 42) & (d.dropoff_latitude >= 38)
            & (d.passenger_count <= 6) & (d.passenger_count >= 1)
            & (d.fare_amount > 0) & (d.fare_amount < 250)
            & (d.dropoff_longitude != d.pickup_longitude)
            & (d.dropoff_latitude != d.pickup_latitude))
    return int(keep.sum())


def etl_split(label: str, seconds: dict, fit_s: float, extra=None) -> dict:
    """Print and return a fit_on_frame's wall split: read + preprocess (the
    plan run into the executors' caches by ``persist``), the rest of
    ``from_frame_recoverable`` (each block put into the store and fetched),
    the engine's shuffle and the fit."""
    conv = seconds.get("conversion", 0.0)
    pre = seconds.get("read_preprocess", 0.0)
    out = {**(extra or {}), "read_preprocess_s": pre,
           "conversion_fetch_s": conv - pre,
           "from_frame_recoverable_s": conv,
           "engine_shuffle_s": seconds.get("engine_shuffle", 0.0),
           "fit_s": seconds.get("fit", 0.0), "fit_on_frame_s": fit_s}
    print(f"{label}: etl split " + json.dumps(
        {k: round(v, 4) if isinstance(v, float) else v
         for k, v in out.items()}))
    return out


def run_etl(fa, phase5: dict, phase6: dict, tmp: str) -> dict:
    """Phase 8: CSV -> the port's ETL -> fit_on_frame -> predict on the
    card, for NYCTaxi and DLRM at bench.py's sizes."""
    import os

    import raydp_tpu_torch
    from raydp_tpu_torch import data as rdt_data
    from raydp_tpu_torch.data import DistributedDataset, TableDataset
    from raydp_tpu_torch.etl.frame import DataFrame
    from raydp_tpu_torch.examples import dlrm_criteo
    from raydp_tpu_torch.examples.generate_nyctaxi import generate
    from raydp_tpu_torch.examples.nyctaxi_features import (
        LABEL, feature_columns, nyc_taxi_preprocess,
    )
    from raydp_tpu_torch.models import NYCTaxiModel
    from raydp_tpu_torch.runtime import get_runtime
    from raydp_tpu_torch.train import TorchEstimator

    t_phase = time.perf_counter()
    out = {}
    csv = os.path.join(tmp, "nyctaxi.csv")
    tsv = os.path.join(tmp, "criteo.tsv")
    t0 = time.perf_counter()
    generate(NYC_ROWS, seed=SEED).to_csv(csv, index=False)
    dlrm_criteo.generate_criteo(DLRM_ROWS, tsv, seed=SEED)
    out["generate_s"] = time.perf_counter() - t0
    out["plain_rows"] = clean_up_rows(csv)
    print(f"etl: wrote {NYC_ROWS} NYCTaxi CSV rows and {DLRM_ROWS} Criteo TSV "
          f"rows in {out['generate_s']:.3f} s; pandas keeps "
          f"{out['plain_rows']} NYCTaxi rows through clean_up's filters")

    # the ETL's calls run under the nvidia-smi sampler, the fits do not
    apps = ComputeApps()
    clock = CallClock()
    clock.wrap(DataFrame, "persist", "read_preprocess")
    clock.wrap(rdt_data, "from_frame_recoverable", "conversion", apps)
    clock.wrap(DistributedDataset, "random_shuffle", "engine_shuffle", apps)
    clock.wrap(TorchEstimator, "fit", "fit")
    zero_launches(fa)
    t0 = time.perf_counter()
    session = raydp_tpu_torch.init("smoke", **ETL_SESSION)
    out["init_s"] = time.perf_counter() - t0
    prefix = f"rdt{get_runtime().session_id[:8]}"
    try:
        pids = [h.call("spawn_info")["pid"] for h in session.executors]
        print(f"etl: init {out['init_s']:.3f} s, executors {pids}")

        # NYCTaxi: fit_on_frame as bench.py's nyctaxi mode (resident path)
        frame = nyc_taxi_preprocess(
            session.read.csv(csv, num_partitions=ETL_PARTITIONS))
        features = feature_columns(frame)
        require(len(features) == NYCTAXI_FEATURES,
                f"NYCTaxi ETL yields {len(features)} features")
        model = NYCTaxiModel(len(features), device="cpu",
                             generator=torch.Generator().manual_seed(SEED))

        def nyc(epochs, shuffle):
            return lambda cb: TorchEstimator(
                model=model, loss="smooth_l1", feature_columns=features,
                label_column=LABEL, batch_size=NYC_BATCH, num_epochs=epochs,
                shuffle=shuffle, metrics=["mae"], callbacks=list(cb),
                checkpoint_interval=epochs)

        est, _, fit = fit_and_report(
            "etl nyctaxi f32 resident", nyc(NYC_EPOCHS, True), frame,
            NYC_EPOCHS, frame_kw={})
        ds = clock.last_args["fit"][1]
        out["nyctaxi"] = {**fit, **etl_split(
            "etl nyctaxi", clock.take(), fit["fit_wall_s"],
            {"rows": ds.count(), "blocks": ds.num_blocks(),
             "features": len(features)})}
        print(f"etl nyctaxi: {ds.count()} rows in {ds.num_blocks()} blocks, "
              f"{len(features)} features; steady "
              f"{fit['samples_per_s_steady']:.1f} samples/s, phase 5's f32 "
              f"resident fit in this call "
              f"{phase5['f32_resident']['samples_per_s_steady']:.1f}")
        require(ds.count() == out["plain_rows"],
                f"ETL rows {ds.count()} vs pandas {out['plain_rows']}")
        require(out["nyctaxi"]["engine_shuffle_s"] == 0.0,
                "a resident fit_on_frame ran the engine's shuffle")

        # unshuffled: fit_on_frame == a TableDataset of the same blocks
        _, framed, _ = fit_and_report(
            "etl nyctaxi f32 unshuffled", nyc(ETL_CHECK_EPOCHS, False),
            frame, ETL_CHECK_EPOCHS, frame_kw={})
        table = TableDataset(clock.last_args["fit"][1].blocks())
        clock.take()
        _, tabled, _ = fit_and_report(
            "etl nyctaxi f32 unshuffled from a table",
            nyc(ETL_CHECK_EPOCHS, False), table, ETL_CHECK_EPOCHS)
        a = [r["train_loss"] for r in framed.history]
        b = [r["train_loss"] for r in tabled.history]
        print(f"etl nyctaxi unshuffled: fit_on_frame {a}, table {b}")
        for x, y in zip(a, b):
            require(abs(x - y) <= ETL_LOSS_RTOL * abs(y),
                    f"fit_on_frame losses {a} vs table {b}")
        # limit is per partition (exact only at collect): a ragged count
        out["predict_limit_used"] = check_predict(
            "etl nyctaxi", est,
            rdt_data.from_frame(frame.limit(PREDICT_ROWS)), features)
        clock.take()

        # DLRM: pre_process's 26 groupBy collects, then a streaming fit
        names = ([dlrm_criteo.LABEL] + dlrm_criteo.DENSE_COLS
                 + dlrm_criteo.CAT_COLS)
        require(names == ["_c0"] + DLRM_DENSE + DLRM_CATS,
                "Criteo schema differs from phase 6's")
        raw = session.read.csv(tsv, num_partitions=ETL_PARTITIONS, options={
            "delimiter": "\t", "column_names": names})
        with apps:
            t0 = time.perf_counter()
            df, sizes = dlrm_criteo.pre_process(session, raw)
            pre_s = time.perf_counter() - t0
        require(len(sizes) == len(DLRM_CATS) and max(sizes) <= DLRM_VOCAB,
                f"category sizes {sizes} exceed phase 6's tables")
        dmodel = dlrm_model()
        _, _, fit = fit_and_report(
            "etl dlrm bf16 streaming", lambda cb: dlrm_estimator(
                dmodel, DLRM_STREAM_EPOCHS, cb), df, DLRM_STREAM_EPOCHS,
            cache=False, frame_kw={})
        ds = clock.last_args["fit"][1]
        out["dlrm"] = {**fit, **etl_split(
            "etl dlrm", clock.take(), fit["fit_wall_s"],
            {"rows": ds.count(), "blocks": ds.num_blocks(),
             "features": len(names) - 1, "pre_process_collects_s": pre_s,
             "category_sizes": [min(sizes), max(sizes)]})}
        print(f"etl dlrm: pre_process (26 groupBy collects) {pre_s:.3f} s, "
              f"category sizes {min(sizes)}..{max(sizes)}; {ds.count()} rows "
              f"in {ds.num_blocks()} blocks; steady "
              f"{fit['samples_per_s_steady']:.1f} samples/s, phase 6's bf16 "
              f"streaming fit in this call "
              f"{phase6['bf16_streaming']['samples_per_s_steady']:.1f}")
        require(ds.count() == DLRM_ROWS, f"DLRM rows {ds.count()}")
        require(out["dlrm"]["engine_shuffle_s"] > 0,
                "the streaming fit_on_frame did not run the engine shuffle")

        # the executors stayed off the card
        maps = {pid: open(f"/proc/{pid}/maps").read() for pid in pids}
        out["executors_off_card"] = {
            "nvidia_smi_samples": apps.samples,
            "compute_app_pids": sorted(apps.pids),
            "most_compute_apps_at_once": apps.most,
            "executor_pids": pids, "driver_pid": os.getpid(),
            "executor_maps_cuda": [pid for pid, m in maps.items()
                                   if "libcuda" in m or "libtorch" in m]}
        print("etl: while the ETL ran, " + json.dumps(
            out["executors_off_card"]))
        # the driver's own context is the one process on the card
        require(apps.samples > 0 and not apps.pids & set(pids)
                and apps.most <= 1, "an ETL executor holds a CUDA context")
        require(not out["executors_off_card"]["executor_maps_cuda"],
                "an ETL executor loaded torch or the CUDA driver")

        # the ETL stopped (blocks kept) between conversion and fit
        _, stopped, _ = fit_and_report(
            "etl nyctaxi f32 stop_etl_after_conversion",
            nyc(ETL_CHECK_EPOCHS, False), frame, ETL_CHECK_EPOCHS,
            frame_kw={"stop_etl_after_conversion": True})
        require(not session.executors and session.master is not None,
                "stop(cleanup_data=False) left executors or no master")
        out["stop_etl_losses"] = [r["train_loss"] for r in stopped.history]
        clock.take()
        counts = launches(fa)
        print(f"etl launches of the flash kernels: {counts}")
        require(not any(counts.values()), f"etl phase launched {counts}")
    finally:
        clock.restore()
        raydp_tpu_torch.stop()
    left = [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]
    print(f"etl: after stop(), segments of the session left: {left}")
    require(not left, f"segments left after stop: {left}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"etl phase: {out['phase_s']:.3f} s")
    print("etl phase " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 9: the estimator's dispatch plane at the main path's widths. On the
# card a resident fit replays one CUDA graph a step (epoch 0: one eager
# warm-up step, a capture, replays) and a streaming fit with
# steps_per_dispatch=k one graph a stack of k batches; held against the
# eager streaming path, in turns. Then remat, a retry under graphs, the
# optimizer step a DLRM checkpoint records, and partial_fit over the port's
# continuous pipeline.

DISPATCH_EPOCHS = 3
# bench.py's CHAIN (bench.py:57): steps per dispatch on the streaming path
CHAIN = 8
# k steps chained vs dispatched one by one: the reference's own limits for
# the same contract (tests/test_train.py, steps_per_dispatch parity)
CHAIN_RTOL, CHAIN_ATOL = 1e-5, 1e-6
REMAT_EPOCHS = 2
# partial_fit: stream epochs of whole batches, so that the three epochs are
# the batches of one unshuffled fit over their rows, in the same order
ONLINE_EPOCHS, ONLINE_ROWS = 3, 4 * NYC_BATCH


def expected_dispatch(steps: int, k: int, first: bool) -> tuple:
    """(graph replays, eager steps) of one epoch of ``steps`` steps, one
    graph a step (``k = 1``, resident) or a stack of ``k``: the fit's
    first call is the eager warm-up and the next one captures; an epoch's
    remainder stack (steps % k) runs eagerly. Holds for epochs of at least
    two whole stacks (phases 5-6's widths: 48 and 29 steps)."""
    full, rem = divmod(steps, k)
    return (full - 1 if first else full, (k if first else 0) + rem)


def check_dispatch(label: str, result, k: int) -> None:
    """Every epoch of a graphed fit replays as ``expected_dispatch`` says,
    runs every step once, and epoch 0 captured."""
    for d, r in zip(result.dispatch, result.history):
        want = expected_dispatch(r["steps"], k, d["epoch"] == 0)
        got = (d["graph_replays"], d["eager_steps"])
        require(got == want and d["graph_steps"] + d["eager_steps"]
                == r["steps"], f"{label} epoch {d['epoch']}: (replays, "
                f"eager) {got}, expected {want}; {d}")
    require(result.dispatch[0]["capture_s"] > 0,
            f"{label}: no capture in epoch 0 ({result.dispatch[0]})")


def losses_of(result) -> list:
    return [r["train_loss"] for r in result.history]


def graphs_against_eager(label: str, make, dataset, gate: bool) -> dict:
    """Unshuffled fits in turns, graphed resident, eager streaming, eager
    streaming, graphed resident; every fit's losses against the first
    graphed one's (SAME_PATH_RTOL, a requirement only with ``gate``: f32;
    the bf16 differences are printed)."""
    runs = []
    for name, cache in (("graphed", True), ("eager", False),
                        ("eager", False), ("graphed", True)):
        _, result, numbers = fit_and_report(
            f"dispatch {label} {name}", make(DISPATCH_EPOCHS), dataset,
            DISPATCH_EPOCHS, cache=cache)
        if cache:
            check_dispatch(f"dispatch {label} graphed", result, 1)
        else:
            require(all(d["graph_replays"] == 0 for d in result.dispatch),
                    f"{label}: the eager streaming fit replayed a graph")
        runs.append((name, losses_of(result), numbers))
    ref = runs[0][1]
    worst = max(abs(a - b) / abs(b) for _, losses, _ in runs
                for a, b in zip(losses, ref))
    out = {"max_rel_diff": worst, "gated": gate}
    for name in ("graphed", "eager"):
        mine = [n for m, _, n in runs if m == name]
        out[name] = {
            "samples_per_s_steady": [n["samples_per_s_steady"] for n in mine],
            "peak_mib": [n["peak_bytes"] / 2 ** 20 for n in mine],
            "capture_s": [sum(d["capture_s"] for d in n["dispatch"])
                          for n in mine]}
    print(f"dispatch {label}: graphed "
          f"{[round(v, 1) for v in out['graphed']['samples_per_s_steady']]}"
          f" vs eager "
          f"{[round(v, 1) for v in out['eager']['samples_per_s_steady']]} "
          f"samples/s steady; peak graphed "
          f"{[round(v, 1) for v in out['graphed']['peak_mib']]} vs eager "
          f"{[round(v, 1) for v in out['eager']['peak_mib']]} MiB; capture "
          f"{[round(v, 4) for v in out['graphed']['capture_s']]} s; losses "
          f"differ by at most {worst:.3e} of themselves "
          f"({'limit ' + str(SAME_PATH_RTOL) if gate else 'not gated'})")
    if gate:
        require(worst <= SAME_PATH_RTOL,
                f"{label}: graphed vs eager losses {runs}")
    return out


def chain_against_one(label: str, make, dataset) -> dict:
    """Streaming fits in turns, steps_per_dispatch=CHAIN, 1, 1, CHAIN;
    every fit's losses against the first's at the reference's limits."""
    runs = []
    for k in (CHAIN, 1, 1, CHAIN):
        _, result, numbers = fit_and_report(
            f"dispatch {label} streaming k={k}", make(2, k), dataset, 2,
            cache=False)
        if k > 1:
            check_dispatch(f"dispatch {label} k={k}", result, k)
        runs.append((k, losses_of(result), numbers))
    ref = runs[0][1]
    for k, losses, _ in runs:
        require(all(abs(a - b) <= CHAIN_ATOL + CHAIN_RTOL * abs(b)
                    for a, b in zip(losses, ref)),
                f"{label}: k={k} losses {losses} vs k={CHAIN} {ref}")
    out = {f"k{k}": [n["samples_per_s_steady"] for m, _, n in runs if m == k]
           for k in (CHAIN, 1)}
    print(f"dispatch {label}: streaming k={CHAIN} "
          f"{[round(v, 1) for v in out[f'k{CHAIN}']]} vs k=1 "
          f"{[round(v, 1) for v in out['k1']]} samples/s steady; losses "
          f"within rtol {CHAIN_RTOL}, atol {CHAIN_ATOL} ({ref})")
    return out


def run_remat(dataset, tmp: str) -> dict:
    """DLRM (phase 6's widths, bf16, graphed resident) under remat none,
    dots and full: the same losses (recomputation recomputes, it does not
    approximate), the peak memory and the captured step's activation bytes
    per mode. The ``none`` fit checkpoints; its restored optimizer state
    must record the steps it ran (Adagrad keeps its step counter on the
    host, and a replay does not advance it: the runner does)."""
    import os

    from raydp_tpu_torch import metrics as rdt_metrics
    from raydp_tpu_torch.train import checkpoint as ckpt

    model = dlrm_model()
    out = {}
    ckpt_dir = os.path.join(tmp, "dlrm_remat_none")
    losses = {}
    for mode in ("none", "dots", "full"):
        rdt_metrics.reset()
        est, result, numbers = fit_and_report(
            f"dispatch dlrm bf16 remat={mode}", lambda cb: dlrm_estimator(
                model, REMAT_EPOCHS, cb, shuffle=False, remat=mode,
                checkpoint_dir=ckpt_dir if mode == "none" else None),
            dataset, REMAT_EPOCHS)
        check_dispatch(f"dlrm remat={mode}", result, 1)
        gauge = rdt_metrics.snapshot()["gauges"].get(
            "train_activation_bytes_per_process", {}).get("")
        require((gauge is None) == (mode == "none"),
                f"remat={mode}: activation gauge {gauge}")
        losses[mode] = losses_of(result)
        out[mode] = {"losses": losses[mode],
                     "peak_mib": numbers["peak_bytes"] / 2 ** 20,
                     "activation_mib": None if gauge is None
                     else gauge / 2 ** 20,
                     "samples_per_s_steady": numbers["samples_per_s_steady"]}
        if mode == "none":
            steps = sum(r["steps"] for r in result.history)
            saved, _ = ckpt.restore(ckpt_dir, est._result.state.state_dict())
            recorded = sorted({float(s["step"]) for s in
                               saved["optimizer"]["state"].values()})
            print(f"dispatch dlrm checkpoint after a graphed fit of {steps} "
                  f"steps: the optimizer's step counters read {recorded}")
            require(recorded == [float(steps)],
                    f"the checkpoint records steps {recorded}, ran {steps}")
            out["checkpoint_step"] = recorded[0]
    for mode in ("dots", "full"):
        require(all(abs(a - b) <= SAME_PATH_RTOL * abs(b)
                    for a, b in zip(losses[mode], losses["none"])),
                f"remat={mode} losses {losses[mode]} vs none {losses['none']}")
    print("dispatch dlrm remat: " + ", ".join(
        f"{m} peak {out[m]['peak_mib']:.1f} MiB, captured step "
        f"{out[m]['activation_mib'] if out[m]['activation_mib'] is None else round(out[m]['activation_mib'], 1)} MiB"
        for m in ("none", "dots", "full"))
        + f"; losses equal within {SAME_PATH_RTOL}")
    return out


def run_retry(dataset, tmp: str) -> dict:
    """NYCTaxi f32, graphed resident, shuffled: the port's fault plane
    raises at ``estimator.epoch`` in epoch 2 with ``max_retries=1``; the
    fit restores epoch 1's checkpoint, captures again and must end as an
    uninterrupted one."""
    import os

    from raydp_tpu_torch import faults
    from raydp_tpu_torch.models import NYCTaxiModel

    model = NYCTaxiModel(NYCTAXI_FEATURES, device="cpu",
                         generator=torch.Generator().manual_seed(SEED))
    epochs = 4

    def make(name):
        return lambda cb: nyctaxi_estimator(
            model, None, epochs, callbacks=cb,
            checkpoint_dir=os.path.join(tmp, f"retry_{name}"))

    _, clean, _ = fit_and_report("dispatch nyctaxi f32 graphed clean",
                                 make("clean"), dataset, epochs)
    faults.clear()
    try:
        rule = faults.inject("estimator.epoch", "raise", match="2", times=1)
        _, retried, _ = fit_and_report(
            "dispatch nyctaxi f32 graphed retried", make("retried"), dataset,
            epochs, max_retries=1)
    finally:
        faults.clear()
    a, b = losses_of(clean), losses_of(retried)
    print(f"dispatch retry: the fault fired {rule.fires} time(s) at epoch "
          f"2; losses {b} vs uninterrupted {a}; dispatch {retried.dispatch}")
    require(rule.fires == 1, "the estimator.epoch fault never fired")
    require(len(a) == len(b) == epochs and all(
        abs(x - y) <= SAME_PATH_RTOL * abs(y) for x, y in zip(b, a)),
        f"retried {b} vs uninterrupted {a}")
    # the retried epoch warms up and captures again
    require([d["epoch"] for d in retried.dispatch] == [0, 1, 2, 3]
            and retried.dispatch[2]["eager_steps"] == 1
            and retried.dispatch[2]["capture_s"] > 0,
            f"retried dispatch {retried.dispatch}")
    return {"losses": b, "fires": rule.fires}


def run_online(tmp: str) -> dict:
    """partial_fit over the port's continuous pipeline on its ETL session:
    ONLINE_EPOCHS stream epochs of ONLINE_ROWS NYCTaxi rows each, through a
    filter that keeps every row, train NYCTaxiModel f32 eagerly, one pass an
    epoch; the same steps as one unshuffled fit over the epochs' rows, so
    the per-epoch losses average to that fit's loss and the weights end
    equal (SAME_PATH_RTOL)."""
    import os

    import raydp_tpu_torch
    from raydp_tpu_torch import stream
    from raydp_tpu_torch.data import TableDataset
    from raydp_tpu_torch.etl.expressions import col
    from raydp_tpu_torch.models import NYCTaxiModel
    from raydp_tpu_torch.runtime import get_runtime

    def rows(epoch):
        return nyctaxi_tables(ONLINE_ROWS, 1, SEED + 10 + epoch)[0]

    model = NYCTaxiModel(NYCTAXI_FEATURES, device="cpu",
                         generator=torch.Generator().manual_seed(SEED))
    out = {}
    t0 = time.perf_counter()
    session = raydp_tpu_torch.init("smoke-stream", **ETL_SESSION)
    prefix = f"rdt{get_runtime().session_id[:8]}"
    try:
        est = nyctaxi_estimator(model, None, 1, shuffle=False)
        pipe = stream.read_stream(
            stream.SyntheticSource(rows, max_epochs=ONLINE_EPOCHS),
            session).transform(lambda df: df.filter(col(NYC_LABEL) > 0))
        with pipe:
            t1 = time.perf_counter()
            online = est.partial_fit(pipe, max_epochs=ONLINE_EPOCHS)
            out["partial_fit_s"] = time.perf_counter() - t1
        for r in online.history:
            print(f"online nyctaxi f32 epoch {r['epoch']}: " + json.dumps(
                {k: (round(v, 6) if isinstance(v, float) else v)
                 for k, v in r.items() if k != "epoch"}))
        online_model = est.get_model()
    finally:
        raydp_tpu_torch.stop()
    out["phase_s"] = time.perf_counter() - t0
    left = [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]
    losses = [r["train_loss"] for r in online.history]
    steps = [r["steps"] for r in online.history]
    with device_cache(False):
        plain = nyctaxi_estimator(model, None, 1, shuffle=False).fit(
            TableDataset([rows(e) for e in range(ONLINE_EPOCHS)]))
    mean = statistics.fmean(losses)
    want = plain.history[0]["train_loss"]
    a = online_model.state_dict()
    b = plain.state.model.state_dict()
    weights = max(float((a[k].float() - b[k].float()).abs().max()
                        / b[k].float().abs().max().clamp_min(1e-30))
                  for k in b)
    print(f"online: {online.epochs} stream epochs in "
          f"{out['partial_fit_s']:.3f} s (session and all "
          f"{out['phase_s']:.3f} s), steps {steps}, losses {losses}; their "
          f"mean {mean:.9f} vs one fit over the same rows {want:.9f}; "
          f"weights differ by at most {weights:.3e} of their largest; "
          f"segments of the session left: {left}")
    require(online.epochs == ONLINE_EPOCHS
            and steps == [ONLINE_ROWS // NYC_BATCH] * ONLINE_EPOCHS
            and all(map(math.isfinite, losses)),
            f"partial_fit history {online.history}")
    require(abs(mean - want) <= SAME_PATH_RTOL * abs(want)
            and weights <= SAME_PATH_RTOL,
            f"partial_fit vs fit: {mean} vs {want}, weights {weights}")
    require(not left, f"segments left after stop: {left}")
    out.update(losses=losses, steps=steps)
    return out


def run_dispatch(fa, tmp: str) -> dict:
    """Phase 9: graphs against eager, k=CHAIN against 1, remat, a retry,
    DLRM's checkpointed step and partial_fit, at the main path's widths."""
    from raydp_tpu_torch.data import TableDataset
    from raydp_tpu_torch.models import NYCTaxiModel

    t_phase = time.perf_counter()
    nyc = TableDataset(nyctaxi_tables(NYC_ROWS, NYC_BLOCKS, SEED))
    dlrm = TableDataset(criteo_tables(DLRM_ROWS, DLRM_BLOCKS, SEED))
    model = NYCTaxiModel(NYCTAXI_FEATURES, device="cpu",
                         generator=torch.Generator().manual_seed(SEED))
    model16 = NYCTaxiModel(NYCTAXI_FEATURES, dtype=torch.bfloat16,
                           device="cpu")
    model16.load_state_dict(model.state_dict())
    dmodel = dlrm_model()

    def nyc_make(m, dtype):
        return lambda epochs, k=1: lambda cb: nyctaxi_estimator(
            m, dtype, epochs, shuffle=False, callbacks=cb,
            checkpoint_interval=epochs, steps_per_dispatch=k)

    def dlrm_make(epochs, k=1):
        return lambda cb: dlrm_estimator(dmodel, epochs, cb, shuffle=False,
                                         steps_per_dispatch=k)

    configs = (("nyctaxi f32", nyc_make(model, None), nyc, True),
               ("nyctaxi bf16", nyc_make(model16, torch.bfloat16), nyc,
                False),
               ("dlrm bf16", dlrm_make, dlrm, False))
    out = {}
    zero_launches(fa)
    for label, make, dataset, gate in configs:
        free_memory()
        out[label] = {
            "graphs_vs_eager": graphs_against_eager(label, make, dataset,
                                                    gate),
            "chain_vs_one": chain_against_one(label, make, dataset)}
    free_memory()
    out["remat"] = run_remat(dlrm, tmp)
    free_memory()
    out["retry"] = run_retry(nyc, tmp)
    counts = launches(fa)
    require(not any(counts.values()), f"dispatch phase launched {counts}")
    free_memory()
    out["online"] = run_online(tmp)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"dispatch phase: {out['phase_s']:.3f} s")
    print("dispatch phase " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 10: the serving plane on the card. NYCTaxi f32 and DLRM bf16 at
# phases 5-6's widths, trained in this process and exported; the servable in
# the driver against predict; two executors of the port's ETL session host
# the replicas, each executor taking its CUDA context at its first
# serve_load; benchmarks/serve_bench.py's open-loop schedule, a closed-loop
# ceiling, hot swaps from partial_fit, guarded rollouts and a replica crash.

SERVE_EPOCHS = 2
# benchmarks/serve_bench.py's open loop: a request every 10 ms, arriving in
# bursts of 4 (the same mean rate); 2-row NYCTaxi requests there, and
# 64-row DLRM requests (one RDT_SERVE_MAX_BATCH each)
SERVE_REQUESTS, SERVE_INTERVAL_S, SERVE_BURST = 400, 0.010, 4
SERVE_MAX_BATCH = 64  # RDT_SERVE_MAX_BATCH's default
SERVE_ROWS = {"nyctaxi": 2, "dlrm": SERVE_MAX_BATCH}
# the unmeasured first pass of each session's open loop: the processes'
# first use of the coalesced batch shapes (serve_bench warms with 12
# sequential requests, which leaves those shapes to the measured run)
SERVE_WARMUP = 100
# the closed-loop ceiling: client threads sending 256-row NYCTaxi requests
# back to back
CEILING_THREADS, CEILING_ROWS, CEILING_S = 8, 256, 5.0
# serve_bench.py --rollout: the canary's seeded stall and the open-loop
# load that runs through a rollout (800 requests at 10 ms there)
ROLLOUT_DELAY_MS, ROLLOUT_REQUESTS, ROLLOUT_STEP_S = 500, 800, 5.0
# rows of the driver's servable-vs-predict check: a batch and a ragged tail
SERVE_PREDICT_ROWS = {"nyctaxi": PREDICT_ROWS, "dlrm": DLRM_BATCH + 777}


def gpu_processes() -> list:
    """``nvidia-smi --query-compute-apps=pid,used_memory`` rows: one per
    process holding a CUDA context on the card (in a container the pids
    may be another namespace's: the driver of phase 8 read as pid 1)."""
    got = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return [line.strip() for line in got.stdout.splitlines() if line.strip()]


def maps_cuda(pid: int) -> bool:
    with open(f"/proc/{pid}/maps") as f:
        return "libcuda" in f.read()


def against_reference(label: str, got: np.ndarray, ref: np.ndarray) -> dict:
    """Served rows against reference rows of another batch composition:
    bitwise equal. Prints the largest difference and the share of rows
    that differ (both 0 when the check holds)."""
    require(got.shape == ref.shape and bool(np.isfinite(got).all()),
            f"{label}: shape {got.shape} vs {ref.shape}, or not finite")
    diff = np.abs(got - ref)
    out = {"max_abs_diff": float(diff.max()),
           "rows_differing": float(np.mean(diff > 0)),
           "bitwise": bool(np.array_equal(got, ref))}
    print(f"{label}: " + json.dumps(out))
    require(out["bitwise"], f"{label}: {out}")
    return out


def open_loop(srv, requests: list, interval_s: float):
    """serve_bench.py's open loop: one predict_async per request on a fixed
    arrival schedule (bursts of SERVE_BURST), never waiting on completions;
    each latency stamped by the future's callback. Returns (predictions in
    order, latencies in ms, dropped requests)."""
    n = len(requests)
    futs, lats = [None] * n, [None] * n

    def stamp(i, t_issue):
        def cb(_f):
            lats[i] = (time.perf_counter() - t_issue) * 1000.0
        return cb

    t0 = time.perf_counter()
    for i, rows in enumerate(requests):
        due = t0 + (i // SERVE_BURST) * SERVE_BURST * interval_s
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t = time.perf_counter()
        try:
            futs[i] = srv.predict_async(rows)
        except Exception:  # noqa: BLE001 - shed at admission: a drop
            continue
        futs[i].add_done_callback(stamp(i, t))
    preds, dropped = [], 0
    for f in futs:
        try:
            preds.append(np.asarray(f.result(timeout=120.0)))
        except Exception:  # noqa: BLE001 - None (shed) or failed: a drop
            dropped += 1
            preds.append(None)
    return preds, [x for x in lats if x is not None], dropped


def request_split(executors) -> dict:
    """One request's path from the spans (the request of median wall): its
    ``serve:predict`` in the driver, the ``serve:batch`` submit it rode and
    the replica's ``serve:apply``, the replica's clock aligned to the
    driver's. Coalescing wait + encode ends where the submit starts; the
    RPC, the replica's queue and its decode + place lie between the submit
    and the apply; the reply and the demux after the apply."""
    from raydp_tpu_torch import profiler

    spans = profiler.spans()
    # a batch joins its first request's trace: requests that led a batch
    batches = {s["par"]: s for s in spans if s["name"] == "serve:batch"
               and "par" in s}
    reqs = sorted((s for s in spans if s["name"] == "serve:predict"
                   and "dur" in s and s["sid"] in batches),
                  key=lambda s: s["dur"])
    req = reqs[len(reqs) // 2]
    batch = batches[req["sid"]]
    apply = None
    for h in executors:
        offset = profiler.measure_clock_offset(
            lambda h=h: h.call("__rdt_clock__", timeout=10.0))
        for s in h.call("__rdt_spans__", timeout=10.0)["spans"]:
            if s["name"] == "serve:apply" and s.get("par") == batch["sid"]:
                apply = dict(s, ts=s["ts"] - offset)
    require(apply is not None, "no serve:apply span under the request's "
                               "serve:batch")
    us = 1e-3
    out = {"request_ms": req["dur"] * us,
           "coalesce_and_encode_ms": (batch["ts"] - req["ts"]) * us,
           "submit_ms": batch["dur"] * us,
           "rpc_queue_decode_place_ms":
               (apply["ts"] - batch["ts"] - batch["dur"]) * us,
           "apply_ms": apply["dur"] * us,
           "reply_and_demux_ms":
               (req["ts"] + req["dur"] - apply["ts"] - apply["dur"]) * us}
    return {k: round(v, 4) for k, v in out.items()}


def serve_open_loop(label: str, srv, requests, ref,
                    executors=None) -> tuple:
    """Warm up, run the open loop, print its numbers, and hold every
    response bitwise to ``ref`` (rows of predict over other batches).
    Returns (numbers, the predictions)."""
    _, first, first_dropped = open_loop(srv, requests[:SERVE_WARMUP],
                                        SERVE_INTERVAL_S)
    first = {"p50_ms": float(np.percentile(first, 50)),
             "p99_ms": float(np.percentile(first, 99))}
    before = srv.serving_report()
    t0 = time.perf_counter()
    preds, lats, dropped = open_loop(srv, requests, SERVE_INTERVAL_S)
    wall = time.perf_counter() - t0
    rep = srv.serving_report()
    delta = {k: rep[k] - before[k] for k in (
        "requests", "batches", "rows", "hedged", "hedge_won", "hedge_lost",
        "rerouted", "failed")}
    out = {"p50_ms": float(np.percentile(lats, 50)),
           "p99_ms": float(np.percentile(lats, 99)), "wall_s": wall,
           "dropped": first_dropped + dropped + delta["failed"], **delta,
           "mean_batch_rows": delta["rows"] / max(1, delta["batches"]),
           "first_pass": first}
    if executors is not None:
        out["replica_apply_s"] = {
            r["replica"]: r["apply_s"] for h in executors
            for r in h.call("serve_stats")["replicas"]
            if r["replica"].startswith(srv.name + "-")}
        out["split"] = request_split(executors)
    print(f"{label}: " + json.dumps(out))
    require(out["dropped"] == 0, f"{label}: {out['dropped']} requests "
                                 "dropped")
    out["vs_predict"] = against_reference(
        f"{label} vs predict", np.concatenate(preds), ref)
    return out, preds


def ceiling(srv, table) -> dict:
    """Closed loop: CEILING_THREADS clients, each sending CEILING_ROWS-row
    requests back to back for CEILING_S seconds; rows/s served."""
    import threading

    stop = time.perf_counter() + CEILING_S
    done = [0] * CEILING_THREADS
    errors = []

    def client(k):
        i = k
        try:
            while time.perf_counter() < stop:
                off = (i * CEILING_ROWS) % (table.num_rows - CEILING_ROWS)
                got = srv.predict(table.slice(off, CEILING_ROWS),
                                  timeout=120.0)
                require(got.shape == (CEILING_ROWS,), "ceiling shape")
                done[k] += CEILING_ROWS
                i += CEILING_THREADS
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    before = srv.serving_report()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(CEILING_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180.0)
    wall = time.perf_counter() - t0
    rep = srv.serving_report()
    require(not errors and not any(t.is_alive() for t in threads),
            f"ceiling clients failed: {errors}")
    out = {"threads": CEILING_THREADS, "rows_per_request": CEILING_ROWS,
           "wall_s": wall, "rows": sum(done),
           "rows_per_s": sum(done) / wall,
           "requests": rep["requests"] - before["requests"],
           "batches": rep["batches"] - before["batches"]}
    print("serve nyctaxi closed-loop ceiling: " + json.dumps(out))
    return out


def run_hot_swap(srv, session, requests, tmp: str) -> dict:
    """partial_fit(export_every=1, serving=srv) over 2 stream epochs of
    NYCTaxi rows through the port's ContinuousPipeline, while 2-row
    requests flow; then a request alone against v2's own servable."""
    import os
    import threading

    from raydp_tpu_torch import stream
    from raydp_tpu_torch.etl.expressions import col
    from raydp_tpu_torch.models import NYCTaxiModel
    from raydp_tpu_torch.serve import load_servable

    def rows(epoch):
        return nyctaxi_tables(ONLINE_ROWS, 1, SEED + 20 + epoch)[0]

    model = NYCTaxiModel(NYCTAXI_FEATURES, device="cpu",
                         generator=torch.Generator().manual_seed(SEED))
    est = nyctaxi_estimator(model, None, 1, shuffle=False)
    export_dir = os.path.join(tmp, "online")
    swaps0 = srv.serving_report()["hot_swaps"]
    stop, futs = threading.Event(), []

    def traffic():
        i = 0
        while not stop.is_set():
            futs.append(srv.predict_async(requests[i % len(requests)]))
            i += 1
            time.sleep(SERVE_INTERVAL_S)

    loader = threading.Thread(target=traffic)
    t0 = time.perf_counter()
    loader.start()
    try:
        pipe = stream.read_stream(
            stream.SyntheticSource(rows, max_epochs=2), session).transform(
            lambda df: df.filter(col(NYC_LABEL) > 0))
        with pipe:
            res = est.partial_fit(pipe, export_every=1, serving=srv,
                                  export_dir=export_dir)
    finally:
        stop.set()
        loader.join(timeout=120.0)
    wall = time.perf_counter() - t0
    dropped = 0
    for f in futs:
        try:
            f.result(timeout=120.0)
        except Exception:  # noqa: BLE001 - counted
            dropped += 1
    rep = srv.serving_report()
    want = [(0, os.path.join(export_dir, "v1")),
            (1, os.path.join(export_dir, "v2"))]
    v2 = load_servable(os.path.join(export_dir, "v2"))
    bitwise = {}
    for n in (2, 48):
        table = nyctaxi_tables(n, 1, SEED + 30)[0].drop([NYC_LABEL])
        bitwise[n] = bool(np.array_equal(srv.predict(table, timeout=60.0),
                                         v2.predict_table(table)))
    out = {"exports": [e for e, _ in res.exports], "requests": len(futs),
           "dropped": dropped + rep["failed"],
           "hot_swaps": rep["hot_swaps"] - swaps0,
           "servable": rep["servable"], "bitwise_v2": bitwise,
           "wall_s": wall, "losses": [h["train_loss"] for h in res.history]}
    print("serve hot swap: " + json.dumps(out))
    require(res.exports == want and out["hot_swaps"] == 2
            and rep["servable"]["export_dir"] == want[1][1],
            f"hot swap: exports {res.exports}, report {rep['servable']}")
    require(out["dropped"] == 0, f"hot swap dropped {out['dropped']}")
    require(all(bitwise.values()), f"hot swap answers vs v2: {bitwise}")
    return out


def run_rollouts(session, base_dir: str, requests, tmp: str) -> dict:
    """serve_bench.py --rollout's shape on the card: a canary that is a
    copy of the serving bundle ramps (0.5 then 1.0, judged per step) and is
    promoted; a canary whose replicas stall ROLLOUT_DELAY_MS on every batch
    (the seeded serve.predict:delay rule on the v3 replica ids) rolls back
    on the p99 arm and writes its blackbox bundle; open-loop load runs
    through both, and neither drops a request."""
    import os
    import threading

    from raydp_tpu_torch.runtime import get_runtime
    from raydp_tpu_torch.serve import ServingSession

    out = {}
    blackbox = os.path.join(get_runtime().session_dir, "blackbox")
    with env_knobs(RDT_SERVE_HEDGE="0"):  # serve_bench's rollout session
        srv = ServingSession(base_dir, session=session, name="roll")
    try:
        for i in range(12):  # serve_bench.py's warm-up
            srv.predict(requests[i], timeout=120.0)
        for mode in ("clean", "regress"):
            canary = os.path.join(tmp, f"canary-{mode}")
            shutil.copytree(base_dir, canary)
            load = {}

            def run_load():
                load["preds"], load["lats"], load["dropped"] = open_loop(
                    srv, [requests[i % len(requests)]
                          for i in range(ROLLOUT_REQUESTS)],
                    SERVE_INTERVAL_S)

            loader = threading.Thread(target=run_load)
            failed0 = srv.serving_report()["failed"]
            t0 = time.perf_counter()
            loader.start()
            outcome = srv.rollout(canary, tag=mode, initial_weight=0.5,
                                  steps=[0.5, 1.0], min_samples=8,
                                  p99_factor=2.0, timeout=120.0)
            load["t_outcome"] = time.perf_counter() - t0
            loader.join(timeout=240.0)
            require(not loader.is_alive(), "rollout load hung")
            rep = srv.serving_report()
            out[mode] = {
                "outcome": outcome["outcome"],
                "reason": outcome.get("reason"),
                "judgments": len(outcome["steps"]),
                "wall_s": time.perf_counter() - t0,
                "p50_ms": float(np.percentile(load["lats"], 50)),
                "p99_ms": float(np.percentile(load["lats"], 99)),
                "dropped": load["dropped"] + rep["failed"] - failed0,
                "decided_after_s": load["t_outcome"],
                "version": rep["servable"]["version"],
                "judged": [{k: s.get(k) for k in (
                    "weight", "verdict", "canary_requests", "base_requests",
                    "canary_p99_ms", "base_p99_ms")}
                    for s in outcome["steps"]]}
            print(f"serve rollout {mode}: " + json.dumps(out[mode]))
            require(out[mode]["dropped"] == 0,
                    f"rollout {mode} dropped requests")
        require(out["clean"]["outcome"] == "promoted"
                and out["clean"]["version"] == 2,
                f"the clean canary was not promoted: {out['clean']}")
        require(out["regress"]["outcome"] == "rolled_back"
                and "p99" in (out["regress"]["reason"] or "")
                and out["regress"]["version"] == 2,
                f"the slow canary was not rolled back: {out['regress']}")
        bundles = sorted(f for f in os.listdir(blackbox)
                         if f.startswith("blackbox-rollout-roll"))
        out["blackbox"] = bundles
        print(f"serve rollout: blackbox bundles {bundles}")
        require(bundles, "the rollback wrote no blackbox bundle")
    finally:
        srv.close()
    return out


def run_crash(session, base_dir: str, requests, ref) -> dict:
    """The seeded serve.predict crash rule fires once, on the 2nd batch
    entering replica crash-r0's worker: its executor dies mid-request. A
    concurrent burst and a sequential tail still complete with zero
    dropped, and the restarted executor reloads the replica on the card."""
    from raydp_tpu_torch.serve import ServingSession

    srv = ServingSession(base_dir, session=session, name="crash")
    try:
        host = next(h for h in session.executors
                    if h.name == srv.serving_report()["replicas"][0][
                        "executor"])
        old_pid = host.call("spawn_info")["pid"]
        t0 = time.perf_counter()
        futs = [srv.predict_async(r) for r in requests[:32]]
        got = [f.result(timeout=120.0) for f in futs]
        got += [srv.predict(r, timeout=120.0) for r in requests[32:48]]
        wall = time.perf_counter() - t0

        def back():
            row = next(r for r in srv.serving_report()["replicas"]
                       if r["replica"] == "crash-r0")
            return row["ready"] and row["reloads"] >= 1

        deadline = time.monotonic() + 120.0
        while not back() and time.monotonic() < deadline:
            srv.predict(requests[0], timeout=120.0)
            time.sleep(0.2)
        rep = srv.serving_report()
        new_pid = host.call("spawn_info")["pid"]
        # the killed process's context may linger in nvidia-smi a moment
        deadline = time.monotonic() + 30.0
        while len(apps := gpu_processes()) != 3 \
                and time.monotonic() < deadline:
            time.sleep(1.0)
        out = {"wall_s": wall, "rerouted": rep["rerouted"],
               "failed": rep["failed"], "requests": rep["requests"],
               "reloaded": back(), "old_pid": old_pid, "new_pid": new_pid,
               "new_pid_maps_cuda": maps_cuda(new_pid),
               "gpu_processes": apps}
        print("serve crash: " + json.dumps(out))
        require(out["reloaded"] and new_pid != old_pid,
                "the crashed replica did not come back in a new process")
        require(out["failed"] == 0 and out["rerouted"] >= 1,
                f"crash: {rep['failed']} failed, {rep['rerouted']} "
                "rerouted")
        require(out["new_pid_maps_cuda"] and len(apps) == 3,
                f"the reloaded replica is not on the card: {apps}")
        out["vs_predict"] = against_reference(
            "serve crash vs predict", np.concatenate(got), ref)
    finally:
        srv.close()
    return out


def run_serving(fa, tmp: str) -> dict:
    """Phase 10: export_serving -> load_servable -> ServingSession on
    executor-resident replicas on the card."""
    import os

    import raydp_tpu_torch
    from raydp_tpu_torch.data import TableDataset
    from raydp_tpu_torch.models import NYCTaxiModel
    from raydp_tpu_torch.runtime import get_runtime
    from raydp_tpu_torch.serve import ServingSession, load_servable

    t_phase = time.perf_counter()
    zero_launches(fa)
    out = {"card": torch.cuda.get_device_name(0)}
    # the models, trained in this process and exported
    nyc_model = NYCTaxiModel(NYCTAXI_FEATURES, device="cpu",
                             generator=torch.Generator().manual_seed(SEED))
    models = {
        "nyctaxi": fit_and_report(
            "serve nyctaxi f32 resident", lambda cb: nyctaxi_estimator(
                nyc_model, None, SERVE_EPOCHS, callbacks=cb,
                checkpoint_interval=SERVE_EPOCHS),
            TableDataset(nyctaxi_tables(NYC_ROWS, NYC_BLOCKS, SEED)),
            SERVE_EPOCHS)[0],
        "dlrm": fit_and_report(
            "serve dlrm bf16 resident", lambda cb: dlrm_estimator(
                dlrm_model(), SERVE_EPOCHS, cb),
            TableDataset(criteo_tables(DLRM_ROWS, DLRM_BLOCKS, SEED)),
            SERVE_EPOCHS)[0]}
    label = {"nyctaxi": NYC_LABEL, "dlrm": "_c0"}
    batch = {"nyctaxi": NYC_BATCH, "dlrm": DLRM_BATCH}
    dirs, requests, refs = {}, {}, {}
    for kind, est in models.items():
        dirs[kind] = os.path.join(tmp, f"serve-{kind}")
        t0 = time.perf_counter()
        est.export_serving(dirs[kind])
        export_s = time.perf_counter() - t0
        # the servable in the driver, on the card, over predict's batches
        make = nyctaxi_tables if kind == "nyctaxi" else criteo_tables
        rows = make(SERVE_PREDICT_ROWS[kind], 1, SEED + 7)[0].drop(
            [label[kind]])
        t0 = time.perf_counter()
        sv = load_servable(dirs[kind])
        load_s = time.perf_counter() - t0
        want = est.predict(TableDataset([rows]))
        got = np.concatenate([
            sv.predict_table(rows.slice(i, batch[kind]))
            for i in range(0, rows.num_rows, batch[kind])])
        same = bool(np.array_equal(got, want))
        print(f"serve {kind}: exported in {export_s:.3f} s, "
              f"{sv.nbytes} weight bytes, loaded in the driver in "
              f"{load_s:.3f} s; servable vs predict over {rows.num_rows} "
              f"rows in batches of {batch[kind]}: bitwise {same}")
        require(sv.device.type == "cuda", f"{kind}: the servable is not "
                                          "on the card")
        require(same, f"{kind}: servable differs from predict")
        out[kind] = {"export_s": export_s, "driver_load_s": load_s,
                     "weight_bytes": sv.nbytes}
        # the open loop's requests, and predict over all of their rows
        n = SERVE_ROWS[kind]
        table = make(SERVE_REQUESTS * n, 1, SEED + 8)[0].drop([label[kind]])
        requests[kind] = [table.slice(i * n, n)
                          for i in range(SERVE_REQUESTS)]
        refs[kind] = est.predict(TableDataset([table]))
        del sv
    free_memory()

    # the executors inherit the seeded rules at spawn (and a restarted one
    # again: the once= sentinel keeps the crash from firing twice)
    sentinel = os.path.join(tmp, "serve-crash.sentinel")
    faults = (f"serve.predict:delay:ms={ROLLOUT_DELAY_MS}:match=|roll-v3-;"
              f"serve.predict:crash:nth=2:match=|crash-r0:once={sentinel}")
    with env_knobs(RDT_FAULTS=faults):
        session = raydp_tpu_torch.init("smoke-serve", **ETL_SESSION)
    prefix = f"rdt{get_runtime().session_id[:8]}"
    try:
        # executors hold no CUDA context before serve_load
        pids = [h.call("spawn_info")["pid"] for h in session.executors]
        apps0 = gpu_processes()
        free0 = torch.cuda.mem_get_info()[0]
        out["before_load"] = {"executor_pids": pids, "gpu_processes": apps0,
                              "executors_map_cuda": [maps_cuda(p)
                                                     for p in pids]}
        print("serve: before serve_load " + json.dumps(out["before_load"]))
        require(len(apps0) == 1 and not any(map(maps_cuda, pids)),
                "an executor held a CUDA context before serve_load")
        srvs = {}
        for kind in ("nyctaxi", "dlrm"):
            t0 = time.perf_counter()
            srvs[kind] = ServingSession(dirs[kind], session=session,
                                        name=kind)
            out[kind]["serve_load_s"] = time.perf_counter() - t0
        apps = gpu_processes()
        # the card's memory the two executors took (contexts, four
        # replicas' weights, their allocators), from the driver's view
        taken = free0 - torch.cuda.mem_get_info()[0]
        out["after_load"] = {
            "gpu_processes": apps,
            "executors_map_cuda": [maps_cuda(p) for p in pids],
            "serve_load_s": {k: out[k]["serve_load_s"] for k in srvs},
            # the load's one row through both threads: the first batch of
            # a fresh executor (nyctaxi's), of a warm one (dlrm's)
            "warm_up_s": {r["replica"]: r["warm_up_s"]
                          for h in session.executors
                          for r in h.call("serve_stats")["replicas"]},
            "card_mib_per_executor": taken / len(pids) / 2 ** 20}
        print("serve: after serve_load " + json.dumps(out["after_load"]))
        require(len(apps) == 3 and all(map(maps_cuda, pids)),
                f"the replicas hold no CUDA context of their own: {apps}")
        # the open loop, hedged (the defaults) and not
        for kind, srv in srvs.items():
            out[kind]["open_loop"], hedged = serve_open_loop(
                f"serve {kind} open loop", srv, requests[kind], refs[kind],
                session.executors)
            with env_knobs(RDT_SERVE_HEDGE="0"):
                plain = ServingSession(dirs[kind], session=session,
                                       name=f"{kind}-unhedged")
            try:
                out[kind]["unhedged"], unhedged = serve_open_loop(
                    f"serve {kind} open loop unhedged", plain,
                    requests[kind], refs[kind])
            finally:
                plain.close()
            out[kind]["hedged_vs_unhedged"] = against_reference(
                f"serve {kind} hedged vs unhedged", np.concatenate(hedged),
                np.concatenate(unhedged))
        # two replicas given the same batch answer the same bits
        from raydp_tpu_torch.serve.session import _encode
        for kind in srvs:
            payload = _encode(requests[kind][0])
            each = [h.call("serve_predict", f"{kind}-r{i}", payload)
                    for i, h in enumerate(session.executors)]
            require(np.array_equal(each[0], each[1]),
                    f"{kind}: two replicas differ on the same batch")
        print("serve: two replicas given the same batch agree bitwise")
        out["nyctaxi"]["ceiling"] = ceiling(
            srvs["nyctaxi"], nyctaxi_tables(64 * CEILING_ROWS, 1, SEED + 9)[
                0].drop([NYC_LABEL]))
        out["hot_swap"] = run_hot_swap(srvs["nyctaxi"], session,
                                       requests["nyctaxi"], tmp)
        for srv in srvs.values():
            srv.close()
        with env_knobs(RDT_SERVE_ROLLOUT_STEP_S=str(ROLLOUT_STEP_S)):
            out["rollout"] = run_rollouts(session, dirs["nyctaxi"],
                                          requests["nyctaxi"], tmp)
        out["crash"] = run_crash(session, dirs["nyctaxi"],
                                 requests["nyctaxi"],
                                 refs["nyctaxi"][:48 * SERVE_ROWS[
                                     "nyctaxi"]])
        require(os.path.exists(sentinel), "the crash rule never fired")
        counts = launches(fa)
        print(f"serve launches of the flash kernels: {counts}")
        require(not any(counts.values()), f"serve phase launched {counts}")
    finally:
        raydp_tpu_torch.stop()
    left = [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]
    print(f"serve: after close() and stop(), segments of the session left: "
          f"{left}")
    require(not left, f"segments left after stop: {left}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serve phase: {out['phase_s']:.3f} s")
    print("serve phase " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 11: GBDT on the card at bench.py's GBDT configuration (bench.py:
# 376-420): a seeded 200,000-row NYCTaxi CSV through the port's ETL (two
# executors), random_split([0.9, 0.1], 0), GBDTEstimator (hist trees, depth
# 6, 256 bins) fit_on_frame for 10 rounds with the per-round eval (the fused
# path), predict; the example's 100 rounds launched through the port's
# submit CLI; graphed against eager rounds in turns, two graphed fits, the
# card against the CPU (three objectives and early stopping), the bridge's
# torch loop; one graphed round profiled after the timed work

GBDT_ROWS, GBDT_ROUNDS, GBDT_DEPTH = 200_000, 10, 6
GBDT_EXAMPLE_ROUNDS = 100
# binary:logistic and multi:softprob (labels from fare quantiles) on the
# same features; the early-stopping fit stops at most after 30 rounds
# (about 18 at this configuration on the CPU)
GBDT_OBJECTIVE_ROUNDS, GBDT_CLASSES = 20, 4
GBDT_EARLY_STOP, GBDT_EARLY_STOP_ROUNDS = 3, 30
# card vs CPU: the reference's own rule for a different reduction order
# (tests/test_gbdt.py's sharded fit): the card's histograms sum each
# segment in a tree (sorted segment_reduce), the CPU's in row order
GBDT_SPLIT_FRACTION, GBDT_MARGIN_RTOL, GBDT_MARGIN_ATOL = 0.05, 1e-3, 1e-4
BRIDGE_EPOCHS, BRIDGE_BATCH = 2, 1024


def plain_route(model, X: np.ndarray) -> np.ndarray:
    """A GBDTModel's margins by a plain numpy walk of its tables: bins by
    searchsorted, each tree's leaf value added in tree order to float32
    zeros, then the base score."""
    Xb = np.stack([np.searchsorted(model.bin_edges[j], X[:, j], side="left")
                   for j in range(X.shape[1])], axis=1)
    sf, sb, lv = model.split_feature, model.split_bin, model.leaf_value
    multi = sf.ndim == 3
    if not multi:
        sf, sb, lv = sf[:, None], sb[:, None], lv[:, None]
    rows = np.arange(len(X))
    pred = np.zeros((len(X), sf.shape[1]), np.float32)
    for t in range(sf.shape[0]):
        for k in range(sf.shape[1]):
            node = np.zeros(len(X), np.int64)
            for d in range(model.max_depth):
                at = 2 ** d - 1 + node
                node = node * 2 + (Xb[rows, sf[t, k, at]] > sb[t, k, at])
            pred[:, k] = pred[:, k] + lv[t, k, node]
    margin = pred if multi else pred[:, 0]
    return margin + model.base_score


def forests_agree(label: str, card, cpu, card_margin, cpu_margin) -> dict:
    """The card's forest against the CPU's under GBDT_SPLIT_FRACTION and
    the margins' limits."""
    frac = float(np.mean(card.split_feature != cpu.split_feature))
    diff = np.abs(card_margin - cpu_margin)
    out = {"split_nodes_differing": frac,
           "max_margin_diff": float(diff.max()),
           "margins_within": bool(np.allclose(
               card_margin, cpu_margin, rtol=GBDT_MARGIN_RTOL,
               atol=GBDT_MARGIN_ATOL))}
    print(f"{label} card vs cpu: " + json.dumps(out))
    require(card.split_feature.shape == cpu.split_feature.shape
            and frac <= GBDT_SPLIT_FRACTION and out["margins_within"],
            f"{label}: card vs cpu {out}")
    return out


def same_forest(a, b) -> bool:
    return all(np.array_equal(getattr(a, n), getattr(b, n)) for n in (
        "split_feature", "split_bin", "leaf_value", "base_score"))


@contextlib.contextmanager
def eager_step_runners():
    """Every StepRunner made inside runs each call eagerly (on the card it
    captures nothing): the rounds of a fit, launched one by one."""
    from raydp_tpu_torch.train import step_graph

    real = step_graph.StepRunner.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self.graphed = False

    step_graph.StepRunner.__init__ = init
    try:
        yield
    finally:
        step_graph.StepRunner.__init__ = real


def gbdt_turns(X, y, evals, edges) -> dict:
    """The 10-round fused fit graphed and eager, in turns (graphed, eager,
    eager, graphed): every fit the same bits, and the time of each."""
    from raydp_tpu_torch.models import fit_gbdt

    out = {"graphed": [], "eager": []}
    first = None
    for graphed in (True, False, False, True):
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.nullcontext() if graphed else eager_step_runners():
            fitted = fit_gbdt(X, y, num_trees=GBDT_ROUNDS,
                              max_depth=GBDT_DEPTH, evals=evals,
                              bin_edges=edges, timings=timings)
        timings["fit_s"] = time.perf_counter() - t0
        timings["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
        kind = "graphed" if graphed else "eager"
        out[kind].append(timings)
        print(f"gbdt {kind}: " + json.dumps(
            {k: round(v, 6) for k, v in timings.items()}))
        if first is None:
            first = fitted
            continue
        same = (same_forest(fitted[0], first[0])
                and np.array_equal(fitted[1], first[1])
                and fitted[2] == first[2])
        require(same, f"gbdt {kind} fit differs from the first graphed fit")
    require(all(t["graph_replays"] == GBDT_ROUNDS - 1
                for t in out["graphed"])
            and all(t["graph_replays"] == 0 for t in out["eager"]),
            f"gbdt dispatch: {out}")
    print(f"gbdt graphed vs eager, in turns: rounds "
          f"{[round(t['rounds_s'], 6) for t in out['graphed']]} s graphed "
          f"(capture {[round(t['capture_s'], 6) for t in out['graphed']]}),"
          f" {[round(t['rounds_s'], 6) for t in out['eager']]} s eager; "
          f"all four fits bitwise equal, the two graphed fits included")
    return out


def gbdt_card_vs_cpu(X, y, eX, ey, edges) -> dict:
    """The port on the CPU against the card, same data and bins: the bench
    configuration's regression, binary:logistic and multi:softprob (labels
    from fare quantiles) for GBDT_OBJECTIVE_ROUNDS rounds, and one
    early-stopping fit."""
    from raydp_tpu_torch.models import fit_gbdt

    out = {}
    cuts = np.quantile(y, np.linspace(0, 1, GBDT_CLASSES + 1)[1:-1])
    median = np.median(y)
    cases = {
        "reg:squarederror": (y, ey, GBDT_ROUNDS, {}),
        "binary:logistic": ((y > median).astype(np.float32),
                            (ey > median).astype(np.float32),
                            GBDT_OBJECTIVE_ROUNDS, {}),
        "multi:softprob": (np.digitize(y, cuts).astype(np.float32),
                           np.digitize(ey, cuts).astype(np.float32),
                           GBDT_OBJECTIVE_ROUNDS, {}),
        "early_stopping": (y, ey, GBDT_EARLY_STOP_ROUNDS,
                           {"early_stopping_rounds": GBDT_EARLY_STOP}),
    }
    for name, (yy, eyy, rounds, kw) in cases.items():
        objective = name if ":" in name else "reg:squarederror"
        fits = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            fits[dev] = fit_gbdt(X, yy, num_trees=rounds,
                                 max_depth=GBDT_DEPTH, objective=objective,
                                 evals=(eX, eyy), bin_edges=edges,
                                 device=dev, **kw)
            fits[dev] += (time.perf_counter() - t0,)
        (card, cm, ch, cs), (cpu, pm, ph, ps) = fits["cuda"], fits["cpu"]
        history = next(iter(ch.values()))
        row = forests_agree(f"gbdt {name}", card, cpu, cm, pm)
        row.update({"rounds_run": len(history),
                    "eval_first": history[0], "eval_last": history[-1],
                    "card_s": cs, "cpu_s": ps})
        require(min(history) < history[0], f"gbdt {name}: the eval loss "
                f"did not fall: {history}")
        if name == "early_stopping":
            row.update({"best_iteration": card.best_iteration,
                        "cpu_best_iteration": cpu.best_iteration,
                        "trees": card.num_trees})
            require(card.best_iteration == cpu.best_iteration
                    and card.num_trees == card.best_iteration + 1
                    < len(history), f"early stopping: best iteration "
                    f"{card.best_iteration} on the card, "
                    f"{cpu.best_iteration} on the cpu, {card.num_trees} "
                    f"trees kept of {len(history)} rounds")
        else:
            require(history[-1] < history[0], f"gbdt {name}: the eval loss "
                    f"did not fall: {history}")
        print(f"gbdt {name}: " + json.dumps(row))
        out[name] = row
    return out


def gbdt_example(tmp: str) -> dict:
    """examples/gbdt_nyctaxi.py's 100 rounds through the port's submit CLI,
    as a child process: it exits 0, its session took the submitted
    executors, and it reports rows x rounds / s."""
    import os
    import re

    repo = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "raydp_tpu_torch.cli.submit",
           "--num-executors", "2", "--executor-cores", "2",
           os.path.join(repo, "raydp_tpu_torch", "examples",
                        "gbdt_nyctaxi.py"),
           "--rows", str(GBDT_ROWS), "--rounds", str(GBDT_EXAMPLE_ROUNDS)]
    env = dict(os.environ, PYTHONPATH=repo, TMPDIR=tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True,
                          text=True, timeout=900)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith("gbdt_nyctaxi "):
            print(f"  child: {line}")
    require(proc.returncode == 0, f"the submitted example exited "
            f"{proc.returncode}: {proc.stderr[-3000:]}")
    took = re.search(r"session: (\d+) executors x (\d+) cores", proc.stdout)
    report = json.loads(next(line for line in lines if line.startswith(
        "gbdt_nyctaxi "))[len("gbdt_nyctaxi "):])
    out = {"exit": proc.returncode, "child_wall_s": wall,
           "session": [int(took.group(1)), int(took.group(2))] if took
           else None, **report}
    print("gbdt example through submit: " + json.dumps(out))
    require(out["session"] == [2, 2], f"the child's session did not take "
            f"the submitted values: {out['session']}")
    return out


def profile_gbdt_round(X, y, evals, edges, steady_round_s: float) -> dict:
    """torch.profiler over one replayed round of a graphed fused fit (the
    third call of its step runner: the first is eager, the second
    captures)."""
    from torch.profiler import ProfilerActivity, profile

    from raydp_tpu_torch.models import fit_gbdt
    from raydp_tpu_torch.train import step_graph

    window = EpochProfile(0)
    real = step_graph.StepRunner.__call__
    calls = []

    def traced(self, inputs, n_steps=1):
        calls.append(1)
        if len(calls) != 3:
            return real(self, inputs, n_steps)
        torch.cuda.synchronize()
        window.prof = profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA])
        window.prof.start()
        t0 = time.perf_counter()
        real(self, inputs, n_steps)
        torch.cuda.synchronize()
        window.wall_s = time.perf_counter() - t0
        window.prof.stop()

    torch.cuda.reset_peak_memory_stats()
    step_graph.StepRunner.__call__ = traced
    try:
        fit_gbdt(X, y, num_trees=4, max_depth=GBDT_DEPTH, evals=evals,
                 bin_edges=edges)
    finally:
        step_graph.StepRunner.__call__ = real
    out = window.summary("gbdt graphed round", steady_round_s)
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"profile gbdt graphed round: peak memory {out['peak_mib']:.1f} "
          "MiB")
    return out


def run_gbdt(fa, tmp: str):
    """Phase 11: CSV -> the port's ETL -> GBDTEstimator.fit_on_frame ->
    predict on the card, and the checks around it. Returns the numbers and
    a function that profiles one graphed round (called after the timed
    work of every phase)."""
    import os

    import raydp_tpu_torch
    from raydp_tpu_torch.examples.generate_nyctaxi import generate
    from raydp_tpu_torch.examples.nyctaxi_features import (
        LABEL, feature_columns, nyc_taxi_preprocess,
    )
    from raydp_tpu_torch.examples.torch_loop_nyctaxi import train_loop
    from raydp_tpu_torch.data import to_torch_dataset
    from raydp_tpu_torch.runtime import get_runtime
    from raydp_tpu_torch.train import GBDTEstimator
    from raydp_tpu_torch.utils import random_split

    t_phase = time.perf_counter()
    zero_launches(fa)
    out = {"card": torch.cuda.get_device_name(0)}
    csv = os.path.join(tmp, "gbdt-nyctaxi.csv")
    generate(GBDT_ROWS, seed=SEED).to_csv(csv, index=False)
    clock = CallClock()
    clock.wrap(GBDTEstimator, "fit", "fit")
    session = raydp_tpu_torch.init("smoke-gbdt", **ETL_SESSION)
    prefix = f"rdt{get_runtime().session_id[:8]}"
    try:
        frame = nyc_taxi_preprocess(
            session.read.csv(csv, num_partitions=ETL_PARTITIONS))
        features = feature_columns(frame)
        train_df, test_df = random_split(frame, [0.9, 0.1], 0)
        est = GBDTEstimator(
            params={"tree_method": "hist", "max_depth": GBDT_DEPTH},
            feature_columns=features, label_column=LABEL,
            num_boost_round=GBDT_ROUNDS)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = est.fit_on_frame(train_df, test_df)
        frame_s = time.perf_counter() - t0
        fit_s = clock.take()["fit"]
        _, train_ds, eval_ds = clock.last_args["fit"][:3]
        report = result.history[-1]
        split = dict(result.dispatch[0])
        split["report_and_checkpoint_s"] = fit_s - sum(
            split[k] for k in ("materialize_s", "binning_s", "h2d_s",
                               "capture_s", "rounds_s", "fetch_s"))
        n_train = train_ds.count()
        out["bench"] = {
            "train_rows": n_train, "eval_rows": eval_ds.count(),
            "features": len(features), "rounds": GBDT_ROUNDS,
            "train_rmse": report["train_rmse"],
            "eval_rmse": report["eval_rmse"],
            "fit_on_frame_s": frame_s, "fit_wall_s": fit_s,
            # bench.py:412: int(rows * 0.9) x rounds / fit wall
            "rows_rounds_per_s": int(GBDT_ROWS * 0.9) * GBDT_ROUNDS / fit_s,
            "train_rows_rounds_per_s": n_train * GBDT_ROUNDS / fit_s,
            "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
            "split": split}
        print("gbdt bench configuration: " + json.dumps(out["bench"]))
        require(len(features) == NYCTAXI_FEATURES and report["num_trees"]
                == GBDT_ROUNDS and math.isfinite(report["eval_rmse"]),
                f"gbdt fit: {report}")
        history = est.evals_result["eval_rmse"]
        require(history[-1] < history[0], f"eval rmse {history}")

        # predict on the eval frame: a plain routing of get_model()'s tables
        X_eval = est._feature_matrix(eval_ds.to_arrow())
        got = est.predict(eval_ds)
        want = plain_route(est.get_model(), X_eval)
        require(got.shape == (eval_ds.count(),) and np.array_equal(
            got, want), "gbdt predict differs from a plain routing")
        print(f"gbdt predict: {len(got)} eval rows equal a plain routing "
              f"of get_model()'s tables")

        # the same binned data for the turns and the CPU comparisons
        X, y, _ = est._materialize(train_ds, with_weight=True)
        eX, ey = est._materialize(eval_ds)
        edges = est.get_model().bin_edges
        out["turns"] = gbdt_turns(X, y, (eX, ey), edges)
        out["card_vs_cpu"] = gbdt_card_vs_cpu(X, y, eX, ey, edges)

        # the bridge: the example's torch loop on the card, then on the
        # CPU over the same batches (fresh bridges with the same seed
        # shuffle each epoch as the first did) from the same initial
        # weights, to tell the model's eval loss from the card's
        out["bridge"] = {}
        for where in ("cuda", "cpu"):
            train = to_torch_dataset(
                train_ds, feature_columns=features, label_column=LABEL,
                batch_size=BRIDGE_BATCH, shuffle=True)
            evaluate = to_torch_dataset(
                eval_ds, feature_columns=features, label_column=LABEL,
                batch_size=BRIDGE_BATCH)
            t0 = time.perf_counter()
            reports = train_loop(train, evaluate, len(features),
                                 BRIDGE_EPOCHS, 1e-3, torch.device(where),
                                 seed=SEED)
            out["bridge"][where] = {"epochs": reports,
                                    "wall_s": time.perf_counter() - t0}
            print(f"gbdt bridge torch loop on {where}: "
                  + json.dumps(out["bridge"][where]))
            require(reports[-1]["train_loss"] < reports[0]["train_loss"],
                    f"the bridge loop's loss did not fall on {where}: "
                    f"{reports}")
        bridge = {where: {k: [r[k] for r in out["bridge"][where]["epochs"]]
                          for k in ("train_loss", "eval_loss")}
                  for where in ("cuda", "cpu")}
        out["bridge"]["eval_loss_rises"] = {
            where: b["eval_loss"][-1] > b["eval_loss"][0]
            for where, b in bridge.items()}
        print(f"gbdt bridge card vs cpu, per epoch: {json.dumps(bridge)}; "
              f"eval loss rises: {json.dumps(out['bridge']['eval_loss_rises'])}")
        counts = launches(fa)
        print(f"gbdt launches of the flash kernels: {counts}")
        require(not any(counts.values()), f"gbdt phase launched {counts}")
    finally:
        clock.restore()
        raydp_tpu_torch.stop()
    left = [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]
    print(f"gbdt: after stop(), segments of the session left: {left}")
    require(not left, f"segments left after stop: {left}")
    out["example"] = gbdt_example(tmp)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"gbdt phase: {out['phase_s']:.3f} s")
    print("gbdt phase " + json.dumps(out))
    last = out["turns"]["graphed"][-1]
    steady = last["rounds_s"] / last["rounds"]

    def profile():
        return profile_gbdt_round(X, y, (eX, ey), edges, steady)

    return out, profile


# ---- phase 12: the headline examples ---------------------------------------

#: the stroke child's last line: its final losses and the first epoch's
STROKE_FINAL = (r"final: train_loss=([0-9.]+) eval_loss=([0-9.]+) \(first "
                r"epoch: train_loss=([0-9.]+)\)")
#: the stroke example on the card against the CPU: the same weights, f32
#: sums in other orders over 108 Adam steps; the child prints 4 decimals
STROKE_CPU_ATOL = 1e-3


def nyctaxi_example(phase8: dict) -> dict:
    """raydp_tpu_torch/examples/nyctaxi_mlp.py's ``main`` in this process
    at its defaults, with ``--trace``: each epoch's report, the steady rate
    beside phase 8's fit_on_frame, the wall split (the CSV's generation,
    the session's start, the ETL that fit_on_frame runs — read, preprocess,
    conversion — the fit, the trace, the dump and the stop), and the
    trace's flow events and actor lanes."""
    import os

    import raydp_tpu_torch
    from raydp_tpu_torch import metrics, profiler
    from raydp_tpu_torch.examples import generate_nyctaxi, nyctaxi_mlp
    from raydp_tpu_torch.train import TorchEstimator

    clock = CallClock()
    clock.wrap(generate_nyctaxi, "generate", "generate")
    clock.wrap(raydp_tpu_torch, "init", "init")
    clock.wrap(TorchEstimator, "fit", "fit")
    clock.wrap(TorchEstimator, "fit_on_frame", "fit_on_frame")
    clock.wrap(profiler, "collect_chrome_trace", "trace")
    clock.wrap(metrics, "dump", "dump")
    clock.wrap(raydp_tpu_torch, "stop", "stop")
    t0 = time.perf_counter()
    try:
        res = nyctaxi_mlp.main(["--trace"])
    finally:
        clock.restore()
    wall = time.perf_counter() - t0
    seconds = clock.take()
    history = res["history"]
    for r in history:
        print(f"example nyctaxi epoch {r['epoch']}: " + json.dumps(
            {k: (round(v, 6) if isinstance(v, float) else v)
             for k, v in r.items() if k != "epoch"}))
    trace = res["trace"]
    split = {"generate_s": seconds["generate"], "init_s": seconds["init"],
             "etl_s": seconds["fit_on_frame"] - seconds["fit"],
             "fit_s": seconds["fit"], "trace_s": seconds["trace"],
             "dump_s": seconds["dump"], "stop_s": seconds["stop"]}
    # the rest: writing the CSV, planning the preprocess and the split,
    # the schema read of feature_columns, the model, the prints
    split["rest_s"] = wall - sum(split.values())
    out = {"main_s": wall, "fit_on_frame_s": seconds["fit_on_frame"],
           # the epochs after the first, as fit_and_report's
           "split": split, "samples_per_s_steady": steady_rate(history[1:]),
           "phase8_samples_per_s_steady":
               phase8["nyctaxi"]["samples_per_s_steady"],
           "losses": [r["train_loss"] for r in history],
           "eval_losses": [r["eval_loss"] for r in history],
           "features": len(res["features"]),
           "trace": {"path": str(trace), "flow_events": trace.flow_events,
                     "actor_lanes": trace.actors,
                     "skipped_actors": trace.skipped_actors,
                     "bytes": os.path.getsize(trace)},
           "metrics_dump": {k: os.path.getsize(v)
                            for k, v in res["metrics_dump"].items()}}
    print(f"example nyctaxi: {out['samples_per_s_steady']:.1f} samples/s "
          f"steady (batch 1024), phase 8's fit_on_frame (batch {NYC_BATCH}) "
          f"in this call {out['phase8_samples_per_s_steady']:.1f}; wall "
          f"{wall:.3f} s, split " + json.dumps(
              {k: round(v, 4) for k, v in split.items()})
          + f"; loss {out['losses'][0]:.6f} -> {out['losses'][-1]:.6f}")
    print("example nyctaxi trace: " + json.dumps(out["trace"])
          + "; metrics dump bytes " + json.dumps(out["metrics_dump"]))
    require(len(history) == 5 and out["features"] == NYCTAXI_FEATURES,
            f"example nyctaxi: {len(history)} epochs, {out['features']} "
            "features")
    require(out["losses"][-1] < out["losses"][0],
            f"example nyctaxi: loss did not fall: {out['losses']}")
    require(out["trace"]["bytes"] > 0 and all(out["metrics_dump"].values()),
            "example nyctaxi: the trace or the metrics dump is empty")
    return out


def stroke_child(tmp: str, where: str) -> dict:
    """raydp_tpu_torch/examples/stroke_pipeline.py at its defaults through
    ``python -m raydp_tpu_torch.cli.submit``, as a child process training
    on ``where``: it exits 0 and its last line shows the train loss
    fell."""
    import os
    import re

    repo = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "raydp_tpu_torch.cli.submit",
           "--name", "stroke-submitted",
           os.path.join(repo, "raydp_tpu_torch", "examples",
                        "stroke_pipeline.py"), "--device", where]
    env = dict(os.environ, PYTHONPATH=repo, TMPDIR=tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        print(f"  child on {where}: {line}")
    require(proc.returncode == 0, f"the submitted stroke example on {where} "
            f"exited {proc.returncode}: {proc.stderr[-3000:]}")
    final = re.fullmatch(STROKE_FINAL, lines[-1])
    require(final is not None, f"the stroke child's last line: {lines[-1]}")
    train, evaluate, first = (float(g) for g in final.groups())
    out = {"exit": proc.returncode, "child_wall_s": wall,
           "train_loss": train, "eval_loss": evaluate,
           "first_train_loss": first}
    print(f"example stroke through submit on {where}: " + json.dumps(out))
    require(train < first, f"the stroke child's loss did not fall on "
            f"{where}: {out}")
    return out


def stroke_example(tmp: str) -> dict:
    """The stroke pipeline submitted twice, training on the card and on the
    CPU: both start from the same host-drawn weights, so their final
    losses agree within STROKE_CPU_ATOL."""
    out = {where: stroke_child(tmp, where) for where in ("cuda", "cpu")}
    diff = max(abs(out["cuda"][k] - out["cpu"][k])
               for k in ("first_train_loss", "train_loss", "eval_loss"))
    out["card_vs_cpu_max_abs_diff"] = diff
    print(f"example stroke card vs cpu: losses differ by at most {diff:.4f} "
          f"(limit {STROKE_CPU_ATOL})")
    require(diff <= STROKE_CPU_ATOL, f"the stroke example's losses on the "
            f"card and the CPU differ by {diff}")
    return out


def run_examples(fa, phase8: dict, tmp: str) -> dict:
    """Phase 12: the port's two headline examples on the card, NYCTaxi in
    this process and the stroke pipeline through rdt-submit-torch; neither
    launches a flash kernel."""
    t_phase = time.perf_counter()
    zero_launches(fa)
    out = {"nyctaxi": nyctaxi_example(phase8)}
    counts = launches(fa)
    print(f"example launches of the flash kernels: {counts}")
    require(not any(counts.values()), f"the examples launched {counts}")
    out["stroke"] = stroke_example(tmp)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"examples phase: {out['phase_s']:.3f} s")
    print("examples phase " + json.dumps(out))
    return out


# ---- phase 13: the gang ------------------------------------------------------

#: phase 13's rows, batch and epochs: the NYCTaxi example's defaults
GANG_ROWS, GANG_BATCH = 100_000, 1024
GANG_EPOCHS, GANG_RESUME_EPOCHS = 2, 4
#: on one card, where the two ranks of (c) and of phase 14 (e) share it
#: under gloo (every step eager, ≈ 2.7 and 6 s an epoch): the epochs they
#: run there, cut from the example's default 5 and GANG_RESUME_EPOCHS to
#: keep the default one-card run near 900 s with 13 (d)'s node agent
GLOO_EXAMPLE_EPOCHS, GLOO_RESUME_EPOCHS = 2, 3
#: (c): the 2-rank example against phase 12's single-process one, epoch 0's
#: train loss. The two visit the rows in different orders (phase 12's
#: resident fit permutes them with torch.randperm on the card, the gang
#: reads the engine's random_shuffle and permutes the batch order with
#: numpy), which the card read as 7.3e-5 of the loss in two runs (every
#: draw is seeded). Their eval losses are printed, not gated: the row order
#: alone moves them by tens of percent ((d)'s shuffled in-process fit).
GANG_EXAMPLE_RTOL = 1e-4
#: (d): the resumed 2-rank gang's train losses against an in-process fit on
#: the same rows in the same order, every epoch. Two ranks sum the gradient
#: and BatchNorm's statistics in another order than one process, and Adam
#: carries that: the card read 7.8e-5 over 4 epochs, the CPU 9.3e-4 by
#: epoch 3; a gang without its gradient all-reduce read 5e-2 or more on the
#: CPU. The eval losses are not held to the in-process fit: early in
#: training BatchNorm's running mean still lags the features' (momentum
#: 0.99 over 87 steps an epoch), so the eval loss is a difference of large
#: terms and the same rounding moved it by 11-340 % on the CPU
GANG_RESUME_RTOL = 2e-3
#: (d): the gang's last eval loss (every test row once, the ragged tail
#: padded and masked, summed across the ranks) against the smooth L1 of the
#: driver's predict with the state the gang returned: the same model on the
#: same rows (the CPU read 1.2e-8; a gang whose BatchNorm statistics stayed
#: per rank read 0.12, one without its gradient all-reduce 0.31)
GANG_EVAL_RTOL = 1e-4


def gang_runner(device: str = "cuda") -> dict:
    """(a) The runner: a 2-rank plain job runs, stops and restarts; a
    1-rank torch_distributed job on the card (one card a rank: nccl)
    all-reduces a CUDA tensor; a 2-rank job whose ranks share the card
    (gloo) all-reduces CUDA tensors to [3.0, 3.0]. Each job's start wall,
    each backend, and the card's free memory before, while the two ranks
    hold their contexts, and after."""
    from raydp_tpu_torch.spmd import create_spmd_job

    def started(job) -> float:
        t0 = time.perf_counter()
        job.start()
        return time.perf_counter() - t0

    out = {}
    job = create_spmd_job("smoke-plain", 2, timeout=120)
    starts = []
    for _ in range(2):
        starts.append(started(job))
        try:
            got = job.run(lambda ctx: ctx.rank * 10, timeout=120)
        finally:
            job.stop()
        require(got == [0, 10], f"gang plain job: {got}")
    out["plain_start_s"] = starts

    def all_reduce(ctx, device=device):
        import torch
        import torch.distributed as dist

        x = torch.full((2,), float(ctx.rank + 1), device=device)
        dist.all_reduce(x)
        free, total = torch.cuda.mem_get_info()
        return {"sum": x.tolist(), "backend": dist.get_backend(),
                "card": torch.cuda.get_device_name(0),
                "free_mib": free / 2 ** 20}

    for label, world, gpus in (("nccl", 1, 1), ("gloo_shared", 2, 0)):
        before = torch.cuda.mem_get_info()[0] / 2 ** 20
        job = create_spmd_job(f"smoke-{label}", world, torch_distributed=True,
                              gpus_per_process=gpus, timeout=180)
        start_s = started(job)
        try:
            got = job.run(all_reduce, timeout=180)
            during = torch.cuda.mem_get_info()[0] / 2 ** 20
        finally:
            job.stop()
        time.sleep(1.0)  # the ranks' contexts go with their processes
        after = torch.cuda.mem_get_info()[0] / 2 ** 20
        want = float(world * (world + 1) // 2)
        out[label] = {"start_s": start_s, "backend": job.backend,
                      "ranks": got, "free_mib_before": before,
                      "free_mib_during": during, "free_mib_after": after,
                      "mib_per_rank_context": (before - during) / world}
        print(f"gang runner {label}: {world} rank(s), backend "
              f"{[g['backend'] for g in got]}, all_reduce "
              f"{[g['sum'] for g in got]}, start {start_s:.3f} s; card free "
              f"MiB before {before:.0f}, with the ranks {during:.0f}, after "
              f"{after:.0f} ({out[label]['mib_per_rank_context']:.0f} MiB a "
              f"rank)")
        require(all(g["backend"] == job.backend and g["sum"] == [want] * 2
                    for g in got), f"gang runner {label}: {got}")
    require(out["nccl"]["backend"] == "nccl"
            and out["gloo_shared"]["backend"] == "gloo",
            f"gang runner backends: {out}")
    print(f"gang runner plain: starts {[round(s, 3) for s in starts]} s")
    return out


def layout(backend: str) -> str:
    """How a gang's ranks sat, by the backend it reported (the rule of
    ``spmd.job.gang_backend``)."""
    return {"gloo": "sharing the card (gloo, every step eager)",
            "nccl": "one card each (nccl)"}[backend]


def gang_report(label: str, history: list, dispatch=None) -> None:
    for r in history:
        print(f"{label} epoch {r['epoch']}: " + json.dumps(
            {k: (round(v, 6) if isinstance(v, float) else v)
             for k, v in r.items() if k != "epoch"}))
    if dispatch is not None:
        print(f"{label} dispatch: {dispatch}")


def gang_nccl(train, test, features) -> dict:
    """(b) NCCL, graphed: fit_gang(num_workers=1), the rank on its own card,
    steps_per_dispatch=CHAIN, unshuffled, against the in-process streaming
    fit with the same k and rows: per-epoch losses within SAME_PATH_RTOL."""
    from raydp_tpu_torch.examples.nyctaxi_mlp import build_estimator
    from raydp_tpu_torch.spmd.job import SPMDJob

    def estimator():
        est = build_estimator(features, GANG_BATCH, GANG_EPOCHS, None)
        est.shuffle, est.steps_per_dispatch = False, CHAIN
        return est

    with device_cache(False):
        t0 = time.perf_counter()
        single = estimator().fit(train, test)
        single_s = time.perf_counter() - t0
        clock = CallClock()
        clock.wrap(SPMDJob, "start", "start")
        t0 = time.perf_counter()
        try:
            gang = estimator().fit_gang(train, test, num_workers=1)
        finally:
            clock.restore()
        gang_s = time.perf_counter() - t0
    gang_report("gang nccl k=8", gang.history, gang.dispatch)
    worst = max(abs(a[k] - b[k]) / abs(b[k])
                for a, b in zip(gang.history, single.history)
                for k in ("train_loss", "eval_loss"))
    out = {"start_s": clock.take()["start"], "fit_gang_s": gang_s,
           "fit_s": single_s,
           "replays": [d["graph_replays"] for d in gang.dispatch],
           "samples_per_s_steady": steady_rate(gang.history[1:]),
           "single_samples_per_s_steady": steady_rate(single.history[1:]),
           "losses": losses_of(gang), "single_losses": losses_of(single),
           "eval_losses": [r["eval_loss"] for r in gang.history],
           "max_rel_diff": worst}
    print(f"gang nccl: 1 rank, graph replays {out['replays']} (the "
          f"in-process fit {[d['graph_replays'] for d in single.dispatch]}); "
          f"{out['samples_per_s_steady']:.1f} vs in-process "
          f"{out['single_samples_per_s_steady']:.1f} samples/s steady; gang "
          f"start {out['start_s']:.3f} s of fit_gang {gang_s:.3f} s (fit "
          f"{single_s:.3f} s); train and eval losses differ by at most "
          f"{worst:.3e} of themselves (limit {SAME_PATH_RTOL})")
    require(all(r > 0 for r in out["replays"]),
            f"gang nccl: no graph replayed: {gang.dispatch}")
    require(worst <= SAME_PATH_RTOL, f"gang nccl: {gang.history} vs "
            f"{single.history}")
    return out


def gang_example(phase12: dict) -> dict:
    """(c) nyctaxi_mlp.main(["--num-workers", "2"]) at its defaults (on
    one card ``--epochs GLOO_EXAMPLE_EPOCHS``): two ranks sharing the card
    under gloo, every step eager, against phase 12's single-process run on
    the same rows (the same seeded CSV): every epoch of both, the steady
    rate, the wall split and the share of a step spent in all_reduce."""
    from raydp_tpu_torch.examples import nyctaxi_mlp
    from raydp_tpu_torch.spmd.job import SPMDJob

    clock = CallClock()
    clock.wrap(SPMDJob, "start", "start")
    clock.wrap(SPMDJob, "run", "run")
    clock.wrap(SPMDJob, "stop", "stop")
    epochs = GLOO_EXAMPLE_EPOCHS if torch.cuda.device_count() < 2 else 5
    t0 = time.perf_counter()
    try:
        res = nyctaxi_mlp.main(["--num-workers", "2", "--epochs",
                                str(epochs)])
    finally:
        clock.restore()
    wall = time.perf_counter() - t0
    seconds = clock.take()
    # the job fit_gang started: its backend follows the cards
    backend = clock.last_args["start"][0].backend
    history = res["history"]
    gang_report("gang example", history)
    single = {"losses": phase12["nyctaxi"]["losses"],
              "eval_losses": phase12["nyctaxi"]["eval_losses"]}
    for r, a, e in zip(history, single["losses"], single["eval_losses"]):
        print(f"gang example epoch {r['epoch']}: 2 ranks train "
              f"{r['train_loss']:.6f} eval {r['eval_loss']:.6f}; phase 12's "
              f"single process train {a:.6f} eval {e:.6f}")
    steady = history[1:]
    epochs_s = sum(r["epoch_time_s"] for r in history)
    out = {"main_s": wall, "start_s": seconds["start"],
           "run_s": seconds["run"], "stop_s": seconds["stop"],
           "store_read_s": history[0]["decode_time_s"],
           "epochs_s": epochs_s,
           "samples_per_s_steady": steady_rate(steady),
           "single_samples_per_s_steady":
               phase12["nyctaxi"]["samples_per_s_steady"],
           "allreduce_share": sum(r["allreduce_time_s"] for r in steady)
           / sum(r["dispatch_time_s"] for r in steady),
           "losses": [r["train_loss"] for r in history],
           "eval_losses": [r["eval_loss"] for r in history],
           "epoch0_train_rel_diff": abs(history[0]["train_loss"]
                                        - single["losses"][0])
           / abs(single["losses"][0]),
           "epoch0_eval_rel_diff": abs(history[0]["eval_loss"]
                                       - single["eval_losses"][0])
           / abs(single["eval_losses"][0])}
    print(f"gang example: 2 ranks, {layout(backend)}, "
          f"{out['samples_per_s_steady']:.1f} samples/s steady vs phase 12's "
          f"single process {out['single_samples_per_s_steady']:.1f}; wall "
          f"{wall:.3f} s: gang start {out['start_s']:.3f} s, ranks' store "
          f"reads (epoch 0's decode) {out['store_read_s']:.3f} s, epochs "
          f"{epochs_s:.3f} s, the ranks' whole run {out['run_s']:.3f} s, stop "
          f"{out['stop_s']:.3f} s; host wall in all_reduce calls "
          f"{out['allreduce_share']:.1%} of a steady step's ({COMM_WALL}); "
          f"epoch 0 train loss differs by "
          f"{out['epoch0_train_rel_diff']:.3e} (limit {GANG_EXAMPLE_RTOL}), "
          f"eval by {out['epoch0_eval_rel_diff']:.3e} (not gated)")
    require(len(history) == epochs and out["losses"][-1] < out["losses"][0],
            f"gang example: {out['losses']}")
    require(all(math.isfinite(v) for v in out["eval_losses"]),
            f"gang example eval: {out['eval_losses']}")
    require(out["epoch0_train_rel_diff"] <= GANG_EXAMPLE_RTOL,
            f"gang example epoch 0 vs phase 12: {out}")
    return out


class NodeAgent:
    """A node agent on this host, joined to this process's runtime head as
    a node of its own (``python -m raydp_tpu_torch.runtime.node_agent
    --head <url> --cpus 4``, in a session of its own, as
    ``tests/test_node_agent.py`` starts one). With ``card`` it holds that
    one card: it runs under ``CUDA_VISIBLE_DEVICES=<card>`` with
    ``--resource GPU=1``."""

    def __init__(self, rt, log_path: str, card: Optional[str] = None):
        import os

        self.rt = rt
        env = dict(os.environ)
        here = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (here, env.get("PYTHONPATH")) if p)
        argv = [sys.executable, "-m", "raydp_tpu_torch.runtime.node_agent",
                "--head", rt.server.url, "--cpus", "4"]
        if card is not None:
            env["CUDA_VISIBLE_DEVICES"] = card
            argv += ["--resource", "GPU=1"]
        before = set(rt.node_agents)
        t0 = time.perf_counter()
        with open(log_path, "ab") as log:
            self.proc = subprocess.Popen(argv, env=env, stdout=log,
                                         stderr=subprocess.STDOUT,
                                         start_new_session=True)
        self.node_id = None
        deadline = time.monotonic() + 60
        while self.node_id is None and time.monotonic() < deadline \
                and self.proc.poll() is None:
            joined = set(rt.node_agents) - before
            self.node_id = joined.pop() if joined else None
            time.sleep(0.05)
        self.start_s = time.perf_counter() - t0
        self.card = card
        if self.node_id is None:
            self.stop()
            require(False, f"the node agent never joined (see {log_path})")

    @property
    def pid(self) -> int:
        return self.proc.pid

    def spread_from_head(self) -> None:
        """Make the next SPREAD group's bundle 0 land on this process's
        node and bundle 1 on the agent's: the resource manager hands
        bundles to the alive nodes round-robin, so draw empty allocations
        until one lands on the agent's node."""
        rm = self.rt.resource_manager
        nodes = [n.node_id for n in rm.nodes()]
        require(len(nodes) == 2 and self.node_id in nodes,
                f"SPREAD over the head's node and the agent's: {nodes}")
        for _ in range(2):
            if rm.allocate({}) == self.node_id:
                return
        require(False, "no empty allocation landed on the agent's node")

    def stop(self) -> None:
        """Kill the agent's process group and report its node dead to the
        head (nothing of the agent's is left for the head's supervision to
        find dead), so that no later placement picks the node."""
        import os
        import signal

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            self.proc.kill()
        self.proc.wait(timeout=30)
        if self.node_id is not None:
            self.rt.remove_node(self.node_id)
            alive = [n.node_id for n in self.rt.resource_manager.nodes()]
            require(self.node_id not in alive,
                    f"the killed agent's node {self.node_id} is still "
                    f"placeable: {alive}")


def last_card(cards: int) -> str:
    """The last of this process's ``cards`` cards, by the name its own
    ``CUDA_VISIBLE_DEVICES`` gives it (``"3"`` of four without one)."""
    import os

    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    return visible.split(",")[cards - 1] if visible else str(cards - 1)


def rank_parents(records_dir: str) -> dict:
    """``{rank: [(pid, ppid, card uuid), ...]}``, one entry a rank process,
    from the files :func:`record_rank` wrote."""
    import os

    out: dict = {}
    for name in sorted(os.listdir(records_dir)):
        with open(os.path.join(records_dir, name)) as f:
            rec = json.load(f)
        out.setdefault(rec["rank"], []).append(
            (rec["pid"], rec["ppid"], rec["uuid"]))
    return out


def record_rank(records_dir: str):
    """A fit callback that writes, in every rank once an epoch, its rank,
    pid, parent's pid and its card's UUID (None on the CPU) into
    ``records_dir`` — one file a rank process."""

    def record(report):
        import json as json_
        import os

        import torch as torch_
        import torch.distributed as dist

        rank = dist.get_rank()
        uuid = (str(torch_.cuda.get_device_properties(0).uuid)
                if torch_.cuda.is_available() else None)
        path = os.path.join(records_dir, f"rank{rank}-pid{os.getpid()}")
        with open(path, "w") as f:
            json_.dump({"rank": rank, "pid": os.getpid(),
                        "ppid": os.getppid(), "uuid": uuid}, f)

    return record


def gang_resume(train, test, features, tmp: str, device: str = "cuda"
                ) -> dict:
    """(d) Crash and resume, held against one process: rank 1 exits at
    epoch 1, once; the gang (two ranks on the card, gloo) restarts with
    max_retries=1 and resumes from rank 0's checkpoint. Rank 1 runs under a
    node agent on this host (SPREAD placement over the head's node and the
    agent's): the agent is rank 1's parent, and the crashed rank is spawned
    again through it. On more than one card the gang takes a card a rank
    (nccl), and the agent holds the last card (``CUDA_VISIBLE_DEVICES`` of
    it, ``--resource GPU=1``), so rank 1 runs on it. The history is
    [0, 1, 2, 3], the checkpoint's sidecar holds the pre-crash epochs, and
    the gang's unshuffled train losses equal an in-process fit's on the
    same rows in the same order within GANG_RESUME_RTOL (the global batch's
    gradient and BatchNorm statistics, the model and the optimizer's
    moments restored). The eval losses of the two are printed: they drift
    apart far faster (GANG_RESUME_RTOL's note), as a shuffled in-process
    fit's do, which shows what the row order alone does to the losses (the
    spread between (c)'s two runs). The gang's last eval loss, over every
    test row once, equals the smooth L1 of the driver's ``predict`` with
    the state the gang returned within GANG_EVAL_RTOL."""
    import os

    import numpy as np

    from raydp_tpu_torch.examples.nyctaxi_features import LABEL
    from raydp_tpu_torch.examples.nyctaxi_mlp import build_estimator
    from raydp_tpu_torch.spmd.job import SPMDJob
    from raydp_tpu_torch.train import checkpoint as ckpt

    from raydp_tpu_torch.runtime import get_runtime

    flag = os.path.join(tmp, "gang-crashed-once")
    ckpt_dir = os.path.join(tmp, "gang-resume")
    records = os.path.join(tmp, "gang-resume-ranks")
    os.makedirs(records)

    def crash_once(report):
        import torch.distributed as dist

        if (report["epoch"] == 1 and dist.get_rank() == 1
                and not os.path.exists(flag)):
            open(flag, "w").close()
            os._exit(1)

    def estimator(callbacks=(), ckpt_dir=None, shuffle=False):
        est = build_estimator(features, GANG_BATCH, GANG_RESUME_EPOCHS,
                              device)
        est.shuffle, est.callbacks, est.checkpoint_dir = \
            shuffle, list(callbacks), ckpt_dir
        return est

    def rel_diffs(a, b) -> dict:
        return {k: [abs(x[k] - y[k]) / abs(y[k])
                    for x, y in zip(a.history, b.history)]
                for k in ("train_loss", "eval_loss")}

    cards = torch.cuda.device_count() if device == "cuda" else 0
    with device_cache(False):
        single = estimator().fit(train, test)
        reordered = estimator(shuffle=True).fit(train, test)
        agent = NodeAgent(get_runtime(), os.path.join(tmp, "agent-d.log"),
                          card=last_card(cards) if cards > 1 else None)
        try:
            agent.spread_from_head()
            clock = CallClock()
            clock.wrap(SPMDJob, "start", "start")
            t0 = time.perf_counter()
            est = estimator([record_rank(records), crash_once], ckpt_dir)
            try:
                gang = est.fit_gang(train, test, num_workers=2,
                                    max_retries=1)
            finally:
                clock.restore()
            wall = time.perf_counter() - t0
        finally:
            agent.stop()
    gang_report("gang resume", gang.history, gang.dispatch)
    parents = rank_parents(records)
    rank1 = parents.get(1, [])
    epochs = [r["epoch"] for r in gang.history]
    extra = ckpt.restore_extra(ckpt_dir)
    diffs, order = rel_diffs(gang, single), rel_diffs(reordered, single)
    worst = max(diffs["train_loss"])
    d = np.abs(est.predict(test).astype(np.float64)
               - test.to_pandas()[LABEL].to_numpy(np.float64))
    predicted = float(np.mean(np.where(d < 1.0, 0.5 * d * d, d - 0.5)))
    eval_vs_predict = abs(gang.history[-1]["eval_loss"] - predicted) \
        / predicted
    out = {"history_epochs": epochs, "crashed": os.path.exists(flag),
           "restored_epochs": [r["epoch"] for r in extra["history"]]
           if extra else [],
           "second_gang_epochs": [d["epoch"] for d in gang.dispatch],
           "fit_gang_s": wall, "starts_s": clock.take()["start"],
           "losses": losses_of(gang),
           "eval_losses": [r["eval_loss"] for r in gang.history],
           "single_losses": losses_of(single),
           "single_eval_losses": [r["eval_loss"] for r in single.history],
           "reordered_eval_losses": [r["eval_loss"]
                                     for r in reordered.history],
           "rel_diffs": diffs, "max_rel_diff": worst,
           "order_rel_diffs": order, "predict_eval_loss": predicted,
           "eval_vs_predict_rel_diff": eval_vs_predict,
           "agent": {"pid": agent.pid, "card": agent.card,
                     "start_s": agent.start_s,
                     "rank_parents": {str(r): v
                                      for r, v in parents.items()}}}
    print(f"gang resume: node agent pid {agent.pid} joined in "
          f"{agent.start_s:.3f} s (card {agent.card}); rank 1's processes "
          f"(pid, parent, card) {rank1}, rank 0's {parents.get(0, [])}; "
          f"this process {os.getpid()}")
    print(f"gang resume: history {epochs}, the second gang ran epochs "
          f"{out['second_gang_epochs']}, checkpoint sidecar epochs "
          f"{out['restored_epochs']}; fit_gang {wall:.3f} s with two gang "
          f"starts {out['starts_s']:.3f} s; against the in-process fit "
          f"(same rows, same order) the train losses differ by "
          f"{[f'{v:.3e}' for v in diffs['train_loss']]}, the eval losses by "
          f"{[f'{v:.3e}' for v in diffs['eval_loss']]} of themselves (train "
          f"limit {GANG_RESUME_RTOL}, eval printed); a shuffled in-process "
          f"fit's differ by {[f'{v:.3e}' for v in order['train_loss']]} and "
          f"{[f'{v:.3e}' for v in order['eval_loss']]} (the row order "
          f"alone, printed); the last eval loss "
          f"{gang.history[-1]['eval_loss']:.6f} vs the driver's predict "
          f"{predicted:.6f}: {eval_vs_predict:.3e} of it (limit "
          f"{GANG_EVAL_RTOL})")
    require(out["crashed"], "gang resume: the injected crash never fired")
    require(len(rank1) == 2 and len({p for p, _, _ in rank1}) == 2
            and all(pp == agent.pid for _, pp, _ in rank1),
            f"gang resume: rank 1 and its respawn are not the agent's "
            f"children: {out['agent']}")
    require(parents.get(0) and all(pp == os.getpid()
                                   for _, pp, _ in parents[0]),
            f"gang resume: rank 0 is not this process's child: "
            f"{out['agent']}")
    require(epochs == list(range(GANG_RESUME_EPOCHS)) and out["restored_epochs"],
            f"gang resume: {out}")
    require(worst <= GANG_RESUME_RTOL, f"gang resume: {out}")
    require(eval_vs_predict <= GANG_EVAL_RTOL, f"gang resume eval: {out}")
    return out


@contextlib.contextmanager
def gang_frames(tmp: str):
    """(b) and (d)'s rows: GANG_ROWS NYCTaxi rows through a session's ETL,
    split 0.9/0.1; yields ``(train, test, features)`` and stops the
    session after the block."""
    import os

    import raydp_tpu_torch
    from raydp_tpu_torch.data import from_frame
    from raydp_tpu_torch.examples.generate_nyctaxi import generate
    from raydp_tpu_torch.examples.nyctaxi_features import (
        feature_columns, nyc_taxi_preprocess,
    )

    csv = os.path.join(tmp, "gang-nyctaxi.csv")
    generate(GANG_ROWS).to_csv(csv, index=False)
    session = raydp_tpu_torch.init("smoke-gang", **ETL_SESSION)
    try:
        frame = nyc_taxi_preprocess(
            session.read.csv(csv, num_partitions=ETL_PARTITIONS))
        train_df, test_df = frame.randomSplit([0.9, 0.1], seed=0)
        yield from_frame(train_df), from_frame(test_df), \
            feature_columns(frame)
    finally:
        raydp_tpu_torch.stop()


def gang_resume_on_cpu() -> dict:
    """(d) on the host's CPU, two ranks under gloo, with every limit
    lifted: the readings GANG_RESUME_RTOL and GANG_EVAL_RTOL were set
    from. Not part of a chip run; run it as ``python3 -c "import
    chip_smoke; chip_smoke.gang_resume_on_cpu()"``."""
    global GANG_RESUME_RTOL, GANG_EVAL_RTOL

    GANG_RESUME_RTOL = GANG_EVAL_RTOL = math.inf
    with tempfile.TemporaryDirectory(prefix="gang-cpu-") as tmp, \
            gang_frames(tmp) as (train, test, features):
        return gang_resume(train, test, features, tmp, device="cpu")


def run_gang(fa, phase12: dict, tmp: str, then):
    """Phase 13: the gang runner and gang training on the card; no flash
    launch. ``then(phase13, frames)`` (phase 14) runs on (b) and (d)'s
    frames before their session stops; returns phase 13's numbers and
    what ``then`` returned."""
    t_phase = time.perf_counter()
    zero_launches(fa)
    out = {"runner": gang_runner(), "example": gang_example(phase12)}
    with gang_frames(tmp) as frames:
        train, test, features = frames
        out["nccl"] = gang_nccl(train, test, features)
        out["resume"] = gang_resume(train, test, features, tmp)
        counts = launches(fa)
        print(f"gang launches of the flash kernels: {counts}")
        require(not any(counts.values()), f"the gang launched {counts}")
        out["phase_s"] = time.perf_counter() - t_phase
        print(f"gang phase: {out['phase_s']:.3f} s")
        print("gang " + json.dumps(out))
        free_memory()
        return out, then(out, frames)


# ---- phase 14: the sharding plane --------------------------------------------

#: (b): each rank's parameters, buffers and Adam moments against the whole
#: state's: fsdp=2 halves every kernel, the biases and BatchNorm's
#: parameters and buffers stay whole (0.517 of the state by the shapes)
SHARD_BYTES_LIMIT = 0.55
#: (c): the expert-sharded DLRM's train losses against the in-process fit,
#: the reference test's rtol (test_gang_expert_sharded_dlrm)
SHARD_DLRM_RTOL = 5e-4
#: (c): one row more than phase 6's tables: the reference refuses an
#: uneven shard, and 1,001 rows do not split over expert=2
SHARD_DLRM_VOCAB, SHARD_DLRM_EPOCHS = 1002, 2
#: (d): the tensor-parallel LM at full width, cut to 2 layers and
#: T = 2048 (gloo carries its activations through the host); one SGD step
TP_LAYERS, TP_SEQ, TP_LR = 2, 2048, 1e-1
#: (d): the loss of the split step against the replicated one; the
#: updated parameters may differ from the replicated step's by up to twice
#: what bf16 itself moves that step from f32 (measured in the run): the
#: two bf16 steps round at other points, and their errors against f32 add
#: (√2 for independent errors, with margin), as DENSE_REL_TOL_F32's note
#: reasons for flash against dense
TP_LOSS_RTOL, TP_PARAM_BF16_STEPS = 1e-3, 2.0


def rank_report(label: str, result, replicated_bytes: int) -> list:
    """Each rank's bytes against the whole state's, printed."""
    shares = []
    for r, rank in enumerate(result.ranks):
        share = rank["param_bytes"] / replicated_bytes
        shares.append(share)
        print(f"{label} rank {r}: parameters, buffers and optimizer state "
              f"{rank['param_bytes']} bytes of the whole state's "
              f"{replicated_bytes} ({share:.3f}); torch.cuda.memory_allocated "
              f"{rank['memory_allocated']} bytes")
    return shares


#: what a rank's host wall in collective calls measures
COMM_WALL = "their time under gloo, their enqueue under nccl"


def collective_share(history: list) -> float:
    """The share of the steady epochs' dispatch wall the ranks' host spent
    in collective calls: the collectives' time under gloo, which runs every
    one on the host; under nccl only their enqueue (phase 16 reads the
    nccl kernels' share from a device trace instead)."""
    steady = history[1:] or history
    return sum(r["allreduce_time_s"] for r in steady) \
        / sum(r["dispatch_time_s"] for r in steady)


def smooth_l1_of(est, test) -> float:
    """The smooth L1 of the driver's predict over ``test``."""
    from raydp_tpu_torch.examples.nyctaxi_features import LABEL

    d = np.abs(est.predict(test).astype(np.float64)
               - test.to_pandas()[LABEL].to_numpy(np.float64))
    return float(np.mean(np.where(d < 1.0, 0.5 * d * d, d - 0.5)))


def shard_world1(train, test, features, phase13: dict) -> dict:
    """(a) The world-1 mesh: phase 13 (b)'s 1-rank nccl gang with
    ``mesh_spec=MeshSpec()``: graphs replayed, losses bitwise (b)'s."""
    from raydp_tpu_torch.examples.nyctaxi_mlp import build_estimator
    from raydp_tpu_torch.parallel import MeshSpec

    est = build_estimator(features, GANG_BATCH, GANG_EPOCHS, None,
                          mesh_spec=MeshSpec())
    est.shuffle, est.steps_per_dispatch = False, CHAIN
    with device_cache(False):
        t0 = time.perf_counter()
        gang = est.fit_gang(train, test, num_workers=1)
        wall = time.perf_counter() - t0
    gang_report("shard world-1", gang.history, gang.dispatch)
    nccl = phase13["nccl"]
    out = {"replays": [d["graph_replays"] for d in gang.dispatch],
           "losses": losses_of(gang),
           "eval_losses": [r["eval_loss"] for r in gang.history],
           "fit_gang_s": wall,
           "bitwise": losses_of(gang) == nccl["losses"]
           and [r["eval_loss"] for r in gang.history] == nccl["eval_losses"]}
    print(f"shard world-1: mesh_spec=MeshSpec() on 1 nccl rank, graph "
          f"replays {out['replays']} (must be > 0); train and eval losses "
          f"bitwise phase 13 (b)'s: {out['bitwise']}; fit_gang {wall:.3f} s")
    require(all(r > 0 for r in out["replays"]),
            f"shard world-1: no graph replayed: {gang.dispatch}")
    require(out["bitwise"], f"shard world-1: {out} vs {nccl}")
    return out


def shard_fsdp(train, test, features, phase13: dict) -> dict:
    """(b) fsdp=2: NYCTaxiModel at full width on two ranks sharing the card
    (gloo), unshuffled, against phase 13 (d)'s in-process fit on the same
    rows in the same order; each rank's bytes; the gathered state's
    predict against the last eval."""
    from raydp_tpu_torch.examples.nyctaxi_mlp import build_estimator
    from raydp_tpu_torch.parallel import addressable_nbytes
    from raydp_tpu_torch.spmd.job import SPMDJob

    est = build_estimator(features, GANG_BATCH, GANG_EPOCHS, None,
                          mesh_spec=dict(fsdp=2))
    est.shuffle = False
    clock = CallClock()
    clock.wrap(SPMDJob, "start", "start")
    with device_cache(False):
        t0 = time.perf_counter()
        try:
            gang = est.fit_gang(train, test, num_workers=2)
        finally:
            clock.restore()
        wall = time.perf_counter() - t0
    gang_report("shard fsdp=2", gang.history, gang.dispatch)
    state = est.get_state()
    whole = addressable_nbytes((state.model, state.optimizer))
    shares = rank_report("shard fsdp=2", gang, whole)
    single = phase13["resume"]["single_losses"][:GANG_EPOCHS]
    diffs = [abs(a - b) / abs(b) for a, b in zip(losses_of(gang), single)]
    predicted = smooth_l1_of(est, test)
    eval_vs_predict = abs(gang.history[-1]["eval_loss"] - predicted) \
        / predicted
    out = {"fit_gang_s": wall, "start_s": clock.take()["start"],
           "samples_per_s_steady": steady_rate(gang.history[1:]),
           "collective_share": collective_share(gang.history),
           "losses": losses_of(gang), "single_losses": single,
           "rel_diffs": diffs, "byte_shares": shares,
           "whole_state_bytes": whole,
           "ranks": [{k: r[k] for k in ("param_bytes", "memory_allocated")}
                     for r in gang.ranks],
           "specs": {k: v for k, v in state.specs.items()
                     if k.endswith("kernel")},
           "eval_vs_predict_rel_diff": eval_vs_predict}
    print(f"shard fsdp=2: 2 ranks, {layout(gang.ranks[0]['backend'])}, "
          f"{out['samples_per_s_steady']:.1f} samples/s steady, host wall in "
          f"collective calls {out['collective_share']:.1%} of a steady "
          f"epoch's dispatch ({COMM_WALL}); gang "
          f"start {out['start_s']:.3f} s of fit_gang {wall:.3f} s; kernel "
          f"specs {out['specs']}; train losses differ from the in-process "
          f"fit's by {[f'{v:.3e}' for v in diffs]} (limit "
          f"{GANG_RESUME_RTOL}); rank bytes {[f'{v:.3f}' for v in shares]} "
          f"of the whole state (limit {SHARD_BYTES_LIMIT}); the last eval "
          f"loss vs the gathered state's predict: {eval_vs_predict:.3e} "
          f"(limit {GANG_EVAL_RTOL})")
    require(max(diffs) <= GANG_RESUME_RTOL, f"shard fsdp=2: {out}")
    require(len(shares) == 2 and max(shares) <= SHARD_BYTES_LIMIT,
            f"shard fsdp=2 bytes: {out}")
    require(eval_vs_predict <= GANG_EVAL_RTOL, f"shard fsdp=2 eval: {out}")
    return out


def shard_dlrm() -> dict:
    """(c) expert=2: DLRM at bench widths, 26 tables of 1,002 rows split by
    rows over two ranks sharing the card, unshuffled, against the
    in-process fit of the same rows in the same order."""
    from raydp_tpu_torch.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu_torch.models import dlrm_param_rules
    from raydp_tpu_torch.runtime.object_store import get_client
    from raydp_tpu_torch.spmd.job import SPMDJob

    tables = criteo_tables(DLRM_ROWS, DLRM_BLOCKS, SEED)
    refs = get_client().put_arrow_many(tables)
    ds = DistributedDataset([BlockMeta(num_rows=t.num_rows, ref=r)
                             for t, r in zip(tables, refs)], tables[0].schema)
    model = dlrm_model(SHARD_DLRM_VOCAB)
    with device_cache(False):
        t0 = time.perf_counter()
        single = dlrm_estimator(model, SHARD_DLRM_EPOCHS, [],
                                shuffle=False).fit(ds)
        single_s = time.perf_counter() - t0
        est = dlrm_estimator(model, SHARD_DLRM_EPOCHS, [], shuffle=False,
                             mesh_spec=dict(expert=2),
                             param_rules=dlrm_param_rules("expert"))
        clock = CallClock()
        clock.wrap(SPMDJob, "start", "start")
        t0 = time.perf_counter()
        try:
            gang = est.fit_gang(ds, num_workers=2)
        finally:
            clock.restore()
        wall = time.perf_counter() - t0
    gang_report("shard dlrm expert=2", gang.history, gang.dispatch)
    state = est.get_state()
    from raydp_tpu_torch.parallel import addressable_nbytes

    shares = rank_report("shard dlrm expert=2", gang,
                         addressable_nbytes((state.model, state.optimizer)))
    rows = sorted({r["local_shapes"][f"embedding_{i}.embedding"][0]
                   for r in gang.ranks for i in range(len(DLRM_CATS))})
    diffs = [abs(a - b) / abs(b) for a, b in zip(losses_of(gang),
                                                  losses_of(single))]
    out = {"fit_gang_s": wall, "fit_s": single_s,
           "start_s": clock.take()["start"],
           "samples_per_s_steady": steady_rate(gang.history[1:]),
           "single_samples_per_s_steady": steady_rate(single.history[1:]),
           "collective_share": collective_share(gang.history),
           "losses": losses_of(gang), "single_losses": losses_of(single),
           "rel_diffs": diffs, "table_rows_a_rank": rows,
           "byte_shares": shares}
    print(f"shard dlrm expert=2: every rank holds {rows} rows of every "
          f"table; {out['samples_per_s_steady']:.1f} samples/s steady vs "
          f"in-process {out['single_samples_per_s_steady']:.1f}; "
          f"host wall in collective calls {out['collective_share']:.1%} of a "
          f"steady epoch's dispatch ({COMM_WALL}); gang start "
          f"{out['start_s']:.3f} s of fit_gang "
          f"{wall:.3f} s; train losses differ by "
          f"{[f'{v:.3e}' for v in diffs]} (limit {SHARD_DLRM_RTOL})")
    require(rows == [SHARD_DLRM_VOCAB // 2], f"shard dlrm rows: {out}")
    require(max(diffs) <= SHARD_DLRM_RTOL, f"shard dlrm: {out}")
    return out


def tp_rank(ctx) -> dict:
    """(d) in one rank of the 2-rank job: rank 0 first takes the replicated
    bf16 step and, to measure bf16's own distance, the same step in f32
    (dense attention); then both ranks take the tensor=2 step, counting the
    flash launches and the heads each attention call saw."""
    import torch

    from raydp_tpu_torch import resolve_device
    from raydp_tpu_torch.models import (
        TransformerLM, lm_loss, transformer_param_rules,
    )
    from raydp_tpu_torch.models import transformer as tmod
    from raydp_tpu_torch.ops import flash_attention as fa
    from raydp_tpu_torch.parallel import ShardedModule, make_mesh

    device = resolve_device()

    def model(dtype, attention):
        return TransformerLM(VOCAB, dim=DIM, num_heads=HEADS,
                             num_layers=TP_LAYERS, attention=attention,
                             dtype=dtype, device=device,
                             generator=torch.Generator(device).manual_seed(
                                 SEED))

    tokens = torch.randint(0, VOCAB, (BATCH, TP_SEQ), device=device,
                           generator=torch.Generator(device).manual_seed(
                               SEED + 1))

    def step(m) -> float:
        opt = torch.optim.SGD(m.parameters(), lr=TP_LR)
        loss = lm_loss(m(tokens), tokens)
        loss.backward()
        if isinstance(m, ShardedModule):
            m.reduce_grads()
        opt.step()
        return loss.item()

    out = {}
    if ctx.rank == 0:
        ref = model(torch.bfloat16, "flash")
        out["loss_replicated"] = step(ref)
        want = {n: p.detach() for n, p in ref.named_parameters()}
        del ref
        f32 = model(torch.float32, "dense")
        out["loss_f32"] = step(f32)
        out["bf16_distance"] = max(
            (p.detach() - want[n]).abs().max().item()
            for n, p in f32.named_parameters())
        del f32
        torch.cuda.empty_cache()
    sm = ShardedModule(model(torch.bfloat16, "flash"),
                       make_mesh(dict(tensor=2)),
                       transformer_param_rules("tensor"))
    heads = []
    flash = tmod.flash_attention

    def counted(q, k, v, **kw):
        heads.append(q.shape[2])
        return flash(q, k, v, **kw)

    tmod.flash_attention = counted
    fa.FWD_LAUNCHES = fa.DKDV_LAUNCHES = fa.DQ_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["loss"] = step(sm)
    torch.cuda.synchronize()
    out["step_s"] = time.perf_counter() - t0
    out["launches"] = {"flash_attention_fwd": fa.FWD_LAUNCHES,
                       "flash_attention_bwd_dkdv": fa.DKDV_LAUNCHES,
                       "flash_attention_bwd_dq": fa.DQ_LAUNCHES}
    out["heads"] = sorted(set(heads))
    out["q_local"] = list(sm.local_shapes()["block_0.attn.q.kernel"])
    out["memory_allocated"] = torch.cuda.memory_allocated(device)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    whole = sm.gather_state({"model": sm.state_dict()})["model"]
    if ctx.rank == 0:
        out["tp_distance"] = max((whole[n] - w).abs().max().item()
                                 for n, w in want.items())
    return out


def shard_lm() -> dict:
    """(d) tensor=2: TransformerLM at full width (2 layers, T = 2048) split
    by transformer_param_rules over two ranks sharing the card, one SGD
    step against the replicated step."""
    from raydp_tpu_torch.spmd import create_spmd_job

    job = create_spmd_job("smoke-tp", 2, torch_distributed=True,
                          timeout=180)
    t0 = time.perf_counter()
    job.start()
    start_s = time.perf_counter() - t0
    try:
        ranks = job.run(tp_rank, timeout=900)
    finally:
        job.stop()
    r0 = ranks[0]
    loss_rel = abs(r0["loss"] - r0["loss_replicated"]) \
        / abs(r0["loss_replicated"])
    out = {"start_s": start_s, "ranks": ranks, "loss_rel_diff": loss_rel}
    print(f"shard lm tensor=2: the split step's loss {r0['loss']:.6f} vs "
          f"the replicated step's {r0['loss_replicated']:.6f} "
          f"({loss_rel:.3e}, limit {TP_LOSS_RTOL}; f32 "
          f"{r0['loss_f32']:.6f}); the updated parameters differ from the "
          f"replicated step's by at most {r0['tp_distance']:.3e}, bf16's own "
          f"distance (the f32 step's) {r0['bf16_distance']:.3e} (limit "
          f"{TP_PARAM_BF16_STEPS}× it); q kernel a "
          f"rank {[r['q_local'] for r in ranks]}; heads an attention call "
          f"saw {[r['heads'] for r in ranks]}; flash launches "
          f"{[r['launches'] for r in ranks]}; the split step "
          f"{[round(r['step_s'], 3) for r in ranks]} s; memory allocated "
          f"{[r['memory_allocated'] for r in ranks]} bytes, peak "
          f"{[r['max_memory_allocated'] for r in ranks]}")
    require(loss_rel <= TP_LOSS_RTOL, f"shard lm loss: {out}")
    require(r0["tp_distance"] <= TP_PARAM_BF16_STEPS * r0["bf16_distance"],
            f"shard lm parameters: {out}")
    require(all(r["q_local"] == [DIM, HEADS // 2, DIM // HEADS]
                and r["heads"] == [HEADS // 2]
                and all(n > 0 for n in r["launches"].values())
                for r in ranks), f"shard lm split: {out}")
    return out


def gbdt_rank(ctx) -> dict:
    """(f) in one rank: fit_gbdt on this rank's half of the rows, its
    backend and graph replays."""
    from raydp_tpu_torch.models import fit_gbdt
    from raydp_tpu_torch.parallel import make_mesh

    import torch.distributed as dist

    X, y = gbdt_rows()
    times = {}
    t0 = time.perf_counter()
    model, margins, _ = fit_gbdt(X, y, num_trees=GBDT_ROUNDS,
                                 max_depth=GBDT_DEPTH, num_bins=256,
                                 mesh=make_mesh(), timings=times)
    wall = time.perf_counter() - t0
    return {"model": model, "margins": margins, "fit_s": wall,
            "backend": dist.get_backend(),
            "graph_replays": times["graph_replays"]}


def gbdt_rows():
    """(f)'s rows: GBDT_ROWS seeded NYCTaxi-shaped rows."""
    table = nyctaxi_tables(GBDT_ROWS, 1, SEED)[0]
    X = np.stack([table[c].to_numpy() for c in NYC_COLUMNS], axis=1)
    return X, table[NYC_LABEL].to_numpy()


def shard_gbdt() -> dict:
    """(f) Row-sharded GBDT: two ranks, each with half of the rows,
    histograms summed with one all_reduce a level, against the in-process
    fit: sharing the card under gloo (rounds eager) on one card, one card
    each under nccl (rounds captured) on more."""
    from raydp_tpu_torch.models import fit_gbdt
    from raydp_tpu_torch.spmd import create_spmd_job

    X, y = gbdt_rows()
    t0 = time.perf_counter()
    single, margins, _ = fit_gbdt(X, y, num_trees=GBDT_ROUNDS,
                                  max_depth=GBDT_DEPTH, num_bins=256)
    single_s = time.perf_counter() - t0
    # one card a rank (nccl, rounds captured) where the host has two
    job = create_spmd_job("smoke-gbdt", 2, torch_distributed=True,
                          gpus_per_process=int(torch.cuda.device_count() >= 2),
                          timeout=180)
    job.start()
    try:
        ranks = job.run(gbdt_rank, timeout=600)
    finally:
        job.stop()
    agree = forests_agree("shard gbdt 2 ranks", ranks[0]["model"], single,
                          ranks[0]["margins"], margins)
    backends = [r["backend"] for r in ranks]
    out = {**agree, "fit_s": single_s,
           "rank_fit_s": [r["fit_s"] for r in ranks],
           "backends": backends,
           "graph_replays": [r["graph_replays"] for r in ranks],
           "ranks_agree": same_forest(ranks[0]["model"], ranks[1]["model"])}
    print(f"shard gbdt: {GBDT_ROWS} rows, depth {GBDT_DEPTH}, 256 bins, "
          f"{GBDT_ROUNDS} rounds; 2 ranks, {layout(backends[0])}, graph "
          f"replays {out['graph_replays']}; in-process fit {single_s:.3f} s, "
          f"the ranks' {[round(v, 3) for v in out['rank_fit_s']]} s; both "
          f"ranks hold the same forest: {out['ranks_agree']}")
    require(out["ranks_agree"], f"shard gbdt: {out}")
    # the backend's own branch: rounds replayed under nccl, none under gloo
    require(all((r > 0) == (b == "nccl")
                for r, b in zip(out["graph_replays"], backends)),
            f"shard gbdt replays: {out}")
    return out


def shard_resume(train, test, features, tmp: str, phase13: dict,
                 label: str = "shard resume", chain: int = 1,
                 epochs: int = GANG_RESUME_EPOCHS) -> dict:
    """(e) The sharded checkpoint: (b)'s gang for ``epochs``, rank 1 exiting
    at epoch 1 once (max_retries=1), resumed from the sharded multi-writer
    format; the driver's restore reassembles the whole state. The retry's
    wall: the failed gang's stop and the second gang's start. With
    ``chain`` > 1 (phase 16 (i), under nccl) the resumed gang's chains are
    captured again after the restore: graphs replayed."""
    import glob
    import os

    from raydp_tpu_torch.examples.nyctaxi_mlp import build_estimator
    from raydp_tpu_torch.spmd.job import SPMDJob
    from raydp_tpu_torch.train import checkpoint as ckpt

    tag = "".join(c if c.isalnum() else "-" for c in label)
    flag = os.path.join(tmp, f"{tag}-crashed-once")
    ckpt_dir = os.path.join(tmp, tag)

    def crash_once(report):
        import torch.distributed as dist

        if (report["epoch"] == 1 and dist.get_rank() == 1
                and not os.path.exists(flag)):
            open(flag, "w").close()
            os._exit(1)

    est = build_estimator(features, GANG_BATCH, epochs, None,
                          mesh_spec=dict(fsdp=2))
    est.shuffle, est.callbacks, est.checkpoint_dir = \
        False, [crash_once], ckpt_dir
    est.steps_per_dispatch = chain
    clock = CallClock()
    clock.wrap(SPMDJob, "start", "start")
    clock.wrap(SPMDJob, "stop", "stop")
    with device_cache(False):
        t0 = time.perf_counter()
        try:
            gang = est.fit_gang(train, test, num_workers=2, max_retries=1)
        finally:
            clock.restore()
        wall = time.perf_counter() - t0
    gang_report(label, gang.history, gang.dispatch)
    starts, stops = clock.calls["start"], clock.calls["stop"]
    steps = sorted(glob.glob(os.path.join(ckpt_dir, "step_*")),
                   key=lambda p: int(p.rsplit("_", 1)[1]))
    latest = steps[-1]
    manifests = len(glob.glob(os.path.join(latest, "manifest_*.json")))
    complete = os.path.exists(os.path.join(latest, "COMPLETE"))
    single = phase13["resume"]["single_losses"]
    diffs = [abs(a - b) / abs(b) for a, b in zip(losses_of(gang), single)]
    state = est.get_state()
    restored, step = ckpt.restore(ckpt_dir, state.state_dict())
    bitwise = all(torch.equal(t, dict(ckpt._tensor_leaves(restored))[k])
                  for k, t in ckpt._tensor_leaves(state.state_dict()))
    state.load_state_dict(restored)
    predicted = smooth_l1_of(est, test)
    eval_vs_predict = abs(gang.history[-1]["eval_loss"] - predicted) \
        / predicted
    out = {"history_epochs": [r["epoch"] for r in gang.history],
           "crashed": os.path.exists(flag), "fit_gang_s": wall,
           "latest": os.path.basename(latest), "manifests": manifests,
           "complete": complete, "restored_step": step,
           "restore_bitwise": bitwise, "rel_diffs": diffs,
           "eval_vs_predict_rel_diff": eval_vs_predict,
           "backends": [r["backend"] for r in gang.ranks],
           "replays": [d["graph_replays"] for d in gang.dispatch],
           "starts_s": starts, "stops_s": stops,
           # from the failed run's end to the second gang's ranks serving
           "retry_s": stops[0] + starts[1] if len(starts) > 1 else None}
    print(f"{label}: backend {out['backends']}, steps_per_dispatch {chain}, "
          f"the resumed gang's graph replays {out['replays']}; the retry "
          f"{out['retry_s']} s (the stops {stops} s, the starts {starts} "
          f"s); "
          f"history {out['history_epochs']}; {out['latest']} "
          f"holds {manifests} manifests, COMPLETE {complete}; train losses "
          f"differ from the in-process fit's by "
          f"{[f'{v:.3e}' for v in diffs]} (limit {GANG_RESUME_RTOL}); the "
          f"driver's restore of step {step} equals the gang's state bit for "
          f"bit: {bitwise}; its predict vs the last eval loss "
          f"{eval_vs_predict:.3e} (limit {GANG_EVAL_RTOL}); fit_gang "
          f"{wall:.3f} s")
    require(out["crashed"], f"{label}: the injected crash never fired")
    require(out["history_epochs"] == list(range(epochs))
            and manifests == 2 and complete and bitwise
            and len(starts) == 2, f"{label}: {out}")
    require(max(diffs) <= GANG_RESUME_RTOL, f"{label}: {out}")
    require(eval_vs_predict <= GANG_EVAL_RTOL, f"{label} eval: {out}")
    if chain > 1:
        require(all(r > 0 for r in out["replays"]),
                f"{label}: the resumed gang replayed no graph: {out}")
    return out


def run_sharding(fa, phase13: dict, frames, tmp: str) -> dict:
    """Phase 14: the sharding plane on the card — (a) the world-1 mesh,
    (b) fsdp=2, (c) expert=2 DLRM, (d) tensor=2 TransformerLM, (e) the
    sharded checkpoint, (f) row-sharded GBDT. The driver launches no flash
    kernel; (d)'s ranks count their own."""
    t_phase = time.perf_counter()
    zero_launches(fa)
    train, test, features = frames
    out = {"world1": shard_world1(train, test, features, phase13)}
    out["fsdp"] = shard_fsdp(train, test, features, phase13)
    out["dlrm"] = shard_dlrm()
    free_memory()
    out["lm"] = shard_lm()
    out["resume"] = shard_resume(
        train, test, features, tmp, phase13,
        epochs=GLOO_RESUME_EPOCHS if torch.cuda.device_count() < 2
        else GANG_RESUME_EPOCHS)
    out["gbdt"] = shard_gbdt()
    counts = launches(fa)
    print(f"shard launches of the flash kernels in the driver: {counts}")
    require(not any(counts.values()), f"phase 14's driver launched {counts}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"shard phase: {out['phase_s']:.3f} s")
    print("shard " + json.dumps(out, default=str))
    return out


# ---- phase 15: the seq and stage axes ----------------------------------------

#: (a): the ring at the flagship shape (B, T, H, D), bf16, causal, over seq=2
RING_SHAPE = (2, 8192, 8, 128)
#: (a), (b): a split run may differ from the one-card run by up to twice
#: what bf16 itself moves the one-card run from f32 (measured in the run):
#: the two bf16 runs round at other points (the ring merges its blocks in
#: f32 and rounds once more; its dk/dv sum two blocks' bf16 gradients), and
#: their errors against f32 add, as TP_PARAM_BF16_STEPS reasons
SPLIT_BF16_STEPS = 2.0
#: (b): the TransformerLM at full width over seq=2, cut to 2 layers, one
#: SGD step at phase 14 (d)'s rate
SEQ_LAYERS, SEQ_T = 2, 8192
#: (c): pipeline_apply over two of the TransformerLM's Blocks at full width
#: (one a stage): 4 microbatches of 1 × 2048 tokens
PIPE_MICRO, PIPE_T = 4, 2048
#: (c): the pipelined run applies the same kernels to the same microbatches
#: as the blocks in order; its outputs may differ by one bf16 rounding step
#: (2^-7 of the value, plus 1e-5 for f32 sums near zero, as OUT_TOL) and
#: its gradients, whose four microbatch shares the two sum in another
#: order, by bf16's unit roundoff (2^-8) in relative L2
PIPE_OUT_TOL, PIPE_GRAD_REL = (1e-5, 2.0 ** -7), 2.0 ** -8
#: (d): the reference test's PipelineModel (tests/test_pipeline_estimator.py:
#: four residual tanh blocks of width 8, a Dense head) on its 256 rows,
#: fit_gang over stage=2 against fit, the test's rtol
PIPE_EST_DIM, PIPE_EST_ROWS, PIPE_EST_RTOL = 8, 256, 5e-4
#: (e): the long-context example at its defaults, fewer steps
LONGCTX_ARGS = ["--seq-parallel", "2", "--steps", "6"]


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def ring_case(ctx, device, profile: bool = False) -> dict:
    """(a) in one rank: its block of the flagship q/k/v through the ring
    (forward and backward), gathered whole on every rank; rank 0 holds it
    against one flash_attention call and the f32 dense run. With
    ``profile``, one more forward and backward runs under
    :func:`profiled` (phase 16 (g))."""
    import torch.distributed as dist

    from raydp_tpu_torch.ops import flash_attention as fa
    from raydp_tpu_torch.ops.ring_attention import (
        dense_attention, ring_attention)
    from raydp_tpu_torch.parallel import gang, make_mesh
    from raydp_tpu_torch.parallel.shard import gather_dim

    mesh = make_mesh(dict(seq=2))
    b, t, h, d = RING_SHAPE
    gen = torch.Generator(device).manual_seed(SEED + 2)
    q, k, v, g = (torch.randn(b, t, h, d, device=device, generator=gen)
                  .to(torch.bfloat16) for _ in range(4))
    c = mesh.coords["seq"]
    block = slice(c * t // 2, (c + 1) * t // 2)

    def ring_once():
        """One forward and backward: (out, q/k/v grads, wall, host seconds
        in the exchanges)."""
        ql, kl, vl = (x[:, block].clone().requires_grad_(True)
                      for x in (q, k, v))
        torch.cuda.synchronize()
        dist.barrier()
        gang.COMM.take()
        t0 = time.perf_counter()
        out = ring_attention(ql, kl, vl, mesh, causal=True)
        out.backward(g[:, block])
        torch.cuda.synchronize()
        return ([out.detach(), ql.grad, kl.grad, vl.grad],
                time.perf_counter() - t0, gang.COMM.take())

    # the first run starts the process's kernels and point-to-point pairs
    _, first_s, _ = ring_once()
    zero_launches(fa)
    sent = gang.COMM.sent_bytes
    blocks, wall, exchange_s = ring_once()
    res = {"first_wall_s": first_s, "wall_s": wall,
           "exchange_s": exchange_s, "launches": launches(fa),
           "sent_bytes": gang.COMM.sent_bytes - sent}
    if profile:
        _, res["device"] = profiled("ring", ring_once)
    whole = [gather_dim(x, 1, ("seq",), mesh) for x in blocks]
    if ctx.rank == 0:
        def run(fn, dtype):
            xs = [x.detach().to(dtype).requires_grad_(True)
                  for x in (q, k, v)]
            o = fn(*xs, causal=True)
            o.backward(g.to(dtype))
            return [o.detach()] + [x.grad for x in xs]

        flash = run(fa.flash_attention, torch.bfloat16)
        dense = run(dense_attention, torch.float32)
        names = ("out", "dq", "dk", "dv")
        res["ring_vs_flash"] = {n: rel_l2(a, f) for n, a, f in
                                zip(names, whole, flash)}
        res["flash_vs_f32"] = {n: rel_l2(f, x) for n, f, x in
                               zip(names, flash, dense)}
        del flash, dense
    del whole, blocks, q, k, v, g
    free_memory()
    return res


def seq_lm_case(ctx, device) -> dict:
    """(b) in one rank: rank 0 first takes the unsharded bf16 step (flash)
    and, to measure bf16's own distance, the same step in f32 (dense);
    then both ranks take the seq=2 step on their halves of the tokens
    (ring attention), counting the flash launches."""
    import torch.distributed as dist

    from raydp_tpu_torch.models import TransformerLM, lm_loss
    from raydp_tpu_torch.ops import flash_attention as fa
    from raydp_tpu_torch.parallel import ShardedModule, gang, make_mesh

    mesh = make_mesh(dict(seq=2))

    def model(dtype, attention, mesh=None):
        return TransformerLM(VOCAB, dim=DIM, num_heads=HEADS,
                             num_layers=SEQ_LAYERS, attention=attention,
                             mesh=mesh, dtype=dtype, device=device,
                             generator=torch.Generator(device).manual_seed(
                                 SEED))

    tokens = torch.randint(0, VOCAB, (BATCH, SEQ_T), device=device,
                           generator=torch.Generator(device).manual_seed(
                               SEED + 1))

    def step(m, tok, mesh=None) -> float:
        opt = torch.optim.SGD(m.parameters(), lr=TP_LR)
        loss = lm_loss(m(tok), tok, mesh)
        loss.backward()
        if isinstance(m, ShardedModule):
            m.reduce_grads()
        opt.step()
        return loss.item()

    out = {}
    if ctx.rank == 0:
        ref = model(torch.bfloat16, "flash")
        out["loss_unsharded"] = step(ref, tokens)
        want = {n: p.detach() for n, p in ref.named_parameters()}
        del ref
        free_memory()
        f32 = model(torch.float32, "dense")
        out["loss_f32"] = step(f32, tokens)
        out["bf16_distance"] = max(
            (p.detach() - want[n]).abs().max().item()
            for n, p in f32.named_parameters())
        del f32
        free_memory()
    sm = ShardedModule(model(torch.bfloat16, "ring", mesh), mesh)
    c = mesh.coords["seq"]
    local = tokens[:, c * SEQ_T // 2:(c + 1) * SEQ_T // 2].contiguous()
    # a forward and backward first, without the update, so the timed step
    # finds both ranks' kernels, libraries and exchanges started
    lm_loss(sm(local), local, mesh).backward()
    sm.zero_grad(set_to_none=True)
    zero_launches(fa)
    torch.cuda.reset_peak_memory_stats(device)
    opt = torch.optim.SGD(sm.parameters(), lr=TP_LR)
    split = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        split[name] = time.perf_counter() - t
        return result

    dist.barrier()
    gang.COMM.take()
    t0 = time.perf_counter()
    loss = timed("forward_s", lambda: lm_loss(sm(local), local, mesh))
    timed("backward_s", loss.backward)
    timed("reduce_s", sm.reduce_grads)
    timed("update_s", opt.step)
    out["loss"] = loss.item()
    out["step_s"] = time.perf_counter() - t0
    out["split"] = split
    # host seconds in the ring's exchanges, the loss's sum and the
    # gradients' all-reduce (a rank that waits for the other counts it)
    out["collective_s"] = gang.COMM.take()
    out["launches"] = launches(fa)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    if ctx.rank == 0:
        out["seq_distance"] = max(
            (p.detach() - want[n]).abs().max().item()
            for n, p in sm.module.named_parameters())
    del sm
    free_memory()
    return out


def pipeline_case(ctx, device) -> dict:
    """(c) in one rank: two full-width Blocks stacked, one a stage of
    stage=2, 4 microbatches through pipeline_apply, forward and backward,
    counting the flash launches; rank 0 then applies the blocks in order
    to the same microbatches and holds the outputs and both stages'
    gradients (summed over the stage axis) against them."""
    import torch.distributed as dist
    from torch.func import functional_call

    from raydp_tpu_torch.models.layers import init_parameters
    from raydp_tpu_torch.models.transformer import Block
    from raydp_tpu_torch.ops import flash_attention as fa
    from raydp_tpu_torch.parallel import gang, make_mesh, pipeline_apply
    from raydp_tpu_torch.parallel.shard import all_reduce_sum

    mesh = make_mesh(dict(stage=2))
    gen = torch.Generator(device).manual_seed(SEED + 3)
    blocks = []
    for _ in range(2):
        blk = Block(DIM, HEADS, attention="flash", dtype=torch.bfloat16,
                    device=device)
        init_parameters(blk, gen)
        blocks.append(blk)
    template = blocks[0]
    names = [n for n, _ in template.named_parameters()]
    x = torch.randn(PIPE_MICRO, 1, PIPE_T, DIM, device=device,
                    generator=gen).to(torch.bfloat16)
    g = torch.randn(PIPE_MICRO, 1, PIPE_T, DIM, device=device,
                    generator=gen)

    def layer(p, h):
        return functional_call(template, p, (h,))

    def stacked():
        return {n: torch.stack([dict(b.named_parameters())[n].detach()
                                for b in blocks]).requires_grad_(True)
                for n in names}

    params = stacked()
    zero_launches(fa)
    torch.cuda.synchronize()
    dist.barrier()
    gang.COMM.take()
    t0 = time.perf_counter()
    out = pipeline_apply(layer, params, x, mesh)
    (out.float() * g).sum().backward()
    torch.cuda.synchronize()
    res = {"wall_s": time.perf_counter() - t0,
           "exchange_s": gang.COMM.take(), "launches": launches(fa)}
    grads = {n: all_reduce_sum(p.grad, ("stage",), mesh)
             for n, p in params.items()}
    if ctx.rank == 0:
        seq = stacked()
        want = []
        for h in x:
            for i in range(2):
                h = layer({n: p[i] for n, p in seq.items()}, h)
            want.append(h)
        want = torch.stack(want)
        (want.float() * g).sum().backward()
        atol, rtol = PIPE_OUT_TOL
        step = (out.float() - want.float()).abs() \
            / (atol + rtol * want.float().abs())
        res["out_max_abs_diff"] = float((out - want).abs().max())
        res["out_steps_used"] = float(step.max())
        res["grad_rel_l2"] = max(rel_l2(grads[n], seq[n].grad)
                                 for n in names)
        del seq, want
    del params, grads, out, blocks
    free_memory()
    return res


def long_context_rank(ctx) -> dict:
    """(a), (b) and (c) in one rank of a 2-rank job sharing the card."""
    from raydp_tpu_torch import resolve_device

    device = resolve_device()
    return {"ring": ring_case(ctx, device), "lm": seq_lm_case(ctx, device),
            "pipeline": pipeline_case(ctx, device)}


def pipeline_estimator(label: str = "longctx (d)", chain: int = 1,
                       remat: Optional[str] = None) -> dict:
    """(d) fit_gang(mesh_spec={"stage": 2}) of the reference test's
    PipelineModel over two ranks (sharing the card on one card, one card
    each on more) against fit in this process, unshuffled; the driver's
    train_pipeline_stages gauge. With ``chain`` > 1 (phase 16 (h)) the
    gang's chains are captured under nccl: graphs replayed; ``remat``
    recomputes every segment (both fits)."""
    import pyarrow as pa

    from raydp_tpu_torch import metrics as rdt_metrics
    from raydp_tpu_torch.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu_torch.models.layers import _Dense, init_parameters
    from raydp_tpu_torch.runtime.object_store import get_client
    from raydp_tpu_torch.train import PipelineModel, TorchEstimator

    dim = PIPE_EST_DIM
    cpu = torch.device("cpu")

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = _Dense((dim,), (dim,), None, cpu, use_bias=True)

        def forward(self, x):
            return x + torch.tanh(self.Dense_0(x))

    # PipelineModel copies its layers' parameters: draw them first
    gen = torch.Generator().manual_seed(SEED)
    layers = [Block() for _ in range(4)]
    head = _Dense((dim,), (1,), None, cpu, use_bias=True)
    for m in layers:
        init_parameters(m, gen)
    head.reset_parameters(gen)
    model = PipelineModel(layers, head=head)
    rng = np.random.RandomState(SEED)
    x = rng.normal(size=(PIPE_EST_ROWS, dim))
    data = {f"f{i}": x[:, i] for i in range(dim)}
    data["label"] = x @ rng.normal(size=(dim,)) \
        + 0.1 * rng.normal(size=PIPE_EST_ROWS)
    table = pa.table(data)
    tables = [table.slice(i * 64, 64) for i in range(PIPE_EST_ROWS // 64)]
    refs = get_client().put_arrow_many(tables)
    ds = DistributedDataset([BlockMeta(num_rows=t.num_rows, ref=r)
                             for t, r in zip(tables, refs)], tables[0].schema)

    def est(**kw):
        return TorchEstimator(model=model, loss="mse",
                              feature_columns=list(data)[:-1],
                              label_column="label", batch_size=64, seed=SEED,
                              shuffle=False, num_epochs=3, accum_steps=4,
                              remat=remat, **kw)

    single = est().fit(ds)
    t0 = time.perf_counter()
    gang = est(mesh_spec={"stage": 2},
               steps_per_dispatch=chain).fit_gang(ds, num_workers=2)
    wall = time.perf_counter() - t0
    stages = rdt_metrics.snapshot()["gauges"]["train_pipeline_stages"][""]
    diffs = [abs(a - b) / abs(b) for a, b in zip(losses_of(gang),
                                                  losses_of(single))]
    out = {"fit_gang_s": wall, "losses": losses_of(gang),
           "single_losses": losses_of(single), "rel_diffs": diffs,
           "pipeline_stages": stages,
           "backends": [r["backend"] for r in gang.ranks],
           "replays": [d["graph_replays"] for d in gang.dispatch],
           "local_shapes": [r["local_shapes"]["stage_stack.Dense_0.kernel"]
                            for r in gang.ranks]}
    print(f"{label} fit_gang stage=2 of a PipelineModel, backend "
          f"{out['backends']}, remat {remat}, steps_per_dispatch {chain} "
          f"(graph replays {out['replays']}): train losses "
          f"{[f'{v:.6f}' for v in out['losses']]} vs fit "
          f"{[f'{v:.6f}' for v in out['single_losses']]} (relative "
          f"{[f'{v:.3e}' for v in diffs]}, limit {PIPE_EST_RTOL}); "
          f"train_pipeline_stages {stages}; stage_stack kernel a rank "
          f"{out['local_shapes']}; fit_gang {wall:.3f} s")
    require(max(diffs) <= PIPE_EST_RTOL and stages == 2
            and out["local_shapes"] == [(2, dim, dim)] * 2,
            f"{label} pipeline estimator: {out}")
    if chain > 1:
        require(all(b == "nccl" for b in out["backends"]),
                f"{label}: backends {out['backends']}")
        check_dispatch(label, gang, chain)
    return out


def long_context_example() -> dict:
    """(e) examples/longcontext_lm.py --seq-parallel 2: two ranks sharing
    the card (gloo), ring attention on the card; the loss falls."""
    from raydp_tpu_torch.examples import longcontext_lm

    t0 = time.perf_counter()
    res = longcontext_lm.main(LONGCTX_ARGS)
    out = {"main_s": time.perf_counter() - t0, "losses": res["losses"],
           "tokens_per_s": [r["tokens_per_s"] for r in res["ranks"]],
           "launches": [r["launches"] for r in res["ranks"]],
           "mesh": res["mesh"]}
    print(f"longctx (e) longcontext_lm.py {' '.join(LONGCTX_ARGS)}: losses "
          f"{[f'{v:.4f}' for v in out['losses']]}, "
          f"{[round(v) for v in out['tokens_per_s']]} tokens/s a rank, "
          f"flash launches {out['launches']}; main {out['main_s']:.3f} s")
    require(out["losses"][-1] < out["losses"][0]
            and all(n > 0 for r in out["launches"] for n in r.values()),
            f"longctx example: {out}")
    return out


def run_long_context(fa) -> dict:
    """Phase 15: the seq and stage axes on the card — (a) the ring at the
    flagship shape, (b) the TransformerLM over seq=2, (c) pipeline_apply
    over full-width Blocks, in one 2-rank job sharing the card (gloo), each
    rank counting its own launches; (d) fit_gang of a PipelineModel over
    stage=2; (e) the long-context example. The driver launches no flash
    kernel."""
    from raydp_tpu_torch.spmd import create_spmd_job

    t_phase = time.perf_counter()
    zero_launches(fa)
    job = create_spmd_job("smoke-longctx", 2, torch_distributed=True,
                          timeout=180)
    t0 = time.perf_counter()
    job.start()
    start_s = time.perf_counter() - t0
    try:
        ranks = job.run(long_context_rank, timeout=900)
    finally:
        job.stop()
    out = {"start_s": start_s}

    ring = [r["ring"] for r in ranks]
    r0 = ring[0]
    out["ring"] = ring
    print(f"longctx (a) ring B,T,H,D={RING_SHAPE} bf16 causal over seq=2: "
          f"against one flash_attention call, relative L2 "
          f"{ {k: f'{v:.3e}' for k, v in r0['ring_vs_flash'].items()} }; "
          f"bf16's own (flash vs f32 dense) "
          f"{ {k: f'{v:.3e}' for k, v in r0['flash_vs_f32'].items()} } "
          f"(limit {SPLIT_BF16_STEPS}x it); flash launches a rank "
          f"{[r['launches'] for r in ring]}; ring forward+backward "
          f"{[round(r['wall_s'], 4) for r in ring]} s (the first "
          f"{[round(r['first_wall_s'], 4) for r in ring]}), of it in the "
          f"exchanges {[round(r['exchange_s'], 4) for r in ring]} s; "
          f"{[r['sent_bytes'] for r in ring]} bytes sent a rank")
    require(all(r0["ring_vs_flash"][k]
                <= SPLIT_BF16_STEPS * r0["flash_vs_f32"][k]
                for k in r0["ring_vs_flash"]), f"longctx ring: {r0}")
    # the causal skip: rank 0 folds its own block, rank 1 both
    require([r["launches"] for r in ring] == [
        dict.fromkeys(KERNELS, 1), dict.fromkeys(KERNELS, 2)],
        f"longctx ring launches: {ring}")

    lm = [r["lm"] for r in ranks]
    l0 = lm[0]
    loss_rel = abs(l0["loss"] - l0["loss_unsharded"]) \
        / abs(l0["loss_unsharded"])
    out["lm"] = {"ranks": lm, "loss_rel_diff": loss_rel}
    print(f"longctx (b) TransformerLM over seq=2 (dim {DIM}, {HEADS} heads, "
          f"{SEQ_LAYERS} layers, T={SEQ_T}): the split step's loss "
          f"{l0['loss']:.6f} vs the unsharded step's "
          f"{l0['loss_unsharded']:.6f} ({loss_rel:.3e}, limit "
          f"{TP_LOSS_RTOL}; f32 {l0['loss_f32']:.6f}); the updated "
          f"parameters differ from the unsharded step's by at most "
          f"{l0['seq_distance']:.3e}, bf16's own distance (the f32 step's) "
          f"{l0['bf16_distance']:.3e} (limit {TP_PARAM_BF16_STEPS}x it); "
          f"flash launches {[r['launches'] for r in lm]}; the split step "
          f"{[round(r['step_s'], 3) for r in lm]} s, of it in collectives "
          f"{[round(r['collective_s'], 3) for r in lm]} s, split "
          f"{[{k: round(v, 3) for k, v in r['split'].items()} for r in lm]};"
          f" peak memory "
          f"{[r['max_memory_allocated'] for r in lm]} bytes")
    require(loss_rel <= TP_LOSS_RTOL, f"longctx lm loss: {out['lm']}")
    require(l0["seq_distance"] <= TP_PARAM_BF16_STEPS * l0["bf16_distance"],
            f"longctx lm parameters: {out['lm']}")
    require(all(n > 0 for r in lm for n in r["launches"].values()),
            f"longctx lm launches: {out['lm']}")

    pipe = [r["pipeline"] for r in ranks]
    p0 = pipe[0]
    out["pipeline"] = pipe
    print(f"longctx (c) pipeline_apply over 2 Blocks at dim {DIM}, stage=2, "
          f"{PIPE_MICRO} microbatches of 1x{PIPE_T}: against the blocks in "
          f"order, outputs differ by at most {p0['out_max_abs_diff']:.3e} "
          f"({p0['out_steps_used']:.3f} of one bf16 step), gradients by "
          f"{p0['grad_rel_l2']:.3e} relative L2 (limit {PIPE_GRAD_REL:.3e}); "
          f"flash launches a rank {[r['launches'] for r in pipe]}; forward+"
          f"backward {[round(r['wall_s'], 4) for r in pipe]} s, of it in "
          f"the exchanges {[round(r['exchange_s'], 4) for r in pipe]} s")
    require(p0["out_steps_used"] <= 1.0 and p0["grad_rel_l2"]
            <= PIPE_GRAD_REL, f"longctx pipeline: {p0}")
    ticks = PIPE_MICRO + 1
    require(all(r["launches"] == dict.fromkeys(KERNELS, ticks)
                for r in pipe), f"longctx pipeline launches: {pipe}")

    out["estimator"] = pipeline_estimator()
    out["example"] = long_context_example()
    counts = launches(fa)
    print(f"longctx launches of the flash kernels in the driver: {counts}")
    require(not any(counts.values()), f"phase 15's driver launched {counts}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"longctx phase: {out['phase_s']:.3f} s")
    print("longctx " + json.dumps(out, default=str))
    return out


# ---- phase 16: one card a rank ------------------------------------------------

#: phase 16's largest gang: (a) and (d) run four ranks, one card each
CARD_RANKS = 4
#: (b)-(e): epochs a gang; epoch 1's first chain is profiled, so the
#: steady rate is epoch 2's
CARD_EPOCHS = 3
#: (h): the staged PipelineModel's 4 steps an epoch as two chains of 2
PIPE_EST_CHAIN = 2
#: (f): the TransformerLM at bench.py's width and depth (bench.py:628-636),
#: two Adam steps at phase 4's rate under tensor=2, then under seq=2
NCCL_LM_STEPS = 2


def host_barrier(name: str) -> None:
    """Every rank of the process group meets here on its store, not on the
    card: a barrier that launches no kernel, so a profiled window that
    starts after it holds only the work that follows."""
    import torch.distributed as dist

    store = dist.distributed_c10d._get_default_store()
    world = dist.get_world_size()
    store.add(name, 1)
    deadline = time.perf_counter() + 120.0
    while store.add(name, 0) < world:
        require(time.perf_counter() < deadline, f"host barrier {name}")
        time.sleep(0.0005)


def device_split(prof, wall_s: float) -> dict:
    """The device time of a profiled window: the union of its kernel and
    copy intervals (busy), the sum of its kernels' times, and of the
    ``nccl*`` kernels' (the collectives and exchanges) and their share of
    the busy time."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events()
              if e.device_type == cuda and not e.is_user_annotation]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, -math.inf
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    nccl_us = sum(e.time_range.elapsed_us() for e in events
                  if "nccl" in e.name.lower())
    kernel_us = sum(e.time_range.elapsed_us() for e in events)
    return {"wall_ms": wall_s * 1e3, "busy_ms": busy_us / 1e3,
            "kernel_ms": kernel_us / 1e3, "nccl_ms": nccl_us / 1e3,
            "nccl_share": nccl_us / busy_us if busy_us else None,
            "device_ops": len(events)}


def profiled(name: str, fn) -> tuple:
    """``fn()`` under ``torch.profiler`` (started before a host barrier of
    every rank, so no rank's collective waits for another's profiler to
    start) and synchronized: (its result, :func:`device_split`)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        host_barrier(name)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, device_split(prof, wall)


class ProfileOneChain:
    """Estimator callback, run in every rank of a gang: after epoch 0 the
    rank's next replayed chain (epoch 1's first) runs under
    :func:`profiled`; epoch 1's report (the chief's history) carries every
    rank's split as ``chain_profile``."""

    def __init__(self):
        self.split = None

    def __call__(self, report: dict) -> None:
        import torch.distributed as dist

        if report["epoch"] == 0:
            self._arm()
        elif report["epoch"] == 1:
            splits = [None] * dist.get_world_size()
            dist.all_gather_object(splits, self.split)
            report["chain_profile"] = splits

    def _arm(self) -> None:
        from raydp_tpu_torch.train import step_graph

        run = step_graph.StepRunner.__call__
        callback = self

        def call(runner, inputs, n_steps=1):
            if runner._graph is None or not runner._fits(inputs):
                return run(runner, inputs, n_steps)
            step_graph.StepRunner.__call__ = run
            _, callback.split = profiled(
                "chain-profile", lambda: run(runner, inputs, n_steps))

        step_graph.StepRunner.__call__ = call


def fmt_shares(values) -> list:
    """Shares for a print: four places, or "not measured" where the trace
    held no device time."""
    return ["not measured" if v is None else round(v, 4) for v in values]


def chain_share(history: list) -> list:
    """Each rank's nccl share of its profiled chain (epoch 1's report)."""
    splits = history[1].get("chain_profile") if len(history) > 1 else None
    return [s and s["nccl_share"] for s in splits] if splits else []


def gang_of(label: str, est, train, test, num_workers: int, k: int,
            profile: bool, callbacks=()) -> dict:
    """fit_gang of ``est`` at ``steps_per_dispatch=k`` (a profiled chain a
    rank when ``profile``, then ``callbacks``), unshuffled: its reports and
    dispatch, each rank's backend, bytes and memory, the steady rate (the
    epochs after the first, the profiled one left out) and the wall."""
    est.shuffle, est.steps_per_dispatch = False, k
    est.callbacks = ([ProfileOneChain()] if profile else []) \
        + list(callbacks)
    with device_cache(False):
        t0 = time.perf_counter()
        result = est.fit_gang(train, test, num_workers=num_workers)
        wall = time.perf_counter() - t0
    gang_report(label, [{k_: v for k_, v in r.items()
                         if k_ != "chain_profile"} for r in result.history],
                result.dispatch)
    return {"result": result, "fit_gang_s": wall,
            "backends": [r["backend"] for r in result.ranks],
            "samples_per_s_steady": steady_rate(
                [r for r in result.history[1:] if "chain_profile" not in r]),
            "losses": losses_of(result),
            "replays": [d["graph_replays"] for d in result.dispatch],
            "eager_steps": [d["eager_steps"] for d in result.dispatch],
            "capture_s": result.dispatch[0]["capture_s"],
            "memory_allocated": [r["memory_allocated"]
                                 for r in result.ranks],
            "max_memory_allocated": [r["max_memory_allocated"]
                                     for r in result.ranks],
            "chain_nccl_share": chain_share(result.history),
            "chain_profile": result.history[1].get("chain_profile")
            if len(result.history) > 1 else None}


def card_runner() -> dict:
    """(a) A 4-rank torch_distributed job, one card a rank: every rank
    reports nccl and its card's UUID (four distinct), an all_reduce of ones
    gives [4.0, 4.0]; card 0, which rank 0 shares with this process, has
    less free memory than rank 1's card by what this process holds there."""
    from raydp_tpu_torch.spmd import create_spmd_job

    def report(ctx):
        import os

        import torch
        import torch.distributed as dist

        x = torch.ones(2, device="cuda")
        dist.all_reduce(x)
        free, total = torch.cuda.mem_get_info()
        return {"backend": dist.get_backend(), "sum": x.tolist(),
                "uuid": str(torch.cuda.get_device_properties(0).uuid),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "free_mib": free / 2 ** 20, "total_mib": total / 2 ** 20}

    job = create_spmd_job("smoke-cards", CARD_RANKS, torch_distributed=True,
                          gpus_per_process=1, timeout=180)
    t0 = time.perf_counter()
    job.start()
    start_s = time.perf_counter() - t0
    try:
        ranks = job.run(report, timeout=180)
    finally:
        job.stop()
    out = {"start_s": start_s, "ranks": ranks,
           "driver_reserved_mib": torch.cuda.memory_reserved() / 2 ** 20,
           # what card 0 lacks against rank 1's card: this process's
           # context and its allocator's cache
           "driver_on_card0_mib": ranks[1]["free_mib"] - ranks[0]["free_mib"]}
    uuids = [r["uuid"] for r in ranks]
    print(f"cards (a): {CARD_RANKS} ranks, backend "
          f"{[r['backend'] for r in ranks]}, all_reduce "
          f"{[r['sum'] for r in ranks]}, CUDA_VISIBLE_DEVICES "
          f"{[r['visible'] for r in ranks]}, card UUIDs {uuids}; start "
          f"{start_s:.3f} s; free MiB a rank's card "
          f"{[round(r['free_mib']) for r in ranks]}: card 0, shared with "
          f"this process, lacks {out['driver_on_card0_mib']:.0f} MiB "
          f"against rank 1's (this process's allocator reserves "
          f"{out['driver_reserved_mib']:.0f} MiB, its context the rest)")
    require(all(r["backend"] == "nccl" and r["sum"] == [4.0, 4.0]
                for r in ranks) and len(set(uuids)) == CARD_RANKS,
            f"cards (a): {ranks}")
    return out


def captured_against_eager(label: str, make, train, test, num_workers: int,
                           single: list, byte_limit: bool) -> dict:
    """(c), (d): the sharded gang at k=CHAIN, captured (replays > 0, eager
    only the warm-up chain and each epoch's remainder), against the same
    gang at k=1 (every step eager) on the same rows within SAME_PATH_RTOL,
    both within GANG_RESUME_RTOL of the in-process fit; each rank's bytes
    and peak memory, captured against eager."""
    graphed = gang_of(f"{label} k={CHAIN}", make(), train, test, num_workers,
                      CHAIN, profile=True)
    eager = gang_of(f"{label} k=1", make(), train, test, num_workers, 1,
                    profile=False)
    check_dispatch(f"{label} k={CHAIN}", graphed["result"], CHAIN)
    state = graphed["result"].state
    from raydp_tpu_torch.parallel import addressable_nbytes

    shares = rank_report(label, graphed["result"],
                         addressable_nbytes((state.model, state.optimizer)))
    same = max(abs(a - b) / abs(b)
               for a, b in zip(graphed["losses"], eager["losses"]))
    vs_single = [abs(a - b) / abs(b)
                 for a, b in zip(graphed["losses"], single)]
    out = {"graphed": {k: v for k, v in graphed.items() if k != "result"},
           "eager": {k: v for k, v in eager.items() if k != "result"},
           "byte_shares": shares, "graphed_vs_eager": same,
           "vs_single": vs_single}
    print(f"{label}: {num_workers} ranks, one card each, backend "
          f"{graphed['backends']}; k={CHAIN} captured "
          f"{graphed['samples_per_s_steady']:.1f} samples/s steady (replays "
          f"{graphed['replays']}, eager steps {graphed['eager_steps']}, "
          f"capture {graphed['capture_s']:.3f} s) vs k=1 eager "
          f"{eager['samples_per_s_steady']:.1f}; losses graphed vs eager "
          f"{same:.3e} (limit {SAME_PATH_RTOL}), vs the in-process fit "
          f"{[f'{v:.3e}' for v in vs_single]} (limit {GANG_RESUME_RTOL}); "
          f"peak memory_allocated a rank captured "
          f"{graphed['max_memory_allocated']} vs eager "
          f"{eager['max_memory_allocated']} bytes; nccl kernels "
          f"{fmt_shares(graphed['chain_nccl_share'])} of a replayed chain's "
          f"device time a rank")
    require(all(b == "nccl" for b in graphed["backends"] + eager["backends"]),
            f"{label}: backends {graphed['backends']} {eager['backends']}")
    require(all(r > 0 for r in graphed["replays"]),
            f"{label}: no graph replayed: {graphed['replays']}")
    require(all(r == 0 for r in eager["replays"]),
            f"{label} k=1: replays {eager['replays']}")
    require(same <= SAME_PATH_RTOL, f"{label} graphed vs eager: {out}")
    require(max(vs_single) <= GANG_RESUME_RTOL, f"{label}: {out}")
    if byte_limit:
        require(max(shares) <= SHARD_BYTES_LIMIT, f"{label} bytes: {out}")
    return out


def nccl_replicated(train, test, features, single: list) -> dict:
    """(b) The replicated NYCTaxi gang, 2 ranks, one card each, at
    k=CHAIN: graphs replayed, losses within GANG_RESUME_RTOL of the
    in-process fit."""
    from raydp_tpu_torch.examples.nyctaxi_mlp import build_estimator

    got = gang_of("cards (b) replicated", build_estimator(
        features, GANG_BATCH, CARD_EPOCHS, None), train, test, 2, CHAIN,
        profile=True)
    check_dispatch("cards (b)", got["result"], CHAIN)
    diffs = [abs(a - b) / abs(b) for a, b in zip(got["losses"], single)]
    out = {k: v for k, v in got.items() if k != "result"}
    out["vs_single"] = diffs
    print(f"cards (b) replicated NYCTaxi: 2 ranks, one card each, backend "
          f"{got['backends']}, k={CHAIN} {got['samples_per_s_steady']:.1f} "
          f"samples/s steady, replays {got['replays']}, capture "
          f"{got['capture_s']:.3f} s; losses vs the in-process fit "
          f"{[f'{v:.3e}' for v in diffs]} (limit {GANG_RESUME_RTOL}); nccl "
          f"kernels {fmt_shares(got['chain_nccl_share'])} of a replayed chain's "
          f"device time a rank; fit_gang "
          f"{got['fit_gang_s']:.3f} s")
    require(all(b == "nccl" for b in got["backends"])
            and all(r > 0 for r in got["replays"]), f"cards (b): {out}")
    require(max(diffs) <= GANG_RESUME_RTOL, f"cards (b): {out}")
    return out


def nccl_agent_gang(train, test, features, replicated: dict,
                    tmp: str) -> dict:
    """(j) (b)'s replicated gang with rank 1 on a node agent of this host
    that holds the last card (``CUDA_VISIBLE_DEVICES=3``, ``--resource
    GPU=1``), rank 0 on this process's node (SPREAD): each rank on a card
    of its own under nccl, rank 1's the agent's card (its UUID), the chains
    replayed, and the train losses bitwise (b)'s (a sum of two gradients
    does not depend on their order, so the pair of cards cannot move a
    bit)."""
    import os

    from raydp_tpu_torch.examples.nyctaxi_mlp import build_estimator
    from raydp_tpu_torch.runtime import get_runtime

    cards = torch.cuda.device_count()
    card = last_card(cards)
    want_uuid = str(torch.cuda.get_device_properties(cards - 1).uuid)
    records = os.path.join(tmp, "cards-j-ranks")
    os.makedirs(records)
    agent = NodeAgent(get_runtime(), os.path.join(tmp, "agent-j.log"),
                      card=card)
    try:
        agent.spread_from_head()
        got = gang_of("cards (j) agent", build_estimator(
            features, GANG_BATCH, CARD_EPOCHS, None), train, test, 2, CHAIN,
            profile=False, callbacks=[record_rank(records)])
    finally:
        agent.stop()
    check_dispatch("cards (j)", got["result"], CHAIN)
    parents = rank_parents(records)
    uuids = [parents.get(r, [(None, None, None)])[0][2] for r in (0, 1)]
    out = {k: v for k, v in got.items() if k != "result"}
    out.update({"agent": {"pid": agent.pid, "card": card,
                          "start_s": agent.start_s},
                "rank_parents": {str(r): v for r, v in parents.items()},
                "uuids": uuids, "card_uuid": want_uuid,
                "bitwise_b": got["losses"] == replicated["losses"]})
    print(f"cards (j) replicated NYCTaxi with rank 1 on a node agent that "
          f"holds card {card} (joined in {agent.start_s:.3f} s): backend "
          f"{got['backends']}, rank (pid, parent, card) {parents}, card "
          f"{card}'s UUID {want_uuid}; k={CHAIN} "
          f"{got['samples_per_s_steady']:.1f} samples/s steady vs (b)'s "
          f"{replicated['samples_per_s_steady']:.1f}, replays "
          f"{got['replays']}; train losses bitwise (b)'s: "
          f"{out['bitwise_b']}; fit_gang {got['fit_gang_s']:.3f} s")
    require(all(b == "nccl" for b in got["backends"])
            and all(r > 0 for r in got["replays"]), f"cards (j): {out}")
    require(len(parents.get(1, [])) == 1
            and parents[1][0][1] == agent.pid
            and all(pp == os.getpid() for _, pp, _ in parents.get(0, [])),
            f"cards (j): rank 1 is not the agent's child: {out}")
    require(None not in uuids and uuids[0] != uuids[1]
            and uuids[1] == want_uuid, f"cards (j) cards: {out}")
    require(out["bitwise_b"], f"cards (j) losses: {out}")
    return out


def nccl_dlrm() -> dict:
    """(e) Phase 14 (c)'s expert=2 DLRM on two cards at k=CHAIN, captured:
    losses within SHARD_DLRM_RTOL of the in-process fit."""
    from raydp_tpu_torch.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu_torch.models import dlrm_param_rules
    from raydp_tpu_torch.runtime.object_store import get_client

    tables = criteo_tables(DLRM_ROWS, DLRM_BLOCKS, SEED)
    refs = get_client().put_arrow_many(tables)
    ds = DistributedDataset([BlockMeta(num_rows=t.num_rows, ref=r)
                             for t, r in zip(tables, refs)], tables[0].schema)
    model = dlrm_model(SHARD_DLRM_VOCAB)
    with device_cache(False):
        single = losses_of(dlrm_estimator(model, CARD_EPOCHS, [],
                                          shuffle=False).fit(ds))
    got = gang_of("cards (e) dlrm expert=2", dlrm_estimator(
        model, CARD_EPOCHS, [], shuffle=False,
        mesh_spec=dict(expert=2), param_rules=dlrm_param_rules("expert")),
        ds, None, 2, CHAIN, profile=True)
    check_dispatch("cards (e)", got["result"], CHAIN)
    diffs = [abs(a - b) / abs(b) for a, b in zip(got["losses"], single)]
    out = {k: v for k, v in got.items() if k != "result"}
    out["vs_single"] = diffs
    print(f"cards (e) DLRM expert=2: 2 ranks, one card each, backend "
          f"{got['backends']}, k={CHAIN} {got['samples_per_s_steady']:.1f} "
          f"samples/s steady, replays {got['replays']}, eager steps "
          f"{got['eager_steps']}, capture {got['capture_s']:.3f} s; losses "
          f"vs the in-process fit {[f'{v:.3e}' for v in diffs]} (limit "
          f"{SHARD_DLRM_RTOL}); nccl kernels "
          f"{fmt_shares(got['chain_nccl_share'])} of a replayed chain's device "
          f"time a rank")
    require(all(b == "nccl" for b in got["backends"])
            and all(r > 0 for r in got["replays"]), f"cards (e): {out}")
    require(max(diffs) <= SHARD_DLRM_RTOL, f"cards (e): {out}")
    return out


def grad_distances(got: dict, want: dict) -> dict:
    """Each parameter's L2 distance between two steps' gradients, in f32."""
    return {n: (got[n].float() - w.float()).norm().item()
            for n, w in want.items()}


def worst_ratio(dist: dict, own: dict) -> tuple:
    """(the largest ``dist[n] / own[n]``, its parameter ``n``)."""
    return max((dist[n] / own[n] if own[n] else
                (math.inf if dist[n] else 0.0), n) for n in own)


def lm_split_rank(ctx) -> dict:
    """(f) in one rank of a 2-rank job, one card a rank: rank 0 first takes
    NCCL_LM_STEPS unsharded Adam steps of the full TransformerLM in bf16,
    keeping each step's gradients, and the same steps in f32 (the f32
    flash kernels), whose gradients give bf16's own distance a parameter
    and step; then both ranks take the steps under tensor=2 and under
    seq=2, after an untimed forward and backward: the first step timed,
    the last profiled, each kernel's launches over the steps counted, and
    each step's reduced gradients gathered whole and measured against the
    unsharded step's on rank 0."""
    from raydp_tpu_torch import resolve_device
    from raydp_tpu_torch.models import (
        TransformerLM, lm_loss, transformer_param_rules,
    )
    from raydp_tpu_torch.ops import flash_attention as fa
    from raydp_tpu_torch.parallel import ShardedModule, make_mesh

    device = resolve_device()

    def model(dtype, attention="flash", mesh=None):
        return TransformerLM(VOCAB, dim=DIM, num_heads=HEADS,
                             num_layers=LAYERS, attention=attention,
                             mesh=mesh, dtype=dtype, device=device,
                             generator=torch.Generator(device).manual_seed(
                                 SEED))

    tokens = torch.randint(0, VOCAB, (BATCH, SEQ), device=device,
                           generator=torch.Generator(device).manual_seed(
                               SEED + 1))

    def whole_grads(m) -> dict:
        """The step's gradients by parameter name, whole: a sharded
        module's gathered (a collective: every rank calls it)."""
        if not isinstance(m, ShardedModule):
            return {n: p.grad for n, p in m.named_parameters()}
        grads = {n: p.grad for n, p in m.module.named_parameters()}
        return m.gather_state({"model": grads})["model"]

    def adam_steps(m, tok, mesh=None, profile=None, on_grads=None) -> dict:
        """The steps on ``m``, ``on_grads(i, whole_grads(m))`` after step
        ``i`` (untimed); with ``profile`` (a name every rank passes alike)
        the last runs under :func:`profiled`."""
        opt = torch.optim.Adam(m.parameters(), lr=LR)
        losses, walls, split = [], [], None
        for i in range(NCCL_LM_STEPS):
            def step():
                opt.zero_grad(set_to_none=True)
                loss = lm_loss(m(tok), tok, mesh)
                loss.backward()
                if isinstance(m, ShardedModule):
                    m.reduce_grads()
                opt.step()
                return loss
            if profile and i == NCCL_LM_STEPS - 1:
                loss, split = profiled(f"lm-{profile}", step)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = step()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            losses.append(loss.item())
            on_grads(i, whole_grads(m))
        return {"losses": losses, "walls": walls, "split": split}

    out, want = {}, []
    if ctx.rank == 0:
        ref = model(torch.bfloat16)
        out["unsharded"] = adam_steps(
            ref, tokens, on_grads=lambda i, g: want.append(g))
        del ref
        free_memory()
        f32 = model(torch.float32)
        own = []
        out["f32"] = adam_steps(
            f32, tokens,
            on_grads=lambda i, g: own.append(grad_distances(g, want[i])))
        out["own"] = own
        del f32
        free_memory()
    for name, spec in (("tensor", dict(tensor=2)), ("seq", dict(seq=2))):
        mesh = make_mesh(spec)
        if name == "tensor":
            sm = ShardedModule(model(torch.bfloat16), mesh,
                               transformer_param_rules("tensor"))
            tok, loss_mesh = tokens, None
        else:
            sm = ShardedModule(model(torch.bfloat16, "ring", mesh), mesh)
            c = mesh.coords["seq"]
            tok = tokens[:, c * SEQ // 2:(c + 1) * SEQ // 2].contiguous()
            loss_mesh = mesh
        lm_loss(sm(tok), tok, loss_mesh).backward()
        sm.zero_grad(set_to_none=True)
        zero_launches(fa)
        torch.cuda.reset_peak_memory_stats(device)
        got = []

        def measured(i, g):
            if ctx.rank == 0:
                got.append(grad_distances(g, want[i]))

        res = adam_steps(sm, tok, loss_mesh, profile=name, on_grads=measured)
        res["launches"] = launches(fa)
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        res["grad_distance"] = got
        out[name] = res
        del sm
        free_memory()
    return out


def nccl_lm() -> dict:
    """(f) The full TransformerLM under tensor=2, then seq=2, two ranks,
    one card each: phase 14 (d)'s and 15 (b)'s gates against the unsharded
    steps on rank 0's card, each kernel's launches a rank (H=4 under
    tensor, the causal ring's blocks under seq), each step's wall and the
    nccl kernels' share of its device time.

    14 (d) and 15 (b) hold the parameters after one SGD step, which differ
    by the learning rate times the gradients' difference. Adam moves every
    parameter by about its rate a step whatever the gradient, so here each
    Adam step's gradients are held instead: a parameter's distance from
    the unsharded step's (L2, in f32) within ``TP_PARAM_BF16_STEPS`` times
    bf16's own, the f32 step's from the unsharded bf16 step's."""
    from raydp_tpu_torch.spmd import create_spmd_job

    job = create_spmd_job("smoke-lm-cards", 2, torch_distributed=True,
                          gpus_per_process=1, timeout=180)
    job.start()
    try:
        ranks = job.run(lm_split_rank, timeout=900)
    finally:
        job.stop()
    r0 = ranks[0]
    out = {"ranks": ranks}
    want_launches = {"tensor": [LAYERS * NCCL_LM_STEPS] * 2,
                     # the causal ring: rank 0 folds its own block, rank 1
                     # both
                     "seq": [LAYERS * NCCL_LM_STEPS,
                             2 * LAYERS * NCCL_LM_STEPS]}
    for name in ("tensor", "seq"):
        got = [r[name] for r in ranks]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(
            got[0]["losses"], r0["unsharded"]["losses"]))
        ratios = [worst_ratio(d, own)
                  for d, own in zip(got[0]["grad_distance"], r0["own"])]
        out[name] = {"loss_rel_diff": loss_rel,
                     "grad_ratio": [[r, n] for r, n in ratios],
                     "launches": [g["launches"] for g in got],
                     "step_s": [g["walls"] for g in got],
                     "split": [g["split"] for g in got]}
        print(f"cards (f) TransformerLM {name}=2 (dim {DIM}, {HEADS} heads, "
              f"{LAYERS} layers, T={SEQ}, {NCCL_LM_STEPS} Adam steps): losses "
              f"{[f'{v:.6f}' for v in got[0]['losses']]} vs unsharded "
              f"{[f'{v:.6f}' for v in r0['unsharded']['losses']]} ({loss_rel:.3e}, "
              f"limit {TP_LOSS_RTOL}; f32 "
              f"{[f'{v:.6f}' for v in r0['f32']['losses']]}); each step's "
              f"gradients, the worst parameter's distance from the "
              f"unsharded step's over bf16's own "
              f"{[f'{r:.3f} ({n})' for r, n in ratios]} (limit "
              f"{TP_PARAM_BF16_STEPS}); "
              f"flash launches a rank {out[name]['launches']}; first step "
              f"{[round(g['walls'][0], 4) for g in got]} s, the profiled "
              f"step {[round(g['split']['wall_ms'], 3) for g in got]} ms, "
              f"nccl kernels {[round(g['split']['nccl_ms'], 3) for g in got]} "
              f"ms of device busy "
              f"{[round(g['split']['busy_ms'], 3) for g in got]} ms "
              f"({fmt_shares(g['split']['nccl_share'] for g in got)}); peak "
              f"memory {[g['max_memory_allocated'] for g in got]} bytes")
        require(loss_rel <= TP_LOSS_RTOL, f"cards (f) {name} loss: {out}")
        require(len(ratios) == NCCL_LM_STEPS
                and all(r <= TP_PARAM_BF16_STEPS for r, _ in ratios),
                f"cards (f) {name} gradients: {out[name]}")
        require(all(g["launches"] == dict.fromkeys(KERNELS, n)
                    for g, n in zip(got, want_launches[name])),
                f"cards (f) {name} launches: {out[name]['launches']}, "
                f"expected {want_launches[name]} of each")
    return out


def ring_rank(ctx) -> dict:
    """(g) in one rank: phase 15 (a)'s ring, then one more forward and
    backward profiled."""
    from raydp_tpu_torch import resolve_device

    return ring_case(ctx, resolve_device(), profile=True)


def nccl_ring(phase15: Optional[dict]) -> dict:
    """(g) The ring at the flagship shape over seq=2, two ranks, one card
    each: phase 15 (a)'s gates, its wall, the nccl kernels' share of a
    forward and backward's device time, the bytes a rank sends; beside
    15 (a)'s gloo ranks sharing card 0 when phase 15 ran in this call."""
    from raydp_tpu_torch.spmd import create_spmd_job

    job = create_spmd_job("smoke-ring-cards", 2, torch_distributed=True,
                          gpus_per_process=1, timeout=180)
    job.start()
    try:
        ring = job.run(ring_rank, timeout=600)
    finally:
        job.stop()
    r0 = ring[0]
    gloo = phase15["ring"] if phase15 else None
    out = {"ranks": ring}
    print(f"cards (g) ring B,T,H,D={RING_SHAPE} bf16 causal over seq=2, one "
          f"card a rank: against one flash_attention call, relative L2 "
          f"{ {k: f'{v:.3e}' for k, v in r0['ring_vs_flash'].items()} } "
          f"(limit {SPLIT_BF16_STEPS}x bf16's own "
          f"{ {k: f'{v:.3e}' for k, v in r0['flash_vs_f32'].items()} }); "
          f"launches a rank {[r['launches'] for r in ring]}; forward+"
          f"backward {[round(r['wall_s'], 5) for r in ring]} s (the first "
          f"{[round(r['first_wall_s'], 4) for r in ring]}); profiled "
          f"{[round(r['device']['wall_ms'], 3) for r in ring]} ms, nccl "
          f"kernels {[round(r['device']['nccl_ms'], 3) for r in ring]} ms of "
          f"device busy {[round(r['device']['busy_ms'], 3) for r in ring]} "
          f"ms ({fmt_shares(r['device']['nccl_share'] for r in ring)}); "
          f"{[r['sent_bytes'] for r in ring]} bytes sent a rank"
          + (f"; phase 15 (a)'s gloo ranks sharing card 0 in this call: "
             f"{[round(r['wall_s'], 4) for r in gloo]} s, of it in the "
             f"exchanges {[round(r['exchange_s'], 4) for r in gloo]} s"
             if gloo else ""))
    require(all(r0["ring_vs_flash"][k]
                <= SPLIT_BF16_STEPS * r0["flash_vs_f32"][k]
                for k in r0["ring_vs_flash"]), f"cards (g) ring: {r0}")
    require([r["launches"] for r in ring] == [
        dict.fromkeys(KERNELS, 1), dict.fromkeys(KERNELS, 2)],
        f"cards (g) ring launches: {ring}")
    return out


def run_cards(fa, phase13: dict, phase15: Optional[dict], frames,
              tmp: str) -> dict:
    """Phase 16: one card a rank, under nccl — (a) the runner, (b) the
    replicated gang, (j) the same with rank 1 on a node agent that holds
    card 3, (c) fsdp=2, (d) data=2 x fsdp=2 over four cards,
    (e) expert=2 DLRM, (f) the full TransformerLM under tensor=2 and seq=2,
    (g) the ring, (h) the staged pipeline, (i) the sharded crash and
    resume, each gang's chains captured. Needs CARD_RANKS cards; the
    driver launches no flash kernel, (f) and (g)'s ranks count theirs."""
    from raydp_tpu_torch.examples.nyctaxi_mlp import build_estimator

    cards = torch.cuda.device_count()
    require(cards >= CARD_RANKS, f"phase 16 needs {CARD_RANKS} cards, one a "
            f"rank; {cards} visible")
    t_phase = time.perf_counter()
    zero_launches(fa)
    train, test, features = frames
    single = phase13["resume"]["single_losses"]
    out = {"runner": card_runner()}
    out["replicated"] = nccl_replicated(train, test, features,
                                        single[:CARD_EPOCHS])
    out["agent"] = nccl_agent_gang(train, test, features, out["replicated"],
                                   tmp)
    for key, label, spec, ranks in (
            ("fsdp", "cards (c) fsdp=2", dict(fsdp=2), 2),
            ("data_fsdp", "cards (d) data=2 x fsdp=2", dict(data=2, fsdp=2),
             4)):
        out[key] = captured_against_eager(
            label, lambda spec=spec: build_estimator(
                features, GANG_BATCH, CARD_EPOCHS, None, mesh_spec=spec),
            train, test, ranks, single[:CARD_EPOCHS], byte_limit=True)
    out["dlrm"] = nccl_dlrm()
    free_memory()
    out["lm"] = nccl_lm()
    out["ring"] = nccl_ring(phase15)
    out["resume"] = shard_resume(train, test, features, tmp, phase13,
                                 label="cards (i)", chain=CHAIN)
    # last: the one gang whose captured chain holds point-to-point sends
    out["pipeline"] = pipeline_estimator("cards (h)", chain=PIPE_EST_CHAIN,
                                         remat="full")
    counts = launches(fa)
    print(f"cards launches of the flash kernels in the driver: {counts}")
    require(not any(counts.values()), f"phase 16's driver launched {counts}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"cards phase: {out['phase_s']:.3f} s")
    print("cards " + json.dumps(out, default=str))
    return out


def example_losses() -> dict:
    """What phase 13 (c) takes from phase 12 when phase 12 did not run in
    this call: the NYCTaxi example's single-process run at its defaults."""
    from raydp_tpu_torch.examples import nyctaxi_mlp

    history = nyctaxi_mlp.main([])["history"]
    out = {"losses": [r["train_loss"] for r in history],
           "eval_losses": [r["eval_loss"] for r in history],
           "samples_per_s_steady": steady_rate(history[1:])}
    print(f"example nyctaxi (for phase 13): losses "
          f"{[round(v, 6) for v in out['losses']]}, "
          f"{out['samples_per_s_steady']:.1f} samples/s steady")
    return {"nyctaxi": out}


def gang_inputs(frames, world1: bool) -> dict:
    """What phases 14 and 16 take from phase 13 when phase 13 did not run
    in this call: (d)'s in-process fit on the frames and, for phase 14
    (a) (``world1``), (b)'s 1-rank nccl gang."""
    from raydp_tpu_torch.examples.nyctaxi_mlp import build_estimator

    train, test, features = frames
    est = build_estimator(features, GANG_BATCH, GANG_RESUME_EPOCHS, None)
    est.shuffle = False
    with device_cache(False):
        single = est.fit(train, test)
    out = {"resume": {"single_losses": losses_of(single)}}
    print(f"gang in-process fit (for phases 14, 16): losses "
          f"{[round(v, 6) for v in out['resume']['single_losses']]}")
    if world1:
        out["nccl"] = gang_nccl(train, test, features)
    return out


#: the phases a run with no --phases runs (16 needs CARD_RANKS cards)
DEFAULT_PHASES = frozenset(range(2, 16))
#: a stand-in for a yardstick rate of a phase that did not run in this call
NOT_RUN = {"samples_per_s_steady": math.nan}


def phase_list(text: str) -> frozenset:
    phases = frozenset(int(p) for p in text.split(",") if p.strip())
    unknown = sorted(phases - frozenset(range(1, 17)))
    if unknown:
        raise ValueError(f"no phase {unknown}: phases are 1-16")
    return phases


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--baseline", metavar="DIR",
        help="another checkout (e.g. the parent commit unpacked with git "
             "archive) whose three kernels are built and timed against "
             "this checkout's at the flagship shape, in turns")
    parser.add_argument(
        "--phases", type=phase_list, metavar="N,N,...",
        help="run phase 1 (the build) and only these phases (default: "
             "2-15; 16 needs four cards); a phase whose input comes from "
             "one not named computes that input itself, and a yardstick "
             "rate from one not named prints as nan")
    args = parser.parse_args()
    phases = args.phases if args.phases is not None else DEFAULT_PHASES
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 1
    from raydp_tpu_torch import resolve_device
    from raydp_tpu_torch.ops import flash_attention as fa

    def card_lines() -> str:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()

    cards = card_lines()
    card = cards.splitlines()[0]
    print(cards)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"card(s); phases {sorted(phases)}")
    device = resolve_device()

    baseline = build_kernels(fa, args.baseline)
    rows = {}
    if 2 in phases:
        gen = torch.Generator(device=device).manual_seed(SEED)
        rows = {"flash_attention_fwd": check_kernel(fa, device, gen,
                                                    baseline),
                **check_bwd_kernels(fa, device, gen, baseline)}
    # phases 5-15 are bound by the host's kernel launches: their timed
    # fits and requests run before any torch.profiler session of this
    # process (phases 3-4 profile, and so do 5-6 at their end), so no
    # profiler hook is left in the launch path while they are timed
    done, profiles = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        if 5 in phases:
            free_memory()
            done["nyctaxi"], profiles["nyctaxi"] = run_nyctaxi(fa, tmp)
        if 6 in phases:
            free_memory()
            done["dlrm"], profiles["dlrm"] = run_dlrm(fa)
        if 7 in phases:
            free_memory()
            done["store"] = run_store(fa, card)
        if 8 in phases:
            free_memory()
            done["etl"] = run_etl(
                fa, done.get("nyctaxi", {"f32_resident": NOT_RUN}),
                done.get("dlrm", {"bf16_streaming": NOT_RUN}), tmp)
        if 9 in phases:
            free_memory()
            done["dispatch"] = run_dispatch(fa, tmp)
        if 10 in phases:
            free_memory()
            done["serving"] = run_serving(fa, tmp)
        if 11 in phases:
            free_memory()
            done["gbdt"], profiles["gbdt"] = run_gbdt(fa, tmp)
        if 12 in phases:
            free_memory()
            done["examples"] = run_examples(
                fa, done.get("etl", {"nyctaxi": NOT_RUN}), tmp)

        def later(phase13, frames):
            """Phases 14-16 on phase 13's frames, before their session
            stops."""
            if 14 in phases:
                done["sharding"] = run_sharding(fa, phase13, frames, tmp)
            if 15 in phases:
                done["longctx"] = run_long_context(fa)
            if 16 in phases:
                free_memory()
                done["cards"] = run_cards(fa, phase13, done.get("longctx"),
                                          frames, tmp)

        if 13 in phases:
            free_memory()
            done["gang"], _ = run_gang(
                fa, done.get("examples") or example_losses(), tmp, later)
        elif phases & {14, 16}:
            free_memory()
            with gang_frames(tmp) as frames:
                later(gang_inputs(frames, 14 in phases), frames)
        elif 15 in phases:
            done["longctx"] = run_long_context(fa)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the profiled epochs replay graphs: the idle share of a graphed epoch
    for name, profile in profiles.items():
        done[name]["profile"] = profile()
    print("main path " + json.dumps(done, default=str))
    lm = train = None
    if 3 in phases:
        free_memory()
        lm = run_lm(fa, device)
    if 4 in phases:
        free_memory()
        train = run_train(fa, device)
        free_memory()
        check_grads(device)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        k = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces,
             "launches": train["launches"][name] if train else None,
             **{key: rows[name][key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "tflops", "bound_share", "baseline_ms",
                 "speedup") if name in rows and key in rows[name]}}
        if "sharding" in done:
            # phase 14 (d): each tensor rank's attention at HEADS / 2 heads
            k["launches_tensor_parallel"] = [
                r["launches"][name] for r in done["sharding"]["lm"]["ranks"]]
        if "longctx" in done:
            # phase 15 (b) and (c), a rank: the TransformerLM's step over
            # seq=2 (the ring) and pipeline_apply over stage=2
            k["launches_ring"] = [r["launches"][name]
                                  for r in done["longctx"]["lm"]["ranks"]]
            k["launches_pipeline"] = [r["launches"][name]
                                      for r in done["longctx"]["pipeline"]]
        if "cards" in done:
            # phase 16 (f), a rank on a card of its own: the full
            # TransformerLM's steps under tensor=2 and under seq=2
            for mesh in ("tensor", "seq"):
                k[f"launches_nccl_{mesh}"] = [
                    r[name] for r in done["cards"]["lm"][mesh]["launches"]]
        kernels.append(k)
    if lm:
        kernels[0]["launches_inference"] = lm["launches"]
    print(cards)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
