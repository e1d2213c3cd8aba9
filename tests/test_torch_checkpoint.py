"""raydp_tpu_torch.train.checkpoint: the reference's one-process step-dir
layout and its restore semantics (torn dirs, retention bounded at the
written step, ``max_step``, the JSON sidecar), a bitwise round trip of a
module's and an optimizer's state, and the gang's side: ``ensure_shared_dir``
and a save that rank 0 alone writes and both ranks restore."""

import json
import os

import numpy as np
import pytest
import torch

from raydp_tpu_torch.models import NYCTaxiModel
from raydp_tpu_torch.train import checkpoint as ckpt


def _state(value: float):
    return {"model": {"w": torch.full((3, 2), value),
                      "b": torch.arange(4, dtype=torch.bfloat16) + value},
            "optimizer": {"state": {0: {"step": torch.tensor(value)}},
                          "param_groups": [{"lr": 0.1, "params": [0]}]}}


def test_layout_is_the_reference_one_process_format(tmp_path):
    path = ckpt.save(str(tmp_path), _state(1.0), step=3,
                     extra={"history": [{"epoch": 0}]})
    assert path == str(tmp_path / "step_3")
    assert sorted(os.listdir(path)) == ["COMPLETE", "extra.json",
                                        "manifest_0.json", "shard_0.npz"]
    manifest = json.loads((tmp_path / "step_3" / "manifest_0.json")
                          .read_text())
    assert [e["key"] for e in manifest] == [
        "['model']['w']", "['model']['b']",
        "['optimizer']['state'][0]['step']"]
    w = manifest[0]
    assert w == {"key": "['model']['w']", "arr": "a0",
                 "index": [[0, 3], [0, 2]], "shape": [3, 2],
                 "dtype": "float32"}
    assert manifest[1]["dtype"] == "bfloat16"
    with np.load(tmp_path / "step_3" / "shard_0.npz") as npz:
        assert npz["a0"].dtype == np.uint8 and npz["a0"].size == 24


def test_round_trip_is_bitwise_for_module_and_optimizer(tmp_path):
    model = NYCTaxiModel(5, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    x, y = torch.randn(32, 5), torch.randn(32)
    for _ in range(3):      # optimizer state and BatchNorm buffers move
        opt.zero_grad()
        ((model.train()(x)[:, 0] - y) ** 2).mean().backward()
        opt.step()
    state = {"model": model.state_dict(), "optimizer": opt.state_dict()}
    ckpt.save(str(tmp_path), state, step=0)

    fresh = NYCTaxiModel(5, device="cpu",
                         generator=torch.Generator().manual_seed(9))
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-3)
    restored, step = ckpt.restore(str(tmp_path), state)
    assert step == 0
    fresh.load_state_dict(restored["model"])
    fresh_opt.load_state_dict(restored["optimizer"])
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    got = fresh_opt.state_dict()
    for i, s in opt.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    assert got["param_groups"] == opt.state_dict()["param_groups"]


def test_bf16_and_missing_leaves(tmp_path):
    ckpt.save(str(tmp_path), _state(2.0), step=0)
    restored, _ = ckpt.restore(str(tmp_path), _state(0.0))
    assert torch.equal(restored["model"]["b"], _state(2.0)["model"]["b"])
    assert restored["optimizer"]["param_groups"] == [{"lr": 0.1,
                                                      "params": [0]}]
    template = _state(0.0)
    template["model"]["extra"] = torch.zeros(1)
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(str(tmp_path), template)


def test_torn_dir_is_skipped(tmp_path):
    ckpt.save(str(tmp_path), _state(1.0), step=1)
    ckpt.save(str(tmp_path), _state(2.0), step=2)
    os.remove(tmp_path / "step_2" / "COMPLETE")   # a write cut short
    assert ckpt._step_dirs(str(tmp_path)) == [(1, str(tmp_path / "step_1"))]
    restored, step = ckpt.restore(str(tmp_path), _state(0.0))
    assert step == 1 and float(restored["model"]["w"][0, 0]) == 1.0


def test_prune_keeps_two_at_or_below_the_written_step(tmp_path):
    for step in (9, 1, 2, 3):       # step 9: a stale dir of an earlier run
        ckpt.save(str(tmp_path), _state(float(step)), step=step)
    steps = [s for s, _ in ckpt._step_dirs(str(tmp_path),
                                           complete_only=False)]
    assert ckpt._KEEP == 2
    assert steps == [2, 3, 9]


def test_max_step_leaves_stale_higher_steps_alone(tmp_path, monkeypatch):
    ckpt.save(str(tmp_path), _state(9.0), step=9)
    warnings = []
    monkeypatch.setattr(ckpt.logger, "warning",
                        lambda msg, *args: warnings.append(msg % args))
    ckpt.warn_if_reused_dir(str(tmp_path))
    assert len(warnings) == 1 and "already contains 1 step_*" in warnings[0]
    ckpt.save(str(tmp_path), _state(0.0), step=0,
              extra={"history": [{"epoch": 0, "train_loss": 1.5}]})
    restored, step = ckpt.restore(str(tmp_path), _state(-1.0), max_step=0)
    assert step == 0 and float(restored["model"]["w"][0, 0]) == 0.0
    assert ckpt.restore(str(tmp_path), _state(-1.0))[1] == 9
    assert ckpt.restore_extra(str(tmp_path), max_step=0) == {
        "history": [{"epoch": 0, "train_loss": 1.5}]}
    assert ckpt.restore_extra(str(tmp_path)) is None   # step 9: no sidecar
    assert ckpt.restore(str(tmp_path / "none"), _state(0.0)) is None


def test_ensure_shared_dir_single_process_creates_the_dir(tmp_path):
    target = tmp_path / "a" / "b"
    ckpt.ensure_shared_dir(str(target), "probe")
    assert target.is_dir()
    ckpt.ensure_shared_dir(str(target), "probe")    # idempotent


def test_gang_save_is_rank_0_s_and_every_rank_restores(tmp_path):
    """In a 2-rank gloo gang both ranks call ``save`` with states that
    differ (rank 1's is a decoy); only rank 0's is written, it is complete
    when ``save`` returns on either rank, and both ranks restore it."""
    from raydp_tpu_torch.spmd import create_spmd_job

    ckpt_dir = str(tmp_path / "ck")

    def save_and_restore(ctx, ckpt_dir=ckpt_dir):
        ckpt.ensure_shared_dir(ckpt_dir, "probe")
        path = ckpt.save(ckpt_dir, _state(float(ctx.rank * 10 + 1)), step=2,
                         extra={"rank": ctx.rank}, gang=True)
        complete = os.path.exists(os.path.join(path, "COMPLETE"))
        state, step = ckpt.restore(ckpt_dir, _state(0.0))
        return (complete, step, state["model"]["w"][0, 0].item(),
                ckpt.restore_extra(ckpt_dir)["rank"])

    job = create_spmd_job("t-ckpt", 2, torch_distributed=True, timeout=120)
    job.start()
    try:
        got = job.run(save_and_restore, timeout=120)
    finally:
        job.stop()
    assert got == [(True, 2, 1.0, 0)] * 2
