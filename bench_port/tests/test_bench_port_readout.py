"""The readout follows the step runner's calls: a one-step cell through
its second replay, a chained cell through its first replayed chain, whose
steps run no Python and report once, at the chain's end."""

import pytest
import torch

from bench_port import program, spec

LEAVES = [("w", (4, 3), ("normal", 1.0))]


def _readout(steps, chain):
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.empty(4, 3))
    params = program.write_weights(model, LEAVES, 5)
    r = program.Readout(params, LEAVES, 5, steps=steps,
                        steps_per_replay=chain)
    r._loss = torch.tensor(2.0)
    return r, params


@pytest.mark.parametrize("workload,steps", [("dlrm-mlperf.resident", 3),
                                            ("nyctaxi-mlp.resident", 3),
                                            ("dlrm-mlperf.stream", 16)])
def test_checked_steps_end_in_a_replay(workload, steps):
    mix = spec.cell(workload)["mix"]
    assert program.checked_steps(mix) == steps
    # the eager first call, then at least one replayed call
    assert steps >= 2 * program.chain_steps(mix)


def test_a_chain_is_read_after_its_replay():
    r, params = _readout(16, 8)
    for _ in range(8):              # the eager chain's optimizer steps
        r._post(None, (), {})
    assert not r.done
    with torch.no_grad():
        params["w"][1:3] += 1.0
    r._steps_ended(8)               # what the wrapped replay reports
    assert r.done and r.error is None
    assert r.trajectory.losses == [2.0] * 8 + [None] * 7 + [2.0]
    assert r.trajectory.moved_rows == {"w": 2}
    assert r.trajectory.change_norms["w"] == pytest.approx(6 ** 0.5)


def test_a_replay_past_the_checked_steps_is_an_error():
    r, _ = _readout(3, 8)
    r._post(None, (), {})
    r._steps_ended(8)
    assert not r.done and "ran past" in r.error
