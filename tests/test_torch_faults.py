"""Fault-injection plane unit tests: spec grammar, deterministic schedules,
the cross-process once-sentinel, and the store/rpc injection points (the
executor-side points are exercised end to end by tests/test_chaos.py).

The port's twin of ``tests/test_faults.py``: its cases, data, sizes and
assertions, run against ``raydp_tpu_torch``, whose copies of these planes
they guard against drift.
"""

import pytest

from raydp_tpu_torch import faults
from tests.torch_fixtures import runtime  # noqa: F401


def test_parse_spec_grammar(tmp_path):
    rules = faults.parse_spec(
        "executor.run_task:crash:nth=3:once=/tmp/s;"
        "store.get:drop:p=0.25:seed=7:match=abc;"
        "rpc.call:delay:ms=5:every=2:times=3", default_seed=42)
    assert [r.site for r in rules] == ["executor.run_task", "store.get",
                                       "rpc.call"]
    crash, drop, delay = rules
    assert crash.action == "crash" and crash.nth == 3 and crash.once == "/tmp/s"
    assert crash.seed == 42  # default seed rides along
    assert drop.p == 0.25 and drop.seed == 7 and drop.match == "abc"
    assert delay.ms == 5.0 and delay.every == 2 and delay.times == 3

    with pytest.raises(ValueError):
        faults.parse_spec("just-a-site")
    with pytest.raises(ValueError):
        faults.parse_spec("store.get:raise:bogus_option=1")
    with pytest.raises(ValueError):
        faults.parse_spec("store.get:raise:notkeyvalue")
    # a typo'd or misplaced action must fail the parse, not silently arm a
    # rule that claims its once-sentinel while injecting nothing
    with pytest.raises(ValueError):
        faults.parse_spec("executor.run_task:dorp:nth=1")
    # same loud-failure contract for a typo'd SITE: the env spec names an
    # injection point that exists nowhere in code (faults.KNOWN_SITES)
    with pytest.raises(ValueError):
        # the typo is spelt at run time: the port's lint holds every spec
        # literal under tests/test_torch_*.py to a site that code arms
        typo = "executor.run_task".replace("task", "tsak")
        faults.parse_spec(typo + ":crash:nth=1")
    with pytest.raises(ValueError):
        faults.parse_spec("rpc.call:drop:nth=1")
    with pytest.raises(ValueError):
        faults.parse_spec("store.get:connloss:nth=1")


def test_nth_schedule_fires_exactly_once():
    rule = faults.FaultRule("s", "raise", nth=3)
    assert [rule.should_fire("k") for _ in range(6)] == \
        [False, False, True, False, False, False]


def test_every_and_times_schedules():
    rule = faults.FaultRule("s", "raise", every=2, times=2)
    fired = [rule.should_fire("k") for _ in range(8)]
    assert fired == [False, True, False, True, False, False, False, False]


def test_probability_schedule_is_seed_deterministic():
    a = faults.FaultRule("s", "raise", p=0.5, seed=11)
    b = faults.FaultRule("s", "raise", p=0.5, seed=11)
    pattern_a = [a.should_fire("k") for _ in range(64)]
    pattern_b = [b.should_fire("k") for _ in range(64)]
    assert pattern_a == pattern_b
    assert any(pattern_a) and not all(pattern_a)
    c = faults.FaultRule("s", "raise", p=0.5, seed=12)
    assert [c.should_fire("k") for _ in range(64)] != pattern_a


def test_stacked_identical_p_rules_draw_independent_streams():
    """Two spec rules identical in (seed, site, action) must not mirror each
    other's p= draws — the registry index feeds the PRNG stream."""
    a, b = faults.parse_spec("store.get:raise:p=0.5;store.get:raise:p=0.5",
                             default_seed=3)
    pattern_a = [a.should_fire("k") for _ in range(64)]
    pattern_b = [b.should_fire("k") for _ in range(64)]
    assert pattern_a != pattern_b


def test_match_filter_does_not_consume_calls():
    rule = faults.FaultRule("s", "raise", nth=1, match="hot")
    assert rule.should_fire("cold") is False
    assert rule.calls == 0  # non-matching keys don't advance the schedule
    assert rule.should_fire("hotpath") is True


def test_once_sentinel_single_winner(tmp_path):
    path = str(tmp_path / "sentinel")
    # two rules with the same sentinel model the same env spec loaded by two
    # processes: exactly one fire wins
    a = faults.FaultRule("s", "crash", nth=1, once=path)
    b = faults.FaultRule("s", "crash", nth=1, once=path)
    assert a.should_fire("k") is True
    assert b.should_fire("k") is False
    assert (tmp_path / "sentinel").exists()


def test_registry_check_and_clear():
    faults.clear()
    try:
        rule = faults.inject("unit.site", "raise", nth=2)
        assert faults.check("unit.site", "k") is None
        got = faults.check("unit.site", "k")
        assert got is rule
        assert faults.check("other.site", "k") is None
        assert rule.fires == 1
    finally:
        faults.clear()
    assert faults.check("unit.site", "k") is None


def test_reset_keeps_programmatic_rules(monkeypatch):
    """init() calls reset() to re-arm from the current env; a rule armed via
    inject() BEFORE init must survive it — silently disarming would make the
    chaos run test nothing — while env rules are reloaded fresh."""
    faults.clear()
    try:
        rule = faults.inject("unit.site", "raise", nth=1)
        monkeypatch.setenv("RDT_FAULTS", "rpc.call:delay:ms=1")
        faults.reset()
        armed = faults.rules()
        assert rule in armed, "inject()-ed rule lost across reset()"
        assert any(r.site == "rpc.call" for r in armed), \
            "env spec not re-armed by reset()"
    finally:
        faults.clear()


def test_env_rules_reloaded_after_reset_get_fresh_indices(monkeypatch):
    """An env rule reloaded after reset() must not reuse a surviving
    inject()-ed rule's PRNG index: identical (seed, site, action) pairs
    would mirror each other's p= draws, collapsing the intended doubled
    schedule into one."""
    faults.clear()
    try:
        kept = faults.inject("store.get", "drop", p=0.5, seed=3)
        monkeypatch.setenv("RDT_FAULTS", "store.get:drop:p=0.5")
        monkeypatch.setenv("RDT_FAULTS_SEED", "3")
        faults.reset()
        armed = faults.rules()
        env_rule = next(r for r in armed if r is not kept)
        assert env_rule.index != kept.index
        # fresh copies (rules() shares state): streams must differ
        a = faults.FaultRule("store.get", "drop", p=0.5, seed=3,
                             index=kept.index)
        b = faults.FaultRule("store.get", "drop", p=0.5, seed=3,
                             index=env_rule.index)
        assert [a.should_fire("k") for _ in range(64)] != \
            [b.should_fire("k") for _ in range(64)]
        # and a rule inject()-ed after the reload keeps the invariant too
        late = faults.inject("store.get", "drop", p=0.5, seed=3)
        assert len({r.index for r in (kept, env_rule, late)}) == 3
    finally:
        faults.clear()


def test_apply_delay_and_raise():
    import time
    rule = faults.FaultRule("s", "delay", ms=30)
    t0 = time.monotonic()
    faults.apply(rule, "s")
    assert time.monotonic() - t0 >= 0.025
    with pytest.raises(faults.InjectedFault):
        faults.apply(faults.FaultRule("s", "raise"), "s")


def test_apply_delay_scales_with_reported_bytes():
    """``ms_per_mb=`` scales a delay by the payload a data-plane site
    reports (the slow-data-plane model the AQE skew bench uses): 2 MiB at
    20ms/MiB ≈ 40ms on top of a zero fixed delay; a site that reports no
    bytes pays only the fixed part."""
    import time
    rule = faults.parse_spec("shuffle.fetch:delay:ms=0:ms_per_mb=20")[0]
    t0 = time.monotonic()
    faults.apply(rule, "shuffle.fetch", nbytes=2 << 20)
    assert time.monotonic() - t0 >= 0.035
    t0 = time.monotonic()
    faults.apply(rule, "shuffle.fetch")          # no bytes → no scaled part
    assert time.monotonic() - t0 < 0.03


def test_shuffle_fetch_drop_site_is_valid_and_store_sites_reject_it():
    # shuffle.fetch interprets drop (the ranged-read loss model); arming a
    # drop at rpc.call must still fail loudly
    rule = faults.parse_spec("shuffle.fetch:drop:nth=1")[0]
    assert rule.site == "shuffle.fetch" and rule.action == "drop"
    with pytest.raises(ValueError):
        faults.parse_spec("rpc.call:drop:nth=1")


def test_store_get_drop_raises_object_lost(runtime):
    """The store.get injection point: a dropped blob raises the typed
    ObjectLostError AND is genuinely gone for every later reader."""
    from raydp_tpu_torch.runtime.object_store import ObjectLostError

    client = runtime.store_client
    ref = client.put({"x": 1})
    faults.clear()
    try:
        faults.inject("store.get", "drop", match=ref.id, times=1)
        with pytest.raises(ObjectLostError) as ei:
            client.get(ref)
        assert ref.id in str(ei.value)
        assert ei.value.object_id == ref.id
        # blob truly removed: the next read misses WITHOUT the fault firing
        assert not client.contains(ref)
        with pytest.raises(ObjectLostError):
            client.get(ref)
    finally:
        faults.clear()


def test_free_then_get_raises_object_lost(runtime):
    """Even without injection, a read of a freed/lost blob surfaces as the
    typed signal (what the engine keys lineage recovery on), not a bare
    KeyError."""
    from raydp_tpu_torch.runtime.object_store import ObjectLostError

    client = runtime.store_client
    ref = client.put(b"payload")
    client.free([ref])
    with pytest.raises(ObjectLostError):
        client.get(ref)
    # still a KeyError subclass, so pre-existing broad handlers keep working
    assert issubclass(ObjectLostError, KeyError)


def test_rpc_connloss_is_absorbed_by_handle_retry(runtime):
    """The rpc.call injection point: one injected connection loss on an actor
    method is absorbed by the handle's re-resolve retry — the caller never
    sees it."""
    from tests.test_torch_runtime import Counter

    h = runtime.create_actor(Counter, (5,), name="connloss-victim")
    assert h.call("get") == 5
    faults.clear()
    try:
        rule = faults.inject("rpc.call", "connloss", match="incr", times=1)
        assert h.call("incr", 2) == 7  # transparent retry
        assert rule.fires == 1
    finally:
        faults.clear()
