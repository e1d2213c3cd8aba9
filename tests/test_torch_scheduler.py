"""Straggler-proof stage scheduling units: least-loaded dispatch
with per-executor in-flight caps, locality-preserving retries, per-handle
down tracking, and speculative backup tasks — first finisher wins, the
loser's outputs drain through the late-result path.

These run against stub executor handles (no runtime), so they pin the
DRIVER-side scheduling contract; the end-to-end composition with real
executors and the fault plane lives in tests/test_chaos.py and the
``--straggler`` leg of benchmarks/shuffle_bench.py.

The port's twin of ``tests/test_scheduler.py``: its cases, data, sizes and
assertions, run against ``raydp_tpu_torch``, whose copies of these planes
they guard against drift.
"""

import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import pyarrow as pa

from raydp_tpu_torch.etl import engine as E
from raydp_tpu_torch.etl.engine import ExecutorPool
from raydp_tpu_torch.runtime.object_store import ObjectRef
from raydp_tpu_torch.runtime.rpc import ConnectionLost, RemoteError


class StubExecutor:
    """Actor-handle stand-in: ``submit`` returns a Future a timer resolves
    after ``latency`` seconds. ``script`` overrides per call, in order: the
    string ``"connlost"`` raises on submit; ``(delay, fn)`` runs ``fn(fut)``
    after ``delay`` (fn=None → the default ok result)."""

    def __init__(self, name=None, actor_id=None, latency=0.005):
        self.name = name
        if actor_id is not None:
            self.actor_id = actor_id
        self.latency = latency
        self.script = []
        self.submits = []           # submit timestamps (successful only)
        self.concurrent = 0
        self.peak = 0
        self.dropped = []           # (keys, if_stamp) from drop_blocks
        self._lock = threading.Lock()

    def submit(self, method, payload):
        with self._lock:
            item = self.script.pop(0) if self.script else None
        if item == "connlost":
            raise ConnectionLost("submit refused")
        delay, fn = item if item is not None else (self.latency, None)
        fut = Future()
        with self._lock:
            self.submits.append(time.monotonic())
            self.concurrent += 1
            self.peak = max(self.peak, self.concurrent)

        def _finish():
            with self._lock:
                self.concurrent -= 1
            if fn is not None:
                fn(fut)
            else:
                fut.set_result({"num_rows": 1, "executor": self.name})

        threading.Timer(delay, _finish).start()
        return fut

    def drop_blocks(self, keys, if_stamp=None):
        self.dropped.append((list(keys), if_stamp))


def _tasks(n):
    return [SimpleNamespace(task_id=f"t{i}") for i in range(n)]


def _payloads(n):
    return [b"payload"] * n


def test_per_executor_cap_no_stacking(monkeypatch):
    """A slow executor's queue must never exceed its own cap while the fast
    sibling has free slots — the old single global ``4 × pool`` cap let the
    whole stage stack up behind one straggler."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    slow = StubExecutor(name="slow", latency=0.25)
    fast = StubExecutor(name="fast", latency=0.005)
    pool = ExecutorPool([slow, fast])
    stats = {}
    out = pool.run_tasks(_tasks(10), max_inflight_per_executor=2,
                         payloads=_payloads(10), sched_stats=stats)
    assert all(r is not None for r in out)
    assert slow.peak <= 2, "slow executor exceeded its per-executor cap"
    assert stats["per_executor_busy"]["slow"] <= 2
    # the fast executor absorbed the queue the slow one could not take
    assert len(fast.submits) >= 6, (len(slow.submits), len(fast.submits))


def test_preferred_hands_off_when_at_cap(monkeypatch):
    """Locality preference is kept — but a preferred executor whose queue is
    at cap hands the task to the least-loaded live sibling instead of
    stacking behind itself."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    a = StubExecutor(name="a", latency=0.15)
    b = StubExecutor(name="b", latency=0.005)
    pool = ExecutorPool([a, b])
    out = pool.run_tasks(_tasks(4), preferred=["a"] * 4,
                         max_inflight_per_executor=1, payloads=_payloads(4))
    assert all(r is not None for r in out)
    assert a.peak <= 1
    assert len(a.submits) >= 1          # preference honored while free
    assert len(b.submits) >= 2, "tasks stacked on the preferred executor"


def test_preferred_honored_when_below_cap(monkeypatch):
    monkeypatch.setenv("RDT_SPECULATION", "0")
    a = StubExecutor(name="a")
    b = StubExecutor(name="b")
    pool = ExecutorPool([a, b])
    pool.run_tasks(_tasks(4), preferred=["b"] * 4,
                   max_inflight_per_executor=4, payloads=_payloads(4))
    assert len(a.submits) == 0
    assert len(b.submits) == 4


def test_retry_keeps_locality(monkeypatch):
    """Satellite: a transient failure used to strand a cache-local task on
    round-robin for every later attempt — the retry must return to the
    preferred executor whenever it is not marked down."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    a = StubExecutor(name="a")
    a.script = [(0.005, lambda fut: fut.set_exception(
        RemoteError("RuntimeError", "transient boom", "tb")))]
    b = StubExecutor(name="b")
    pool = ExecutorPool([a, b])
    out = pool.run_tasks(_tasks(1), preferred=["a"], payloads=_payloads(1))
    assert out[0] is not None
    assert len(a.submits) == 2, "retry did not return to the preferred executor"
    assert len(b.submits) == 0


def test_down_map_keyed_per_handle_not_by_name(monkeypatch):
    """Satellite: executors with ``name == None`` used to share one
    ``down[""]`` entry, so one unnamed executor's crash marked every unnamed
    executor down. The down map keys on a stable per-handle identity."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    a = StubExecutor(name=None)
    a.script = ["connlost"] * 8      # permanently unreachable
    b = StubExecutor(name=None)
    pool = ExecutorPool([a, b])
    t0 = time.monotonic()
    out = pool.run_tasks(_tasks(2), payloads=_payloads(2))
    wall = time.monotonic() - t0
    assert all(r is not None for r in out)
    assert len(b.submits) == 2, "sibling unnamed executor was aliased down"
    # rotating to the live sibling is immediate — not the unreachable grace
    assert wall < 5.0, wall


def test_busy_pool_with_one_down_executor_waits_not_fails(monkeypatch):
    """Regression (review finding): when every LIVE executor is at its cap,
    queued tasks must WAIT for a slot — not probe a down executor's dead
    address and burn their unreachable grace while the pool is merely busy.
    With a 1s grace, a down executor, and a live sibling whose backlog
    exceeds that grace, the stage must still complete."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    monkeypatch.setenv("RDT_EXECUTOR_WAIT_S", "1")
    dead = StubExecutor(name="dead")
    dead.script = ["connlost"] * 64
    live = StubExecutor(name="live", latency=0.3)
    pool = ExecutorPool([dead, live])
    out = pool.run_tasks(_tasks(6), max_inflight_per_executor=1,
                         payloads=_payloads(6))
    assert all(r is not None for r in out)
    assert live.peak <= 1
    assert len(live.submits) == 6
    # the dead executor saw at most the probes from moments when NO live
    # executor existed yet (the very first fill, before it was marked down)
    assert len(dead.script) >= 56, "busy pool kept probing the dead executor"


def test_stable_idents_prefer_actor_id():
    a = StubExecutor(name=None, actor_id="actor-1")
    b = StubExecutor(name="named")
    c = StubExecutor(name=None)
    pool = ExecutorPool([a, b, c])
    idents = pool._idents
    assert idents[0] == "actor-1"
    assert idents[1] == "named"
    assert idents[2].startswith("anon-")
    assert len(set(idents)) == 3


def test_speculation_backup_wins_and_loser_drained(monkeypatch):
    """Once the stage is past the completion quantile and an attempt runs
    past the threshold, a backup of the same payload lands on a DIFFERENT
    executor; the first finisher wins, the stage does not wait for the
    straggler, and the loser's store outputs are freed when it lands."""
    monkeypatch.setenv("RDT_SPECULATION_MIN_S", "0.1")
    monkeypatch.setenv("RDT_SPECULATION_QUANTILE", "0.5")
    freed = []

    class _Client:
        def free(self, refs):
            freed.extend(r.id for r in refs)
            return len(refs)

    monkeypatch.setattr(E, "get_client", lambda: _Client())

    loser_ref = ObjectRef(id="d" * 32)

    def slow_result(fut):
        fut.set_result({"num_rows": 1, "ref": loser_ref, "executor": "slow"})

    slow = StubExecutor(name="slow")
    slow.script = [(1.5, slow_result)] * 3
    fast = StubExecutor(name="fast", latency=0.01)
    pool = ExecutorPool([slow, fast])
    stats = {}
    t0 = time.monotonic()
    out = pool.run_tasks(_tasks(6), payloads=_payloads(6), sched_stats=stats)
    wall = time.monotonic() - t0
    assert all(r is not None for r in out)
    assert wall < 1.2, f"stage waited out the straggler ({wall:.2f}s)"
    assert stats["speculated"] >= 1
    assert stats["speculation_won"] >= 1
    # winner results carry the driver-side annotations the report sums
    assert sum(int(r.get("_speculation_won", 0)) for r in out) == \
        stats["speculation_won"]
    # every backup ran on the OTHER executor (never beside its primary)
    assert len(fast.submits) >= 3 + stats["speculation_won"]
    # the losers land at ~1.5s; their blobs free through the late path
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline \
            and freed.count(loser_ref.id) < stats["speculation_won"]:
        time.sleep(0.05)
    assert freed.count(loser_ref.id) >= stats["speculation_won"], freed


def test_speculation_disabled_by_env(monkeypatch):
    monkeypatch.setenv("RDT_SPECULATION", "0")
    monkeypatch.setenv("RDT_SPECULATION_MIN_S", "0.05")
    monkeypatch.setenv("RDT_SPECULATION_QUANTILE", "0.1")
    slow = StubExecutor(name="slow")
    slow.script = [(0.6, None)] * 2
    fast = StubExecutor(name="fast", latency=0.01)
    pool = ExecutorPool([slow, fast])
    stats = {}
    t0 = time.monotonic()
    out = pool.run_tasks(_tasks(4), payloads=_payloads(4), sched_stats=stats)
    wall = time.monotonic() - t0
    assert all(r is not None for r in out)
    assert stats["speculated"] == 0
    assert stats["speculation_won"] == 0
    assert wall >= 0.5, "stage finished before its unspeculated straggler"


def test_block_cache_put_once_idempotent():
    """Executor: a duplicate cache-put (speculative backup of a
    CACHE task) keeps the existing entry and reports ITS stamp, so both
    attempts' results name the same generation."""
    from raydp_tpu_torch.etl.executor import BlockCache

    cache = BlockCache()
    t = pa.table({"a": [1]})
    assert cache.put_once("k", t, "s1") == "s1"
    assert cache.put_once("k", t, "s2") == "s1"   # kept, stamp shared
    assert cache.drop(["k"], if_stamp="s2") == 0  # the discarded stamp
    assert cache.drop(["k"], if_stamp="s1") == 1
    # plain put still overwrites (recovery recache path)
    cache.put("k", t, "s3")
    assert cache.put_once("k", t, "s4") == "s3"


def test_loser_cache_drop_skipped_when_entry_shared():
    """When both copies of a CACHE task ran on ONE executor, the idempotent
    put makes their stamps coincide — the loser drain must then leave the
    block alone (it IS the winner's block); a loser on a different executor
    still has its spurious block dropped, stamp-conditioned."""
    h = StubExecutor(name="e")
    pool = ExecutorPool.__new__(ExecutorPool)
    pool.by_name = {"e": h}

    shared = Future()
    shared.set_result({"cache_key": "k", "cache_stamp": "s", "executor": "e"})
    winner = {"cache_key": "k", "cache_stamp": "s", "executor": "e"}
    pool._free_loser_result_sync(shared, winner)
    assert h.dropped == [], "shared cache entry was dropped under the winner"

    elsewhere = Future()
    elsewhere.set_result({"cache_key": "k", "cache_stamp": "s2",
                          "executor": "e"})
    winner2 = {"cache_key": "k", "cache_stamp": "s1", "executor": "other"}
    pool._free_loser_result_sync(elsewhere, winner2)
    assert h.dropped == [(["k"], "s2")]


def test_locality_weights_total_range_bytes_across_all_parts(monkeypatch):
    """A multi-range source (a coalesced read fusing
    several buckets, or a split portion spanning maps) must be routed by the
    TOTAL bytes it reads across all its (ref, off, size) triples — not just
    wherever its first ref lives. Nested part-lists (a fused group of
    buckets) flatten into the same weighting."""
    pool = ExecutorPool([StubExecutor(name="eA"), StubExecutor(name="eB")],
                        hosts_by_name={"eA": "hostA", "eB": "hostB"})
    engine = E.Engine(pool)

    ra = ObjectRef(id="a" * 32, size=10)       # lives on hostA, small
    rb1 = ObjectRef(id="b" * 32, size=4000)    # hostB, bulk of the bytes
    rb2 = ObjectRef(id="c" * 32, size=3000)    # hostB

    class _Client:
        def locations(self, refs):
            return {("a" * 32): "hostA", ("b" * 32): "hostB",
                    ("c" * 32): "hostB"}

    monkeypatch.setattr(E, "get_client", lambda: _Client())

    # first ref on hostA, but the range bytes overwhelmingly live on hostB
    flat = [[(ra, 0, 10), (rb1, 0, 4000), (rb2, 0, 3000)]]
    assert engine._locality(flat) == ["eB"]
    # nested part-lists (a coalesced multi-bucket group) weigh the same
    nested = [[[(ra, 0, 10)], [(rb1, 0, 4000), (rb2, 0, 3000)]]]
    assert engine._locality(nested) == ["eB"]
    # plain refs still weight by whole-blob size
    assert engine._locality([[ra], [rb1]]) == ["eA", "eB"]
    # range SIZE (not the blob's) is what counts: a tiny slice of a huge
    # blob on hostB must not outweigh real bytes on hostA
    huge_b = ObjectRef(id="d" * 32, size=1 << 20)

    class _Client2(_Client):
        def locations(self, refs):
            return {("a" * 32): "hostA", ("d" * 32): "hostB"}

    monkeypatch.setattr(E, "get_client", lambda: _Client2())
    assert engine._locality([[(ra, 0, 10), (huge_b, 0, 4)]]) == ["eA"]


def test_locality_reweights_streaming_reducers_from_seals_so_far(
        monkeypatch):
    """A streaming reduce task dispatched before the map
    stage finishes used to be preference-free — its bucket has no concrete
    ranges yet. ``_locality`` now expands a ``_StreamBucket`` to the ranges
    of the seals seen SO FAR (the driver published them, so it knows), and
    a stage with no seals yet genuinely has no preference."""
    pool = ExecutorPool([StubExecutor(name="eA"), StubExecutor(name="eB")],
                        hosts_by_name={"eA": "hostA", "eB": "hostB"})
    engine = E.Engine(pool)

    ra = ObjectRef(id="a" * 32, size=5000)
    rb = ObjectRef(id="b" * 32, size=50)

    class _Client:
        def locations(self, refs):
            return {("a" * 32): "hostA", ("b" * 32): "hostB"}

    monkeypatch.setattr(E, "get_client", lambda: _Client())

    rec = E._StreamStageRec("ss-test", "repartition", num_maps=3)
    # no seals yet: genuinely preference-free
    empty = E._StreamBucket(rec, 0)
    assert engine._locality([[empty]]) == [None]
    # two of three maps sealed; bucket 0's bytes live mostly on hostA,
    # bucket 1's on hostB — each streaming reducer routes by ITS ranges
    rec.seals[0] = (ra, [(0, 4000, 10), (4000, 10, 1)])
    rec.seals[2] = (rb, [(0, 10, 1), (10, 40, 2)])
    assert engine._locality([[E._StreamBucket(rec, 0)],
                             [E._StreamBucket(rec, 1)]]) == ["eA", "eB"]
    # a join-style entry mixing a stream bucket with concrete right-side
    # ranges weighs them together
    big_b = ObjectRef(id="c" * 32, size=9000)

    class _Client2(_Client):
        def locations(self, refs):
            return {("a" * 32): "hostA", ("b" * 32): "hostB",
                    ("c" * 32): "hostB"}

    monkeypatch.setattr(E, "get_client", lambda: _Client2())
    assert engine._locality(
        [[E._StreamBucket(rec, 0), (big_b, 0, 9000)]]) == ["eB"]


# ==== data-gravity scheduling: residency tiers ====================


def test_locality_tier_matrix(monkeypatch):
    """The data-gravity weight order: shm > spilled > remote > absent. A
    host whose copy is SPILLED counts its bytes at
    RDT_LOCALITY_SPILLED_WEIGHT (default 0.5) — between in-memory-local
    and remote — so a fault-in storm can lose to a bigger shm pile, a
    spilled-local copy still beats no copy, and weight 0 disqualifies
    spilled copies entirely."""
    pool = ExecutorPool([StubExecutor(name="eA"), StubExecutor(name="eB")],
                        hosts_by_name={"eA": "hostA", "eB": "hostB"})
    engine = E.Engine(pool)
    ra = ObjectRef(id="a" * 32, size=1000)   # shm copy on hostA
    rb = ObjectRef(id="b" * 32, size=1600)   # spilled copy on hostB

    class _Client:
        def residency(self, refs):
            return {("a" * 32): ("hostA", "shm"),
                    ("b" * 32): ("hostB", "spilled"),
                    ("c" * 32): ("hostB", "spilled")}

    monkeypatch.setattr(E, "get_client", lambda: _Client())
    # hostB holds MORE raw bytes (1600 > 1000), but spilled at 0.5 weighs
    # 800: the smaller shm pile wins
    assert engine._locality([[ra, rb]]) == ["eA"]
    # enough spilled bytes still win: 0.5 x 2400 = 1200 > 1000
    rc = ObjectRef(id="c" * 32, size=2400)
    assert engine._locality([[ra, rc]]) == ["eB"]
    # spilled-local beats remote/absent: the only copy is hostB's disk
    assert engine._locality([[rb]]) == ["eB"]
    # absent bytes weigh nothing: no residency entry, no preference
    rz = ObjectRef(id="f" * 32, size=9999)
    assert engine._locality([[rz]]) == [None]
    # weight 0 makes a spilled copy indistinguishable from absent
    monkeypatch.setenv("RDT_LOCALITY_SPILLED_WEIGHT", "0")
    assert engine._locality([[rb]]) == [None]


def test_locality_tier_tie_rotation(monkeypatch):
    """Hosts tied on weight rotate deterministically across picks instead
    of always landing on the first-sorted host — tied placements spread."""
    pool = ExecutorPool([StubExecutor(name="eA"), StubExecutor(name="eB")],
                        hosts_by_name={"eA": "hostA", "eB": "hostB"})
    engine = E.Engine(pool)
    ra = ObjectRef(id="a" * 32, size=1000)
    rb = ObjectRef(id="b" * 32, size=1000)

    class _Client:
        def residency(self, refs):
            return {("a" * 32): ("hostA", "shm"),
                    ("b" * 32): ("hostB", "shm")}

    monkeypatch.setattr(E, "get_client", lambda: _Client())
    # each task reads 1000 bytes from BOTH hosts: a dead tie, rotated
    tied_task = [ra, rb]
    assert engine._locality([tied_task, tied_task, tied_task, tied_task]) \
        == ["eA", "eB", "eA", "eB"]


def test_pick_weighted_skips_draining_host():
    """The heaviest host that still has a DISPATCHABLE member wins: when
    the shm-local host is draining, the runner-up (e.g. the machine with
    the spilled copy) takes the task instead of an arbitrary executor."""
    pool = ExecutorPool([StubExecutor(name="eA"), StubExecutor(name="eB")],
                        hosts_by_name={"eA": "hostA", "eB": "hostB"})
    assert pool.pick_weighted({"hostA": 10.0, "hostB": 1.0}) == "eA"
    assert pool.begin_drain("eA")
    assert pool.pick_weighted({"hostA": 10.0, "hostB": 1.0}) == "eB"
    # nothing dispatchable at any weighted host: no preference
    assert pool.pick_weighted({"hostZ": 5.0}) is None
    assert pool.pick_weighted({}) is None


def test_locality_stream_bucket_sees_tiers(monkeypatch):
    """A streaming reducer's seal-driven ranges weight by residency tier
    too: a big spilled seal can lose to a smaller shm seal elsewhere."""
    pool = ExecutorPool([StubExecutor(name="eA"), StubExecutor(name="eB")],
                        hosts_by_name={"eA": "hostA", "eB": "hostB"})
    engine = E.Engine(pool)
    ra = ObjectRef(id="a" * 32, size=5000)   # spilled on hostA
    rb = ObjectRef(id="b" * 32, size=4000)   # shm on hostB

    class _Client:
        def residency(self, refs):
            return {("a" * 32): ("hostA", "spilled"),
                    ("b" * 32): ("hostB", "shm")}

    monkeypatch.setattr(E, "get_client", lambda: _Client())
    rec = E._StreamStageRec("ss-tier", "repartition", num_maps=2)
    rec.seals[0] = (ra, [(0, 5000, 10)])
    rec.seals[1] = (rb, [(0, 4000, 8)])
    # bucket 0 reads 5000 spilled (-> 2500) + 4000 shm: hostB wins even
    # though hostA holds more raw bytes
    assert engine._locality([[E._StreamBucket(rec, 0)]]) == ["eB"]
    # at full spilled weight the raw byte count would win instead
    monkeypatch.setenv("RDT_LOCALITY_SPILLED_WEIGHT", "1.0")
    assert engine._locality([[E._StreamBucket(rec, 0)]]) == ["eA"]


# ==== remote residency tier scoring ===================


def _gravity_fixture(monkeypatch, residency):
    """Two-host pool + engine with a stubbed bulk residency RPC."""
    pool = ExecutorPool([StubExecutor(name="eA"), StubExecutor(name="eB")],
                        hosts_by_name={"eA": "hostA", "eB": "hostB"})
    engine = E.Engine(pool)

    class _Client:
        def residency(self, refs):
            return residency

    monkeypatch.setattr(E, "get_client", lambda: _Client())
    return pool, engine


def test_remote_weight_keeps_holder_ranking(monkeypatch):
    """Remote crediting is ranking-NEUTRAL among byte-holders: each host
    scores ``(1-r)*local + r*total`` — monotone in its local bytes — so
    for any r < 1 the shm holder still beats a bigger spilled pile and a
    non-holder never outranks a holder."""
    pool, engine = _gravity_fixture(monkeypatch, {
        ("a" * 32): ("hostA", "shm"),
        ("b" * 32): ("hostB", "spilled")})
    ra = ObjectRef(id="a" * 32, size=1000)
    rb = ObjectRef(id="b" * 32, size=1600)   # spilled at 0.5 -> 800
    for r in ("0.25", "0.9"):
        monkeypatch.setenv("RDT_LOCALITY_REMOTE_WEIGHT", r)
        assert engine._locality([[ra, rb]]) == ["eA"], r
        # sole holder still wins over the credited non-holder
        assert engine._locality([[ra]]) == ["eA"], r


def test_remote_weight_gives_live_nonholder_a_fallback(monkeypatch):
    """The point of the knob: when the gravity host is draining, a LIVE
    non-holder carries a real remote-discounted score, so pick_weighted
    returns a ranked fallback instead of no preference — and remote
    weight 0 restores the holder-only behavior (no fallback)."""
    pool, engine = _gravity_fixture(monkeypatch, {
        ("a" * 32): ("hostA", "shm")})
    ra = ObjectRef(id="a" * 32, size=1000)
    assert pool.begin_drain("eA")
    monkeypatch.setenv("RDT_LOCALITY_REMOTE_WEIGHT", "0.25")
    assert engine._locality([[ra]]) == ["eB"], \
        "live non-holder must become the ranked fallback"
    monkeypatch.setenv("RDT_LOCALITY_REMOTE_WEIGHT", "0")
    assert engine._locality([[ra]]) == [None], \
        "weight 0 must restore holder-only scoring"


def test_remote_weight_one_is_distance_blind(monkeypatch):
    """r=1 credits every live host the task's full bytes: all hosts tie
    and rotate — the distance-blind ceiling of the knob (values above 1
    clamp, so preference can never invert toward non-holders)."""
    pool, engine = _gravity_fixture(monkeypatch, {
        ("a" * 32): ("hostA", "shm")})
    ra = ObjectRef(id="a" * 32, size=1000)
    monkeypatch.setenv("RDT_LOCALITY_REMOTE_WEIGHT", "1.0")
    task = [ra]
    assert engine._locality([task, task, task, task]) \
        == ["eA", "eB", "eA", "eB"]
    # clamp: 5.0 behaves as 1.0, not as an inverted preference
    monkeypatch.setenv("RDT_LOCALITY_REMOTE_WEIGHT", "5.0")
    assert engine._locality([task, task]) == ["eA", "eB"]
