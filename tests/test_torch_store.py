"""The port's object store: the native shared-memory arena
(raydp_tpu_torch/csrc/store/arena.cpp, built by g++ into
raydp_tpu_torch/_build/) and the store's LRU spill to disk under a
shared-memory budget — the scenarios of the reference's
test_native_store.py and test_spill.py, run against the copies."""

import multiprocessing as mp
import os
import threading

import numpy as np
import pyarrow as pa
import pytest

from raydp_tpu_torch import config as cfg
from raydp_tpu_torch.config import Config
from raydp_tpu_torch.native.arena import Arena, native_store_available
from raydp_tpu_torch.runtime import init_runtime, shutdown_runtime
from raydp_tpu_torch.runtime.head import RuntimeContext

BUDGET = 2 << 20  # 2 MiB
OBJ = 400_000     # ~0.4 MiB each


@pytest.fixture
def arena():
    if not native_store_available():
        pytest.fail("the native store core did not build (g++)")
    a = Arena.create(f"rdt-torch-test-{mp.current_process().pid}", 8 << 20)
    yield a
    a.close()


@pytest.fixture
def rt():
    runtime = init_runtime()
    yield runtime
    shutdown_runtime()


@pytest.fixture
def spill_rt():
    runtime = RuntimeContext(config=Config({
        cfg.OBJECT_STORE_MEMORY_KEY: str(BUDGET),
        cfg.SPILL_BUDGET_KEY: str(BUDGET),
    }))
    # immediate arena reclamation so spilled arena bytes free right away
    runtime.store_server.host.ARENA_FREE_GRACE_S = 0.0
    yield runtime
    runtime.shutdown()


def _blob(seed: int) -> bytes:
    return np.random.RandomState(seed).bytes(OBJ)


# ---- the arena allocator ----------------------------------------------------


def test_alloc_free_roundtrip(arena):
    off = arena.alloc(1000)
    assert off is not None and off % 64 == 0
    arena.view(off, 1000)[:] = b"x" * 1000
    assert bytes(arena.view(off, 1000)) == b"x" * 1000
    stats = arena.stats()
    assert stats["num_allocs"] == 1 and stats["bytes_in_use"] >= 1000
    assert arena.free(off)
    stats = arena.stats()
    assert stats["num_allocs"] == 0 and stats["bytes_in_use"] == 0


@pytest.mark.parametrize("case", ["double", "unaligned", "out_of_range"])
def test_bad_free_rejected(arena, case):
    if case == "double":
        off = arena.alloc(64)
        assert arena.free(off)
    else:
        off = 12345 + 3 if case == "unaligned" else arena.size + 64
    assert not arena.free(off)


def test_split_and_coalesce(arena):
    """Free order exercises predecessor and successor coalescing; the space
    is then one block again."""
    offs = [arena.alloc(4096) for _ in range(3)]
    assert all(o is not None for o in offs)
    assert arena.stats()["bytes_in_use"] >= 3 * 4096
    arena.free(offs[1])
    arena.free(offs[0])
    arena.free(offs[2])
    assert arena.stats()["bytes_in_use"] == 0
    assert arena.alloc(3 * 4096 + 128) == offs[0]


def test_exhaustion_returns_none(arena):
    assert arena.alloc(64 << 20) is None  # larger than the 8 MiB arena
    offs = []
    while (off := arena.alloc(1 << 20)) is not None:
        offs.append(off)
    assert len(offs) >= 6
    for off in offs:
        assert arena.free(off)
    assert arena.stats()["bytes_in_use"] == 0


def test_concurrent_alloc_free_threads(arena):
    errors = []

    def worker(seed):
        rng = np.random.RandomState(seed)
        try:
            for _ in range(200):
                size = int(rng.randint(1, 8192))
                off = arena.alloc(size)
                if off is None:
                    continue
                view = arena.view(off, size)
                view[:] = bytes([seed % 256]) * size
                if bytes(view) != bytes([seed % 256]) * size:
                    errors.append("corrupt payload")
                if not arena.free(off):
                    errors.append("free failed")
        except Exception as e:  # pragma: no cover - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert arena.stats()["num_allocs"] == 0


def _child_alloc(segment, out_q):
    a = Arena.attach(segment)
    off = a.alloc(512)
    a.view(off, 512)[:] = b"c" * 512
    out_q.put(off)
    a.detach()


def test_cross_process_alloc(arena):
    """A second process allocates from the same arena; the parent reads the
    payload in place."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_child_alloc, args=(arena.segment, q))
    p.start()
    off = q.get(timeout=60)
    p.join(timeout=30)
    assert p.exitcode == 0
    assert bytes(arena.view(off, 512)) == b"c" * 512
    assert arena.stats()["num_allocs"] == 1
    assert arena.free(off)


# ---- the store on the arena -------------------------------------------------


def test_store_uses_arena(rt):
    """Payloads land in the arena; a free is reclaimed only after the grace
    period, so a zero-copy view taken before it stays intact."""
    client = rt.store_client
    info = rt.store_server.arena_info()
    assert info is not None, "native core built but arena not created"
    table = pa.table({"a": np.arange(1000), "b": np.random.rand(1000)})
    ref = client.put(table)
    seg, _, _, offset, _, _ = rt.store_server.lookup(ref.id)
    assert offset >= 0 and seg == info["segment"]
    assert client.get(ref).equals(table)

    before = rt.store_server.arena_stats()["bytes_in_use"]
    assert before > 0
    view_table = client.get(ref, zero_copy=True)
    client.free([ref])
    assert rt.store_server.arena_stats()["bytes_in_use"] == before
    assert view_table.equals(table)
    rt.store_server.host._reap_deferred(everything=True)
    assert rt.store_server.arena_stats()["bytes_in_use"] < before


class Writer:
    def put_table(self, n):
        from raydp_tpu_torch.runtime.object_store import get_client
        return get_client().put(pa.table({"x": np.arange(n, dtype=np.int64)}))


def test_store_survives_actor_writes(rt):
    """An actor process writes through the arena; the driver reads it."""
    ref = rt.create_actor(Writer, name="arena-writer").call("put_table", 4096)
    assert rt.store_server.lookup(ref.id)[3] >= 0, "actor skipped the arena"
    table = rt.store_client.get(ref)
    assert table.num_rows == 4096 and table["x"][4095].as_py() == 4095


def test_store_native_off():
    """Forced off, the store round-trips through per-object segments."""
    runtime = RuntimeContext(
        config=Config({cfg.NATIVE_OBJECT_STORE_KEY: "off"}))
    try:
        assert runtime.store_server.arena_info() is None
        ref = runtime.store_client.put({"k": 1})
        assert runtime.store_client.get(ref) == {"k": 1}
        assert runtime.store_server.lookup(ref.id)[3] == -1
    finally:
        runtime.shutdown()


def test_remote_store_client_roundtrip(rt):
    """A remote-mode client (a process that cannot map the head's shared
    memory) reads and writes through the table server's RPCs."""
    from raydp_tpu_torch.runtime.object_store import ObjectStoreClient

    local = rt.store_client
    remote = ObjectStoreClient(rt.store_server, rt.session_id,
                               default_owner="remote-node", remote=True)
    table = pa.table({"a": np.arange(500), "b": np.random.rand(500)})
    assert remote.get(local.put(table)).equals(table)
    ref2 = remote.put({"x": [1, 2, 3]})
    assert local.get(ref2) == {"x": [1, 2, 3]}
    t3 = pa.table({"c": np.arange(64, dtype=np.int64)})
    assert local.get(remote.put(t3), zero_copy=True).equals(t3)
    rt.store_server.free_owned_by("remote-node")
    assert not local.contains(ref2)


# ---- spill under a shared-memory budget -------------------------------------


def test_write_2x_budget_read_all_back(spill_rt):
    client = spill_rt.store_client
    payloads = [(client.put_raw(_blob(i)), _blob(i)) for i in range(10)]
    stats = spill_rt.store_server.stats()
    assert stats["spilled_objects"] > 0, "nothing spilled past the budget"
    assert stats["shm_bytes"] <= BUDGET + OBJ, stats
    assert stats["spilled_bytes"] + stats["shm_bytes"] == 10 * OBJ
    spill_dir = spill_rt.store_server.spill_dir
    assert spill_dir and os.path.isdir(spill_dir)
    assert len(os.listdir(spill_dir)) == stats["spilled_objects"]
    for ref, data in payloads:
        assert client.get(ref) == data
    after = spill_rt.store_server.stats()
    assert after["shm_bytes"] <= BUDGET + OBJ, after
    assert after["spilled_bytes"] + after["shm_bytes"] == 10 * OBJ


def test_free_removes_spill_files(spill_rt):
    client = spill_rt.store_client
    refs = [client.put_raw(_blob(i)) for i in range(10)]
    spill_dir = spill_rt.store_server.spill_dir
    assert len(os.listdir(spill_dir)) > 0
    client.free(refs)
    stats = spill_rt.store_server.stats()
    assert stats["num_objects"] == 0 and os.listdir(spill_dir) == []
    assert stats["shm_bytes"] == 0 and stats["spilled_bytes"] == 0


def _spilled(server) -> set:
    with server._lock:
        return {oid for oid, e in server._table.items() if e.spilled}


def test_lru_order_spills_coldest_first(spill_rt):
    client = spill_rt.store_client
    refs = [client.put_raw(_blob(i)) for i in range(5)]
    client.get(refs[0])  # the hottest
    overflow = [client.put_raw(_blob(100 + i)) for i in range(4)]
    assert _spilled(spill_rt.store_server) & {r.id for r in refs[1:]}
    for ref in refs + overflow:
        assert client.contains(ref)


def test_spill_disabled_with_zero_budget():
    runtime = RuntimeContext(config=Config({
        cfg.OBJECT_STORE_MEMORY_KEY: str(BUDGET),
        cfg.SPILL_BUDGET_KEY: "0",
    }))
    try:
        client = runtime.store_client
        refs = [client.put_raw(_blob(i)) for i in range(10)]
        assert runtime.store_server.spill_dir is None
        assert runtime.store_server.stats()["spilled_objects"] == 0
        for i, ref in enumerate(refs):
            assert client.get(ref) == _blob(i)
    finally:
        runtime.shutdown()


def test_eviction_hints_order_bands(spill_rt):
    """Victims go by (hint band, LRU): evict-first before unhinted, pinned
    last; an unpin at refcount zero demotes to evict-first."""
    client = spill_rt.store_client
    server = spill_rt.store_server
    refs = [client.put_raw(_blob(i)) for i in range(5)]
    client.eviction_hints(pin=[refs[0], refs[1]], evict_first=[refs[4]])
    client.put_raw(_blob(100))
    client.put_raw(_blob(101))
    spilled = _spilled(server)
    assert refs[4].id in spilled
    assert refs[0].id not in spilled and refs[1].id not in spilled
    assert refs[2].id in spilled and refs[3].id not in spilled
    client.eviction_hints(unpin=[refs[0], refs[1]])
    client.put_raw(_blob(102))
    spilled = _spilled(server)
    assert refs[0].id in spilled and refs[3].id not in spilled


def test_pin_refcounts_shared_inputs(spill_rt):
    client = spill_rt.store_client
    server = spill_rt.store_server
    ref = client.put_raw(b"x" * 1000)
    client.eviction_hints(pin=[ref])
    client.eviction_hints(pin=[ref])
    client.eviction_hints(unpin=[ref])
    stats = server.stats()
    assert stats["pinned_objects"] == 1 and stats["evict_first_objects"] == 0
    client.eviction_hints(unpin=[ref])
    stats = server.stats()
    assert stats["pinned_objects"] == 0 and stats["evict_first_objects"] == 1


def test_pinned_blobs_still_spill_as_last_resort(spill_rt):
    client = spill_rt.store_client
    refs = [client.put_raw(_blob(i)) for i in range(5)]
    client.eviction_hints(pin=refs)
    for i in range(4):
        client.put_raw(_blob(200 + i))
    stats = spill_rt.store_server.stats()
    assert stats["shm_bytes"] <= BUDGET + OBJ
    assert stats["spilled_objects"] > 0
    for i, ref in enumerate(refs):
        assert client.get(ref) == _blob(i)


def test_derive_budgets_tightens_never_widens(spill_rt):
    from raydp_tpu_torch.runtime.object_store import HEAD_HOST

    client = spill_rt.store_client
    server = spill_rt.store_server
    for i in range(4):
        client.put_raw(_blob(i))
    assert server.stats()["spilled_objects"] == 0
    # measured 400 KB x 1.5 headroom = 600 KB, floored to 1 MiB
    assert client.derive_budgets(400_000)[HEAD_HOST] == 1 << 20
    stats = server.stats()
    assert stats["derived_budgets"] == {HEAD_HOST: 1 << 20}
    assert stats["shm_bytes"] <= (1 << 20)
    assert stats["spilled_objects"] >= 2
    assert client.derive_budgets(100 << 20)[HEAD_HOST] == BUDGET
