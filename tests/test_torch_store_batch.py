"""Batched metadata plane + client caching units (runtime layer):
seal_batch/lookup_batch/put_raw_many, the client lookup memo, ranged reads,
the attached-segment handle-leak regression, and close() teardown.

The port's twin of ``tests/test_store_batch.py``: its cases, data, sizes and
assertions, run against ``raydp_tpu_torch``, whose copies of these planes
they guard against drift.
"""

import threading

import pyarrow as pa
import pytest

from raydp_tpu_torch.runtime.object_store import (
    KIND_RAW, ObjectLostError, ObjectRef, ObjectStoreClient,
    ObjectStoreServer,
)


@pytest.fixture
def store():
    srv = ObjectStoreServer("sessbatch0001")
    cli = ObjectStoreClient(srv, "sessbatch0001")
    # force the per-object-segment path: that is where the memo applies and
    # where the handle leak lived
    cli._arena_probed = True
    cli._arena = None
    yield srv, cli
    cli.close()
    srv.shutdown()


# ==== server: batched table ops ====================================================
def test_seal_batch_is_one_op_and_atomic(store):
    srv, cli = store
    refs = cli.put_raw_many([(b"aa", KIND_RAW), (b"bbb", KIND_RAW),
                             (b"", KIND_RAW)])
    assert [r.size for r in refs] == [2, 3, 0]
    counts = srv.op_counts()
    assert counts.get("seal_batch") == 1 and "seal" not in counts
    assert [cli.get(r) for r in refs] == [b"aa", b"bbb", b""]

    # duplicate id rejects the WHOLE batch before anything lands
    spec = (refs[0].id, "seg", 1, KIND_RAW, "o", -1)
    fresh = ("9" * 32, "seg9", 1, KIND_RAW, "o", -1)
    with pytest.raises(KeyError):
        srv.seal_batch([fresh, spec])
    assert not srv.contains("9" * 32)


def test_lookup_batch_one_op_missing_ids_absent(store):
    srv, cli = store
    refs = cli.put_raw_many([(b"x", KIND_RAW), (b"y", KIND_RAW)])
    srv.reset_op_counts()
    out = srv.lookup_batch([refs[0].id, "0" * 32, refs[1].id])
    assert set(out) == {refs[0].id, refs[1].id}
    assert srv.op_counts() == {"lookup_batch": 1}


def test_put_raw_many_rolls_back_payloads_on_seal_failure(store):
    srv, cli = store

    class _Boom:
        def __getattr__(self, item):
            return getattr(srv, item)

        def seal_batch(self, specs):
            self.specs = specs
            raise RuntimeError("table down")

    boom = _Boom()
    cli._server = boom
    try:
        with pytest.raises(RuntimeError):
            cli.put_raw_many([(b"zz", KIND_RAW)])
    finally:
        cli._server = srv
    # the written segment was unlinked, not leaked until session end
    from multiprocessing import shared_memory
    seg = boom.specs[0][1]
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=seg)


# ==== client: lookup memo ==========================================================
def test_lookup_memo_hits_cost_no_rpc_and_refresh_bypasses(store):
    srv, cli = store
    refs = cli.put_raw_many([(b"m0", KIND_RAW), (b"m1", KIND_RAW)])
    ids = [r.id for r in refs]
    cli.lookup_many(ids)
    m0 = cli.meta_rpc_count
    assert set(cli.lookup_many(ids)) == set(ids)
    assert cli.get(refs[0]) == b"m0"
    assert cli.meta_rpc_count == m0, "memo hit still paid an RPC"
    srv.reset_op_counts()
    cli.lookup_many(ids, fresh=True)
    assert srv.op_counts() == {"lookup_batch": 1}


def test_memo_never_caches_arena_resident_entries(store):
    srv, cli = store
    # an arena-resident entry (offset >= 0) must not be memoized: the arena
    # segment name never changes, so a recycled offset would be read silently
    cli._memoize("a" * 32, ("arena_seg", 10, KIND_RAW, 128, "head", None))
    cli._memoize("b" * 32, ("dedicated", 10, KIND_RAW, -1, "head", None))
    assert "a" * 32 not in cli._lookup_memo
    assert "b" * 32 in cli._lookup_memo


def test_fresh_process_sees_loss_after_free(store):
    """A reader with no cached state must surface ObjectLostError for a blob
    freed elsewhere — the typed signal lineage recovery keys on."""
    srv, cli = store
    ref = cli.put_raw(b"gone", KIND_RAW)
    srv.free([ref.id])
    with pytest.raises(ObjectLostError):
        cli.get(ref)
    assert ref.id not in cli._lookup_memo and ref.id not in cli._seg_of


# ==== client: ranged reads =========================================================
def test_get_range_buffers_local_slices_and_bounds(store):
    srv, cli = store
    refs = cli.put_raw_many([(b"0123456789", KIND_RAW),
                             (b"abcdef", KIND_RAW)])
    m0 = srv.op_counts().get("lookup", 0)
    bufs = cli.get_range_buffers([(refs[0], 2, 4), (refs[1], 0, 3),
                                  (refs[0], 0, 10)])
    assert bufs == [b"2345", b"abc", b"0123456789"]
    # resolution rode lookup_batch, never per-ref lookup
    assert srv.op_counts().get("lookup", 0) == m0
    with pytest.raises(ValueError):
        cli.get_range_buffers([(refs[1], 4, 10)])


def test_get_range_buffers_lost_blob_raises_typed(store):
    srv, cli = store
    ref = cli.put_raw(b"payload", KIND_RAW)
    srv.free([ref.id])
    with pytest.raises(ObjectLostError):
        cli.get_range_buffers([(ref, 0, 3)])


# ==== client: handle-leak regression ===========================================
def test_attached_handles_released_on_free_cycle(store):
    """put → get → free on the per-segment (arena-full) path returns the
    attached-handle count to baseline; the old code cached SharedMemory
    handles per segment and never evicted."""
    srv, cli = store
    base = len(cli._attached)
    refs = cli.put_raw_many([(b"h%d" % i, KIND_RAW) for i in range(8)])
    for r in refs:
        assert cli.get(r).startswith(b"h")
    assert len(cli._attached) == base + 8
    cli.free(refs)
    assert len(cli._attached) == base
    assert not cli._seg_of and not cli._lookup_memo


def test_view_pinned_handle_retires_then_sweeps(store):
    srv, cli = store
    ref = cli.put_raw(b"pinned", KIND_RAW)
    view = cli.get_buffer(ref)
    cli.free([ref])
    # the mapping is still pinned by the borrowed view: retired, not leaked
    assert len(cli._attached) == 0 and len(cli._retired) == 1
    del view
    cli._sweep_retired()
    assert len(cli._retired) == 0


def test_lost_object_evicts_stale_handle(store):
    srv, cli = store
    ref = cli.put_raw(b"stale", KIND_RAW)
    assert cli.get(ref) == b"stale"
    assert len(cli._seg_of) == 1
    # free behind the client's back, then drop its caches as a loss would
    srv.free([ref.id])
    cli._evict(ref.id)
    assert not cli._seg_of and not cli._attached


def test_remote_mode_range_read_translates_loss(store):
    """The shm-less compat path of get_range_buffers must surface a freed
    blob as the typed ObjectLostError — a bare KeyError is in the engine's
    no-retry set and would fail the stage instead of entering lineage
    recovery (review finding)."""
    srv, _ = store
    cli = ObjectStoreClient(srv, "sessbatch0001", remote=True)
    ref = cli.put_raw(b"remote-blob", KIND_RAW)
    assert cli.get_range_buffers([(ref, 2, 4)]) == [b"mote"]
    srv.free([ref.id])
    with pytest.raises(ObjectLostError):
        cli.get_range_buffers([(ref, 0, 3)])


def test_remote_fetch_ranges_one_rpc_per_peer_and_both_layouts():
    """Ranged reads of payloads on ANOTHER machine ride ONE
    store_fetch_ranges RPC per peer host, and the wire format keeps the
    payload's table offset (base) separate from the range offset — folding
    them into one absolute offset would make a positive value look
    arena-resident to the payload host (the regression this test pins for
    dedicated-segment blobs)."""
    from raydp_tpu_torch.runtime.object_store import PayloadHost
    from raydp_tpu_torch.runtime.rpc import MethodDispatcher, RpcServer

    payload_host = PayloadHost(None)  # dedicated-segment layout (no arena)

    class _Agent:
        def store_fetch_ranges(self, items):
            return [payload_host.fetch_range(s, int(b), int(o), int(z))
                    for s, b, o, z in items]

    server = RpcServer(MethodDispatcher(_Agent()), port=0, name="agent")
    addr = f"{server.address[0]}:{server.address[1]}"
    srv = ObjectStoreServer("sessranges001")
    cli = ObjectStoreClient(srv, "sessranges001", host_id="head")
    cli._arena_probed = True
    cli._arena = None
    try:
        seg, off = payload_host.write(b"0123456789abcdef",
                                      "rdtsessrang_blob1")
        assert off == -1  # dedicated segment: the layout that regressed
        srv.seal("a" * 32, seg, 16, KIND_RAW, "o", off, "node-a", addr)
        ref = ObjectRef(id="a" * 32, size=16)
        bufs = cli.get_range_buffers([(ref, 2, 4), (ref, 10, 6)])
        assert bufs == [b"2345", b"abcdef"]
        assert cli.fetch_rpc_count == 1, "ranges did not batch into one RPC"

        # head-hosted payload read from a node machine goes through the
        # table server's fetch_ranges (the head IS that payload's host)
        seg2, off2 = srv.host.write(b"headbytesxyz", "rdtsessrang_blob2")
        srv.seal("b" * 32, seg2, 12, KIND_RAW, "o", off2, "head", None)
        node_cli = ObjectStoreClient(srv, "sessranges001", host_id="node-b")
        node_cli._arena_probed = True
        node_cli._arena = None
        ref2 = ObjectRef(id="b" * 32, size=12)
        assert node_cli.get_range_buffers([(ref2, 4, 5)]) == [b"bytes"]
        assert srv.op_counts().get("fetch_ranges") == 1

        # dead peer: the typed loss signal, so lineage recovery can key on it
        server.stop()
        lost_cli = ObjectStoreClient(srv, "sessranges001", host_id="head")
        lost_cli._arena_probed = True
        lost_cli._arena = None
        with pytest.raises(ObjectLostError):
            lost_cli.get_range_buffers([(ref, 0, 4)])
    finally:
        server.stop()
        payload_host.release([("rdtsessrang_blob1", -1)])
        srv.shutdown()
        cli.close()


# ==== client: close() teardown =================================================
def test_close_tears_down_peers_and_restart_cycle_does_not_accumulate():
    from raydp_tpu_torch.runtime.rpc import MethodDispatcher, RpcServer

    class _Peer:
        def store_reap(self):
            return True

    server = RpcServer(MethodDispatcher(_Peer()), port=0, name="peer")
    addr = f"{server.address[0]}:{server.address[1]}"
    srv = ObjectStoreServer("sessclose0001")
    cli = ObjectStoreClient(srv, "sessclose0001")
    try:
        clients = []
        for _ in range(3):  # executor-restart cycle: connect → close → repeat
            peer = cli._peer(addr)
            assert cli._peer(addr) is peer  # cached, not re-dialed
            assert len(cli._peers) == 1
            clients.append(peer)
            cli.close()
            assert not cli._peers and not cli._attached
            assert peer._closed
        assert all(c._closed for c in clients)
    finally:
        server.stop()
        srv.shutdown()
