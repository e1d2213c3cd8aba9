"""The port's rdtlint (``raydp_tpu_torch.tools.rdtlint``): the
zero-violation fence over the port's tree (all eight rules, against the
port's docs in ``raydp_tpu_torch/doc/``), the scan of
``tests/test_torch_*.py``, and the reference's ``tests/test_rdtlint.py``
cases ported: fixture-based units proving each rule fires on the bad shape
and stays quiet on the fixed one — including reproductions of the two
historical deadlocks (a read-loop-blocking late-result callback, a streaming
self-deadlock), the two acceptance regressions (removing the
``DeferredReply`` hand-off from a streaming ``run_task``; removing the
``_patch_lock`` guard from an ``_ActionTemps``-shaped class), and — for the
cross-process contract families — mutation fences on a copy of the port's
tree: deleting a ``patch_task_refs`` branch, a head ``store_*`` proxy, or a
``_result_refs`` key, renaming a contract exception, and renaming a span
literal, must each break the fence.

Then the registries the lint reads: every port knob is the reference's entry
of the same name, field for field (``RDT_WARM_IMPORTS``'s default and the
two gang knobs whose docs name ``torch.distributed`` aside), the one knob
the port lacks is the sharded state's, and the generated tables regenerate
to themselves.
"""

import dataclasses
import glob
import importlib.util
import json
import os
import re
import shutil
import sys
import textwrap

import pytest

from raydp_tpu_torch.tools.rdtlint import run
from raydp_tpu_torch.tools.rdtlint.__main__ import main as rdtlint_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "raydp_tpu_torch")


# ---------------------------------------------------------------------------
# the fence: the whole package must be clean (suppressed-only)
# ---------------------------------------------------------------------------

#: the port tree's reasoned suppressions, by rule: the fault plane's two
#: bootstrap reads of RDT_FAULTS / RDT_FAULTS_SEED (faults.py stays
#: stdlib-only and is imported before the registry), its injected delay on
#: a dispatcher thread (the delay is the fault), and the head's bounded
#: agent spawn hop in create_actor
SUPPRESSED = {"dispatcher-blocking": 2, "knob-registry": 2}


def test_tree_is_clean():
    report = run([PKG], root=REPO)
    assert report.files_linted > 90
    assert not report.unsuppressed, "\n" + report.render()
    # the suppression inventory is part of the reviewed surface: additions
    # must come through this file so the reason gets a second pair of eyes
    by_rule = {}
    for v in report.suppressed:
        assert v.reason, v.render()
        by_rule[v.rule] = by_rule.get(v.rule, 0) + 1
    assert by_rule == SUPPRESSED, "\n" + report.render(True)


def test_port_tests_knob_fault_telemetry_scan_is_clean():
    """The CI sweep leg: the knob, fault-site, and telemetry families over
    the port's tests too — direct RDT_* env reads (and unregistered
    span/metric literals) in test code used to escape the package leg
    entirely."""
    tests = sorted(glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))
    assert os.path.join(REPO, "tests", "test_torch_rdtlint.py") in tests
    report = run([PKG, *tests], root=REPO,
                 rules=["knob-registry", "fault-site-sync",
                        "telemetry-registry"])
    assert report.files_linted == \
        run([PKG], root=REPO, rules=[]).files_linted + len(tests)
    assert not report.unsuppressed, "\n" + report.render()


def test_cli_exit_codes(tmp_path, capsys):
    assert rdtlint_main([PKG, "--root", REPO]) == 0
    bad = _repo(tmp_path, {"pkg/m.py": "import os\n"
                           "V = os.environ.get('RDT_X')\n"})
    assert rdtlint_main([str(bad / "pkg"), "--root", str(bad)]) == 1
    # the fence must fail LOUDLY on a misconfigured path — a typo'd CI leg
    # reporting a clean tree would green-light anything forever
    assert rdtlint_main([str(tmp_path / "nonexistent")]) == 2
    (tmp_path / "empty").mkdir()
    assert rdtlint_main([str(tmp_path / "empty")]) == 2


# ---------------------------------------------------------------------------
# fixture plumbing
# ---------------------------------------------------------------------------

def _repo(tmp_path, files):
    """A throwaway repo: pyproject.toml marks the root; ``files`` maps
    relative paths to (dedented) contents."""
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    for rel, content in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(content))
    return tmp_path


def _lint(tmp_path, files, rules=None):
    root = _repo(tmp_path, files)
    return run([str(root / "pkg")], root=str(root), rules=rules)


def _msgs(report, rule=None):
    return [v.message for v in report.unsuppressed
            if rule is None or v.rule == rule]


# ---------------------------------------------------------------------------
# rule 1: dispatcher-blocking
# ---------------------------------------------------------------------------

# the streaming self-deadlock's shape: a run_task that waits for seal
# notifications. GOOD = the shipped design (dedicated thread + DeferredReply); BAD = the
# acceptance regression (hand-off removed, the dispatcher thread waits)
_STREAM_COMMON = """
    import threading
    from concurrent.futures import Future


    class DeferredReply:
        def __init__(self, future):
            self.future = future


    class MethodDispatcher:
        def __init__(self, target):
            self._t = target


    class StreamExecutor:
        def __init__(self):
            self._sealed = threading.Event()

        def _stream_wait(self, task):
            # the consumed-stream wait: blocks until every map seals — maps
            # that may be queued BEHIND this very dispatcher thread
            self._sealed.wait()
            return task

        def _run_obj(self, task):
            return {"rows": 1}
"""

_STREAM_BAD = _STREAM_COMMON + """
        def run_task(self, task):
            if getattr(task, "streaming", False):
                return self._stream_wait(task)  # parks the dispatcher
            return self._run_obj(task)


    _server = MethodDispatcher(StreamExecutor())
"""

_STREAM_GOOD = _STREAM_COMMON + """
        def run_task(self, task):
            if getattr(task, "streaming", False):
                fut = Future()

                def _run():
                    fut.set_result(self._stream_wait(task))

                threading.Thread(target=_run, daemon=True).start()
                return DeferredReply(fut)
            return self._run_obj(task)


    _server = MethodDispatcher(StreamExecutor())
"""


def test_dispatcher_rule_catches_streaming_self_deadlock(tmp_path):
    report = _lint(tmp_path, {"pkg/ex.py": _STREAM_BAD},
                   rules=["dispatcher-blocking"])
    msgs = _msgs(report, "dispatcher-blocking")
    assert len(msgs) == 1 and "wait" in msgs[0] \
        and "run_task -> _stream_wait" in msgs[0]


def test_dispatcher_rule_accepts_deferred_reply_handoff(tmp_path):
    report = _lint(tmp_path, {"pkg/ex.py": _STREAM_GOOD},
                   rules=["dispatcher-blocking"])
    assert _msgs(report, "dispatcher-blocking") == []


# the late-result callback's shape: a Future done-callback fires on the
# RPC connection's READ LOOP and synchronously calls back over that same
# connection
_CALLBACK_COMMON = """
    import threading


    class Pool:
        def __init__(self, client):
            self.client = client

        def _free_sync(self, fut):
            self.client.call("drop_blocks", fut)

        def watch(self, fut):
            fut.add_done_callback(self._free_late)
"""

_CALLBACK_BAD = _CALLBACK_COMMON + """
        def _free_late(self, fut):
            # blocks the only thread able to deliver its own response
            self._free_sync(fut)
"""

_CALLBACK_GOOD = _CALLBACK_COMMON + """
        def _free_late(self, fut):
            threading.Thread(target=self._free_sync, args=(fut,),
                             daemon=True).start()
"""


def test_dispatcher_rule_catches_read_loop_blocking_callback(tmp_path):
    report = _lint(tmp_path, {"pkg/pool.py": _CALLBACK_BAD},
                   rules=["dispatcher-blocking"])
    msgs = _msgs(report, "dispatcher-blocking")
    assert len(msgs) == 1 and "RpcClient.call" in msgs[0] \
        and "completion callback" in msgs[0]


def test_dispatcher_rule_accepts_thread_handoff_callback(tmp_path):
    report = _lint(tmp_path, {"pkg/pool.py": _CALLBACK_GOOD},
                   rules=["dispatcher-blocking"])
    assert _msgs(report, "dispatcher-blocking") == []


def test_dispatcher_rule_heuristics(tmp_path):
    # str.join / os.path.join / dict.get never count as blocking; sleep,
    # thread join, and store get do — and a reasoned allow suppresses
    src = """
    import os
    import time


    class MethodDispatcher:
        def __init__(self, t):
            pass


    class Svc:
        def fine(self, parts, d):
            x = ", ".join(parts)
            y = os.path.join("a", "b")
            return d.get("k"), x, y

        def slow(self):
            time.sleep(1.0)  # rdtlint: allow[dispatcher-blocking] test stub

        def joins(self, t):
            t.join()

        def reads(self, client):
            return client.get("oid")


    _s = MethodDispatcher(Svc())
    """
    report = _lint(tmp_path, {"pkg/svc.py": src},
                   rules=["dispatcher-blocking"])
    msgs = _msgs(report, "dispatcher-blocking")
    assert len(msgs) == 2
    assert any("thread join" in m for m in msgs)
    assert any("store/queue get" in m for m in msgs)
    assert len(report.suppressed) == 1  # the reasoned sleep


def test_dispatcher_rule_follows_annotated_attribute(tmp_path):
    # the self._job._wait(...) shape: resolution through an __init__
    # parameter annotation (how the SPMD coordinator deadlock was found)
    src = """
    class Job:
        def wait_thing(self, t):
            self._cond.wait(t)


    class Service:
        def __init__(self, job: "Job"):
            self._job = job

        def get_thing(self, t):
            return self._job.wait_thing(t)


    class MethodDispatcher:
        def __init__(self, t):
            pass


    _s = MethodDispatcher(Service(None))
    """
    report = _lint(tmp_path, {"pkg/svc.py": src},
                   rules=["dispatcher-blocking"])
    msgs = _msgs(report, "dispatcher-blocking")
    assert len(msgs) == 1 and "get_thing -> wait_thing" in msgs[0]


# ---------------------------------------------------------------------------
# rule 2: lock-discipline
# ---------------------------------------------------------------------------

# the _ActionTemps shape: ref_patches guarded by _patch_lock. BAD = the
# acceptance regression (lock removed from apply_patches)
_TEMPS = """
    import threading


    class Temps:
        def __init__(self):
            self.ref_patches = {}  # guarded-by: _patch_lock
            self._patch_lock = threading.Lock()

        def apply_patches(self, mapping):
            {body}
"""

_TEMPS_GOOD_BODY = """\
            with self._patch_lock:
                for k, v in mapping.items():
                    self.ref_patches[k] = v
"""

_TEMPS_BAD_BODY = """\
            for k, v in mapping.items():
                self.ref_patches[k] = v
"""


def test_lock_rule_catches_unguarded_patch_map(tmp_path):
    src = _TEMPS.replace("            {body}", _TEMPS_BAD_BODY)
    report = _lint(tmp_path, {"pkg/temps.py": src},
                   rules=["lock-discipline"])
    msgs = _msgs(report, "lock-discipline")
    assert msgs and "ref_patches" in msgs[0] and "_patch_lock" in msgs[0]


def test_lock_rule_accepts_guarded_patch_map(tmp_path):
    src = _TEMPS.replace("            {body}", _TEMPS_GOOD_BODY)
    report = _lint(tmp_path, {"pkg/temps.py": src},
                   rules=["lock-discipline"])
    assert _msgs(report, "lock-discipline") == []


def test_lock_rule_method_level_annotation_and_init_exemption(tmp_path):
    src = """
    import threading


    class Ledger:
        def __init__(self):
            self._lock = threading.Lock()
            self._stages = {}  # guarded-by: _lock
            self._stages["boot"] = 1  # __init__ is exempt

        def _resp_locked(self, key):  # guarded-by: _lock
            return self._stages.get(key)

        def publish(self, key):
            with self._lock:
                self._stages[key] = 1
                return self._resp_locked(key)

        def peek(self, key):
            # rdtlint: allow[lock-discipline] racy read tolerated in test
            return self._stages.get(key)

        def broken(self, key):
            return self._stages.get(key)
    """
    report = _lint(tmp_path, {"pkg/ledger.py": src},
                   rules=["lock-discipline"])
    msgs = _msgs(report, "lock-discipline")
    assert len(msgs) == 1 and "broken()" in msgs[0]
    assert len(report.suppressed) == 1


def test_lock_rule_registers_annotation_on_continuation_line(tmp_path):
    # the _StreamStageRec.seals shape: a wrapped initializer carrying the
    # guard comment on its continuation line must still register
    src = """
    import threading


    class Rec:
        def __init__(self, n):
            self._lock = threading.Lock()
            self.seals = \\
                [None] * n  # guarded-by: _lock

        def bad(self, i):
            return self.seals[i]

        def good(self, i):
            with self._lock:
                return self.seals[i]
    """
    report = _lint(tmp_path, {"pkg/rec.py": src}, rules=["lock-discipline"])
    msgs = _msgs(report, "lock-discipline")
    assert len(msgs) == 1 and "bad()" in msgs[0] and "seals" in msgs[0]


def test_lock_rule_trailing_comment_does_not_leak_to_next_line(tmp_path):
    src = """
    import threading


    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._guarded = {}  # guarded-by: _lock
            self._free = 0

        def touch(self):
            self._free += 1  # NOT guarded: must not inherit the annotation
    """
    report = _lint(tmp_path, {"pkg/c.py": src}, rules=["lock-discipline"])
    assert _msgs(report, "lock-discipline") == []


# ---------------------------------------------------------------------------
# rule 3: knob-registry
# ---------------------------------------------------------------------------

_FIXTURE_KNOBS = """
    from dataclasses import dataclass


    @dataclass
    class Knob:
        name: str
        scope: str


    KNOBS = {
        "RDT_GOOD": Knob("RDT_GOOD", "per-action"),
        "RDT_BOOT": Knob("RDT_BOOT", "process-start"),
    }
    DOC_TABLES = ()


    def table_markers(category):
        return ("<!-- b -->", "<!-- e -->")


    def render_block(category):
        return ""


    def get(name):
        return None
"""


def test_knob_rule_flags_direct_reads_and_resolves_constants(tmp_path):
    src = """
    import os

    ENV_NAME = "RDT_VIA_CONSTANT"


    def read():
        a = os.environ.get("RDT_DIRECT")
        b = os.environ[ENV_NAME]
        c = os.getenv("RDT_THIRD", "1")
        os.environ["RDT_WRITE"] = "1"  # writes are fine
        return a, b, c
    """
    report = _lint(tmp_path, {"pkg/m.py": src}, rules=["knob-registry"])
    msgs = _msgs(report, "knob-registry")
    assert len(msgs) == 3
    assert any("RDT_VIA_CONSTANT" in m for m in msgs)
    assert not any("RDT_WRITE" in m for m in msgs)


def test_knob_rule_registry_membership_and_import_time_cache(tmp_path):
    src = """
    from pkg import knobs

    CACHED = knobs.get("RDT_GOOD")           # per-action at import: flagged
    BOOT = knobs.get("RDT_BOOT")             # process-start at import: fine


    def f(x=knobs.get("RDT_GOOD")):          # defaults run at def time
        return x


    def g():
        ok = knobs.get("RDT_GOOD")           # call-time read: fine
        return ok, knobs.get("RDT_MISSING")  # unregistered: flagged
    """
    report = _lint(tmp_path, {"pkg/knobs.py": _FIXTURE_KNOBS,
                              "pkg/m.py": src}, rules=["knob-registry"])
    msgs = _msgs(report, "knob-registry")
    import_time = [m for m in msgs if "import time" in m]
    assert len(import_time) == 2
    assert any("RDT_MISSING" in m and "not declared" in m for m in msgs)
    assert not any("RDT_BOOT" in m and "import time" in m for m in msgs)


def test_knob_rule_flags_dead_registry_entries(tmp_path):
    report = _lint(tmp_path, {
        "pkg/knobs.py": _FIXTURE_KNOBS,
        "pkg/m.py": "from pkg import knobs\n\n\n"
                    "def f():\n    return knobs.get('RDT_GOOD')\n"},
        rules=["knob-registry"])
    msgs = _msgs(report, "knob-registry")
    assert any("RDT_BOOT" in m and "no linted code references" in m
               for m in msgs)


def test_real_registry_docs_and_defaults(monkeypatch):
    from raydp_tpu_torch import knobs

    # the generated tables cover every knob, and get() honors defaults,
    # parsing, and the empty-string-is-unset contract
    table = knobs.generate_table()
    for name in knobs.KNOBS:
        assert f"`{name}`" in table
    monkeypatch.delenv("RDT_LINEAGE_ROUNDS", raising=False)
    assert knobs.get("RDT_LINEAGE_ROUNDS") == 4
    monkeypatch.setenv("RDT_LINEAGE_ROUNDS", "")
    assert knobs.get("RDT_LINEAGE_ROUNDS") == 4
    monkeypatch.setenv("RDT_LINEAGE_ROUNDS", "2.0")
    assert knobs.get("RDT_LINEAGE_ROUNDS") == 2
    monkeypatch.setenv("RDT_ETL_AQE", "off")
    assert knobs.get("RDT_ETL_AQE") is False
    with pytest.raises(KeyError):
        # rdtlint: allow[knob-registry] deliberately unregistered: pins the KeyError
        knobs.get("RDT_NOT_A_KNOB")
    # get_raw: the unparsed string, None when unset
    monkeypatch.delenv("RDT_STORE_ARENA", raising=False)
    assert knobs.get_raw("RDT_STORE_ARENA") is None
    monkeypatch.setenv("RDT_STORE_ARENA", "rdtarena")
    assert knobs.get_raw("RDT_STORE_ARENA") == "rdtarena"
    monkeypatch.delenv("RDT_SPMD_JOB_ID", raising=False)
    with pytest.raises(KeyError):
        knobs.require("RDT_SPMD_JOB_ID")


# ---------------------------------------------------------------------------
# rule 4: fault-site-sync
# ---------------------------------------------------------------------------

_FIXTURE_FAULTS = """
    KNOWN_SITES = frozenset((
        "good.site",
        "stale.site",
    ))


    def check(site, key=""):
        return None
"""


def test_fault_rule_cross_checks_code_registry_tests_and_docs(tmp_path):
    root = _repo(tmp_path, {
        "pkg/faults.py": _FIXTURE_FAULTS,
        "pkg/m.py": """
            from pkg import faults


            def f():
                faults.check("good.site", key="k")
                faults.check("rogue.site", key="k")
            """,
        "tests/test_torch_x.py": """
            SPEC = "good.site:drop:nth=1"
            GHOST = "ghost.site:crash:once=/tmp/s"
            """,
        # the reference's tests arm the reference's sites: not scanned
        "tests/test_x.py": """
            OTHER = "other.site:crash:once=/tmp/s"
            """,
        "raydp_tpu_torch/doc/fault_tolerance.md": """
            | Site | Fires at | Actions |
            | --- | --- | --- |
            | `good.site` | somewhere | `drop` |
            | `phantom.site` | nowhere | `crash` |
            """,
    })
    report = run([str(root / "pkg")], root=str(root),
                 rules=["fault-site-sync"])
    msgs = _msgs(report, "fault-site-sync")
    assert any("'rogue.site'" in m and "KNOWN_SITES" in m for m in msgs)
    assert any("'stale.site'" in m and "stale registry" in m for m in msgs)
    assert any("'ghost.site'" in m and "inject nothing" in m for m in msgs)
    assert any("'phantom.site'" in m for m in msgs)
    assert not any("'other.site'" in m for m in msgs)
    # the documented + armed + registered site is never flagged
    assert not any("'good.site'" in m for m in msgs)


def test_fault_rule_quiet_on_consistent_fixture(tmp_path):
    root = _repo(tmp_path, {
        "pkg/faults.py": """
            KNOWN_SITES = frozenset(("only.site",))


            def check(site, key=""):
                return None
            """,
        "pkg/m.py": """
            from pkg import faults


            def f():
                faults.check("only.site")
            """,
        "tests/test_torch_x.py": 'S = "only.site:delay:ms=5"\n',
        "raydp_tpu_torch/doc/fault_tolerance.md":
            "| Site | Fires at | Actions |\n| --- | --- | --- |\n"
            "| `only.site` | f | `delay` |\n",
    })
    report = run([str(root / "pkg")], root=str(root),
                 rules=["fault-site-sync"])
    assert _msgs(report, "fault-site-sync") == []


def test_real_parse_spec_sites_match_lint_registry():
    # the lint's view of KNOWN_SITES and the runtime's must be the same
    # object: a drifted copy would let the fence and the parser disagree
    from raydp_tpu_torch import faults
    from raydp_tpu_torch.tools.rdtlint.core import Project
    from raydp_tpu_torch.tools.rdtlint.rule_faults import (
        _code_sites, _known_sites)

    project = Project.load([PKG], root=REPO)
    declared, _line = _known_sites(project.find_file("faults.py"))
    assert declared == set(faults.KNOWN_SITES)
    assert set(_code_sites(project)) == set(faults.KNOWN_SITES)


# ---------------------------------------------------------------------------
# suppression mechanics
# ---------------------------------------------------------------------------

def test_suppression_requires_reason(tmp_path):
    src = """
    import os

    A = os.environ.get("RDT_A")  # rdtlint: allow[knob-registry]
    # rdtlint: allow[knob-registry] reasoned: fixture exercising suppression
    B = os.environ.get("RDT_B")
    """
    report = _lint(tmp_path, {"pkg/m.py": src}, rules=["knob-registry"])
    msgs = _msgs(report, "knob-registry")
    assert len(msgs) == 1 and "RDT_A" in msgs[0]
    assert len(report.suppressed) == 1


# ---------------------------------------------------------------------------
# rule 5: rpc-surface
# ---------------------------------------------------------------------------

# a config-known surface class (HeadService) so the mapped receiver "head"
# resolves strictly against it
_RPC_SERVER = """
    class MethodDispatcher:
        def __init__(self, t):
            self._t = t


    class HeadService:
        def lookup(self, object_id):
            return object_id

        def seal(self, object_id, segment, size, kind="raw"):
            return True

        def ping(self):
            return "pong"


    _dispatch = MethodDispatcher(HeadService())
"""

_RPC_BAD_CLIENT = """
    def drive(head):
        head.call("lokup", "oid")                       # typo'd name
        head.call("seal", "oid")                        # arity: needs 3
        head.call("seal", "oid", "seg", 1, junk=True)   # unknown keyword
        head.call("_reset")                             # underscore target
"""

_RPC_GOOD_CLIENT = """
    def drive(head, handle):
        head.call("lookup", "oid", timeout=5.0)      # timeout= is excluded
        head.call("seal", "oid", "seg", 3)           # kind= has a default
        head.call("seal", "oid", "seg", 3, kind="arrow")
        handle.call("__rdt_spans__", timeout=10.0)   # actor intrinsic
        head.call(method, "oid")                     # variable name: no check
"""


def test_rpc_rule_catches_typo_arity_and_underscore(tmp_path):
    report = _lint(tmp_path, {"pkg/head.py": _RPC_SERVER,
                              "pkg/client.py": _RPC_BAD_CLIENT},
                   rules=["rpc-surface"])
    msgs = _msgs(report, "rpc-surface")
    assert len(msgs) == 4
    assert any("'lokup'" in m and "resolves on no method" in m for m in msgs)
    assert any("requires 3" in m for m in msgs)
    assert any("unknown keyword 'junk'" in m for m in msgs)
    assert any("underscore method '_reset'" in m for m in msgs)


def test_rpc_rule_accepts_matching_calls(tmp_path):
    report = _lint(tmp_path, {"pkg/head.py": _RPC_SERVER,
                              "pkg/client.py": _RPC_GOOD_CLIENT},
                   rules=["rpc-surface"])
    assert _msgs(report, "rpc-surface") == []


_PROXY_STORE = """
    class ObjectStoreServer:
        def lookup(self, object_id):
            return object_id

        def seal(self, object_id, segment, size):
            return True

        def free(self, ids):
            return len(ids)


    class ObjectStoreClient:
        def __init__(self, server):
            self._server = server

        def get(self, oid):
            return self._server.lookup(oid)

        def put(self, oid):
            return self._server.seal(oid, "seg", 1)

        def free(self, ids):
            return self._server.free(ids)
"""

_PROXY_HEAD_GOOD = """
    class HeadService:
        def __init__(self, rt):
            self._rt = rt

        def store_lookup(self, *a):
            return self._rt.store_server.lookup(*a)

        def store_seal(self, *a):
            return self._rt.store_server.seal(*a)

        def store_free(self, *a):
            return self._rt.store_server.free(*a)
"""

# the drift shapes: the free proxy is gone, and store_lookup forwards to the
# WRONG server method (StoreTableProxy routes by name)
_PROXY_HEAD_BAD = """
    class HeadService:
        def __init__(self, rt):
            self._rt = rt

        def store_lookup(self, *a):
            return self._rt.store_server.seal(*a)

        def store_seal(self, *a):
            return self._rt.store_server.seal(*a)
"""


def test_rpc_rule_checks_head_proxy_completeness(tmp_path):
    report = _lint(tmp_path, {"pkg/object_store.py": _PROXY_STORE,
                              "pkg/head.py": _PROXY_HEAD_BAD},
                   rules=["rpc-surface"])
    msgs = _msgs(report, "rpc-surface")
    assert any("'free'" in m and "no store_free proxy" in m for m in msgs)
    assert any("store_lookup" in m and "wrong method" in m for m in msgs)


def test_rpc_rule_accepts_complete_proxy_surface(tmp_path):
    report = _lint(tmp_path, {"pkg/object_store.py": _PROXY_STORE,
                              "pkg/head.py": _PROXY_HEAD_GOOD},
                   rules=["rpc-surface"])
    assert _msgs(report, "rpc-surface") == []


_RPC_THREE_SURFACES = """
    class HeadService:
        def ping(self):
            return "pong"


    class NodeAgentService:
        def spawn(self, env, log_name):
            return 1


    class ObjectStoreServer:
        def lookup(self, object_id):
            return object_id
"""


def test_rpc_doc_table_drift_and_regeneration(tmp_path):
    root = _repo(tmp_path, {
        "pkg/services.py": _RPC_THREE_SURFACES,
        "raydp_tpu_torch/doc/dev_lint.md":
            "# x\n\n<!-- rdtlint:rpc-table:begin -->\n"
                           "stale\n<!-- rdtlint:rpc-table:end -->\n",
    })
    report = run([str(root / "pkg")], root=str(root), rules=["rpc-surface"])
    assert any("stale" in m and "--write-rpc-docs" in m
               for m in _msgs(report, "rpc-surface"))
    assert rdtlint_main([str(root / "pkg"), "--root", str(root),
                         "--write-rpc-docs"]) == 0
    report = run([str(root / "pkg")], root=str(root), rules=["rpc-surface"])
    assert _msgs(report, "rpc-surface") == []
    text = (root / "raydp_tpu_torch" / "doc" / "dev_lint.md").read_text()
    assert "`spawn`" in text and "`env, log_name`" in text


# ---------------------------------------------------------------------------
# rule 6: step-registry
# ---------------------------------------------------------------------------

_TASKS_FIXTURE = """
    from dataclasses import dataclass
    from typing import List


    class ObjectRef:
        id: str


    class Step:
        pass


    @dataclass
    class ArrowRefSource(Step):  {anno}
        refs: List[ObjectRef]


    @dataclass
    class PlainStep(Step):
        column: str


    def task_input_ids(task):
        if isinstance(task, ArrowRefSource):
            return [r.id for r in task.refs]
        return []


    def _patch_step_refs(step, mapping):
        {patch_body}
        return step


    def patch_task_refs(task, mapping):
        return _patch_step_refs(task, mapping)


    def stream_sources_of(task):
        return []


    def resolve_stream_sources(task, resolver):
        return task
"""

_PATCH_GOOD = """if isinstance(step, ArrowRefSource):
            step.refs = [mapping.get(r.id, r) for r in step.refs]"""
_PATCH_MISSING = "del mapping"


def _tasks_repo(tmp_path, anno="# carries-refs: refs",
                patch_body=_PATCH_GOOD):
    src = _TASKS_FIXTURE.replace("{anno}", anno) \
        .replace("        {patch_body}", "        " + patch_body)
    return _lint(tmp_path, {"pkg/etl/tasks.py": src},
                 rules=["step-registry"])


def test_step_rule_accepts_declared_and_handled_carrier(tmp_path):
    report = _tasks_repo(tmp_path)
    assert _msgs(report, "step-registry") == []


def test_step_rule_catches_undeclared_carrier(tmp_path):
    report = _tasks_repo(tmp_path, anno="")
    msgs = _msgs(report, "step-registry")
    assert len(msgs) == 1 and "ArrowRefSource" in msgs[0] \
        and "no `# carries-refs:` declaration" in msgs[0]


def test_step_rule_catches_unregistered_patch_handler(tmp_path):
    # the BroadcastJoinStep regression shape: the class is declared but
    # its _patch_step_refs branch is gone
    report = _tasks_repo(tmp_path, patch_body=_PATCH_MISSING)
    msgs = _msgs(report, "step-registry")
    assert len(msgs) == 1 and "_patch_step_refs()" in msgs[0] \
        and "BroadcastJoinStep regression" in msgs[0]


def test_step_rule_catches_stale_declaration(tmp_path):
    report = _tasks_repo(tmp_path, anno="# carries-refs: refs, bogus")
    msgs = _msgs(report, "step-registry")
    assert len(msgs) == 1 and "'bogus'" in msgs[0] \
        and "stale declaration" in msgs[0]


# ---------------------------------------------------------------------------
# rule 7: exc-contract
# ---------------------------------------------------------------------------

_EXC_COMMON = {
    "pkg/rpc.py": """
        class RpcError(Exception):
            pass


        class ConnectionLost(RpcError):
            pass


        class RemoteError(RpcError):
            def __init__(self, exc_type):
                self.exc_type = exc_type
        """,
    "pkg/store.py": """
        class ObjectLostError(KeyError):
            pass
        """,
}

_EXC_GOOD = """
    _NO_RETRY = ("ValueError", "ObjectLostError")


    def handle(err):
        if err.exc_type == "ObjectLostError":
            return "recover"
        if err.exc_type in _NO_RETRY:
            return "fail"
        if getattr(err, "exc_type", None) == "FileNotFoundError":
            return "retry"
        if type(err).__name__ == "ConnectionLost":
            return "reconnect"
        return "other"
"""

_EXC_BAD = """
    _NO_RETRY = ("ValueError", "ShufleStreamAborted")


    def handle(err):
        if err.exc_type == "ObjectGoneError":
            return "recover"
        if err.exc_type in _NO_RETRY:
            return "fail"
        if type(err).__name__ == "ConectionLost":
            return "reconnect"
        return "other"
"""


def test_exc_rule_catches_stale_exception_strings(tmp_path):
    files = dict(_EXC_COMMON, **{"pkg/engine.py": _EXC_BAD})
    report = _lint(tmp_path, files, rules=["exc-contract"])
    msgs = _msgs(report, "exc-contract")
    assert len(msgs) == 3
    for name in ("ObjectGoneError", "ShufleStreamAborted", "ConectionLost"):
        assert any(repr(name) in m for m in msgs)


def test_exc_rule_accepts_real_builtin_and_repo_exceptions(tmp_path):
    files = dict(_EXC_COMMON, **{"pkg/engine.py": _EXC_GOOD})
    report = _lint(tmp_path, files, rules=["exc-contract"])
    assert _msgs(report, "exc-contract") == []


def test_exc_rule_skipped_without_rpc_module(tmp_path):
    # no RemoteError in scope → no exc_type contract to check
    report = _lint(tmp_path, {"pkg/engine.py": _EXC_BAD},
                   rules=["exc-contract"])
    assert _msgs(report, "exc-contract") == []


# ---------------------------------------------------------------------------
# real-tree mutation fences (acceptance): deleting any single registration
# from the live sources must break the fence
# ---------------------------------------------------------------------------

def _real_subtree(tmp_path, rels, mutations=()):
    """A throwaway repo holding REAL package files (mirrored paths), with
    textual mutations applied — each must match exactly once."""
    root = tmp_path / "mut"
    (root / "raydp_tpu_torch").mkdir(parents=True)
    (root / "pyproject.toml").write_text("[project]\nname='x'\n")
    for rel in rels:
        dst = root / "raydp_tpu_torch" / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(os.path.join(PKG, rel), dst)
    for rel, old, new in mutations:
        p = root / "raydp_tpu_torch" / rel
        text = p.read_text()
        assert text.count(old) >= 1, f"mutation anchor gone from {rel}: {old!r}"
        p.write_text(text.replace(old, new))
    return root


_ETL_RELS = ("etl/tasks.py", "etl/engine.py", "etl/executor.py")


def test_fence_breaks_when_patch_task_refs_branch_deleted(tmp_path):
    root = _real_subtree(tmp_path, _ETL_RELS)
    clean = run([str(root / "raydp_tpu_torch")], root=str(root),
                rules=["step-registry"])
    assert _msgs(clean, "step-registry") == []

    root = _real_subtree(tmp_path / "b", _ETL_RELS, mutations=[
        ("etl/tasks.py", "elif isinstance(step, BroadcastJoinStep):",
         "elif False:")])
    report = run([str(root / "raydp_tpu_torch")], root=str(root),
                 rules=["step-registry"])
    msgs = _msgs(report, "step-registry")
    assert any("BroadcastJoinStep" in m and "_patch_step_refs()" in m
               for m in msgs)


def test_fence_breaks_when_result_ref_key_unharvested(tmp_path):
    root = _real_subtree(tmp_path, _ETL_RELS, mutations=[
        ("etl/engine.py",
         '    if r.get("ref") is not None:\n        refs.append(r["ref"])\n'
         "    return refs",
         "    return refs")])
    report = run([str(root / "raydp_tpu_torch")], root=str(root),
                 rules=["step-registry"])
    msgs = _msgs(report, "step-registry")
    assert any("'ref'" in m and "_result_refs" in m and "orphan" in m
               for m in msgs)


def test_fence_breaks_when_locality_drops_stream_buckets(tmp_path):
    root = _real_subtree(tmp_path, _ETL_RELS, mutations=[
        ("etl/engine.py",
         "elif isinstance(item, _StreamBucket):\n"
         "                    yield from item.parts_so_far()",
         "elif False:\n                    pass")])
    report = run([str(root / "raydp_tpu_torch")], root=str(root),
                 rules=["step-registry"])
    msgs = _msgs(report, "step-registry")
    assert any("_locality()" in m and "_StreamBucket" in m for m in msgs)


_RPC_RELS = ("runtime/head.py", "runtime/object_store.py")


def test_fence_breaks_when_head_store_proxy_deleted(tmp_path):
    root = _real_subtree(tmp_path, _RPC_RELS)
    clean = run([str(root / "raydp_tpu_torch")], root=str(root),
                rules=["rpc-surface"])
    assert _msgs(clean, "rpc-surface") == []

    root = _real_subtree(tmp_path / "b", _RPC_RELS, mutations=[
        ("runtime/head.py", "def store_lookup(self, *a):",
         "def _store_lookup_disabled(self, *a):")])
    report = run([str(root / "raydp_tpu_torch")], root=str(root),
                 rules=["rpc-surface"])
    msgs = _msgs(report, "rpc-surface")
    assert any("'lookup'" in m and "no store_lookup proxy" in m
               for m in msgs)


def test_fence_breaks_when_contract_exception_renamed(tmp_path):
    rels = ("etl/engine.py", "runtime/rpc.py", "runtime/object_store.py")
    root = _real_subtree(tmp_path, rels)
    clean = run([str(root / "raydp_tpu_torch")], root=str(root),
                rules=["exc-contract"])
    assert _msgs(clean, "exc-contract") == []

    root = _real_subtree(tmp_path / "b", rels, mutations=[
        ("etl/engine.py", '"ShuffleStreamAborted",',
         '"ShufleStreamAborted",')])
    report = run([str(root / "raydp_tpu_torch")], root=str(root),
                 rules=["exc-contract"])
    msgs = _msgs(report, "exc-contract")
    assert any("'ShufleStreamAborted'" in m for m in msgs)


def test_real_rpc_call_sites_all_resolve():
    """Every literal call site in the live package resolves (the fence), and
    the surface map actually contains the load-bearing surfaces."""
    from raydp_tpu_torch.tools.rdtlint import surfaces
    from raydp_tpu_torch.tools.rdtlint.core import Project

    project = Project.load([PKG], root=REPO)
    smap = surfaces.build(project)
    assert "actor_ready" in smap.methods("head")
    assert smap.methods("head")["store_seal"].note \
        == "proxy → ObjectStoreServer.seal"
    assert "spawn" in smap.methods("agent")
    # the serving replicas are executor actors: serve_* resolve there
    assert smap.methods("actor")["serve_load"].cls == "EtlExecutor"
    assert "run_function" in smap.methods("worker")
    assert smap.methods("worker")["run_function"].min_pos == 2


# ---------------------------------------------------------------------------
# CLI --json
# ---------------------------------------------------------------------------

def test_cli_json_output(tmp_path, capsys):
    bad = _repo(tmp_path, {"pkg/m.py": "import os\n"
                           "V = os.environ.get('RDT_X')\n"})
    assert rdtlint_main([str(bad / "pkg"), "--root", str(bad),
                         "--json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["files_linted"] == 1
    (v,) = payload["violations"]
    assert v["file"].endswith("m.py") and v["line"] == 2
    assert v["rule"] == "knob-registry" and "RDT_X" in v["message"]
    assert v["suppressed"] is False and v["reason"] == ""
    # clean tree → empty violations, exit 0
    capsys.readouterr()
    assert rdtlint_main([PKG, "--root", REPO, "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["violations"] == [] and payload["suppressed"] >= 1


def test_write_rpc_docs_fails_loudly_on_missing_doc_or_markers(tmp_path,
                                                               capsys):
    # success while the drift fence keeps failing would be a trap: a wrong
    # --root or missing markers must exit 2 with the cause, not print nothing
    root = _repo(tmp_path, {"pkg/services.py": _RPC_THREE_SURFACES})
    assert rdtlint_main([str(root / "pkg"), "--root", str(root),
                         "--write-rpc-docs"]) == 2
    assert "wrong --root" in capsys.readouterr().err
    (root / "raydp_tpu_torch" / "doc").mkdir(parents=True)
    (root / "raydp_tpu_torch" / "doc" / "dev_lint.md").write_text(
        "# no markers here\n")
    assert rdtlint_main([str(root / "pkg"), "--root", str(root),
                         "--write-rpc-docs"]) == 2
    assert "markers" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# rule 8: telemetry-registry
# ---------------------------------------------------------------------------

_TELEMETRY_REGISTRY = """
    from dataclasses import dataclass


    @dataclass(frozen=True)
    class Metric:
        name: str
        kind: str


    @dataclass(frozen=True)
    class Span:
        name: str
        dynamic: bool = False


    @dataclass(frozen=True)
    class Event:
        kind: str


    _ALL_METRICS = [
        Metric("good_total", "counter"),
        Metric("depth_now", "gauge"),
        Metric("lat_seconds", "histogram"),
    ]
    METRICS = {m.name: m for m in _ALL_METRICS}
    _ALL_SPANS = [Span("good:span"), Span("task:", dynamic=True)]
    SPANS = {s.name: s for s in _ALL_SPANS}
    SPAN_NAMES = frozenset(s.name for s in _ALL_SPANS if not s.dynamic)
    SPAN_PREFIXES = tuple(s.name for s in _ALL_SPANS if s.dynamic)
    _ALL_EVENTS = [Event("good_event")]
    EVENTS = {e.kind: e for e in _ALL_EVENTS}
"""


def test_telemetry_rule_flags_unregistered_names_and_kind_mismatch(tmp_path):
    report = _lint(tmp_path, {
        "pkg/metrics.py": _TELEMETRY_REGISTRY,
        "pkg/user.py": """
            from raydp_tpu_torch import metrics, profiler


            def f(dyn):
                with profiler.trace("good:span"):
                    pass
                with profiler.trace("task:Whatever"):  # dynamic family
                    pass
                with profiler.trace(f"task:{dyn}"):    # f-string: skipped
                    pass
                with profiler.trace("bad:span"):
                    pass
                metrics.inc("good_total")
                metrics.set_gauge("depth_now", 2)
                metrics.observe("lat_seconds", 1.0)
                metrics.inc("lat_seconds")
                metrics.inc("missing_total")
                metrics.record_event("good_event")
                metrics.record_event("bad_event")
        """,
    }, rules=["telemetry-registry"])
    msgs = _msgs(report, "telemetry-registry")
    assert any("'bad:span'" in m and "not declared" in m for m in msgs)
    assert any("'missing_total'" in m for m in msgs)
    assert any("'lat_seconds'" in m and "histogram" in m
               and "counter" in m for m in msgs)
    assert any("'bad_event'" in m for m in msgs)
    assert len(msgs) == 4  # the registered/dynamic/f-string uses are clean


def test_telemetry_rule_flags_dead_registry_entries(tmp_path):
    report = _lint(tmp_path, {
        "pkg/metrics.py": _TELEMETRY_REGISTRY,
        "pkg/user.py": """
            from raydp_tpu_torch import metrics


            def f():
                metrics.inc("good_total")
        """,
    }, rules=["telemetry-registry"])
    msgs = _msgs(report, "telemetry-registry")
    for dead in ("'good:span'", "'depth_now'", "'lat_seconds'",
                 "'good_event'"):
        assert any(dead in m and "no linted code references" in m
                   for m in msgs), (dead, msgs)
    assert not any("'good_total'" in m for m in msgs)


def test_telemetry_rule_skipped_without_registry(tmp_path):
    report = _lint(tmp_path, {
        "pkg/user.py": """
            from raydp_tpu_torch import profiler


            def f():
                with profiler.trace("anything:goes"):
                    pass
        """,
    }, rules=["telemetry-registry"])
    assert _msgs(report, "telemetry-registry") == []


def _port_copy(tmp_path):
    """A throwaway repo holding a copy of the whole port package, its docs
    (``raydp_tpu_torch/doc/``) included."""
    root = tmp_path / "mut"
    shutil.copytree(PKG, root / "raydp_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    (root / "pyproject.toml").write_text("[project]\nname='x'\n")
    return root


def test_fence_breaks_when_span_literal_renamed(tmp_path):
    """The acceptance mutation fence: renaming ONE literal span name in the
    live tree must break the telemetry fence (the registered name becomes
    dead telemetry)."""
    root = _port_copy(tmp_path)
    clean = run([str(root / "raydp_tpu_torch")], root=str(root),
                rules=["telemetry-registry"])
    assert _msgs(clean, "telemetry-registry") == []

    ex = root / "raydp_tpu_torch" / "etl" / "executor.py"
    text = ex.read_text()
    assert text.count('"shuffle:bucket"') == 1
    ex.write_text(text.replace('"shuffle:bucket"', '"shuffle:buckety"'))
    report = run([str(root / "raydp_tpu_torch")], root=str(root),
                 rules=["telemetry-registry"])
    msgs = _msgs(report, "telemetry-registry")
    assert any("'shuffle:bucket'" in m and "no linted code references" in m
               for m in msgs), msgs


def test_fence_breaks_when_telemetry_doc_table_stale(tmp_path, capsys):
    """Doc drift + the --write-docs roundtrip: a hand-edited generated
    table is a violation until `python -m raydp_tpu_torch.metrics --write-docs`
    regenerates it."""
    root = _port_copy(tmp_path)
    clean = run([str(root / "raydp_tpu_torch")], root=str(root),
                rules=["telemetry-registry"])
    assert _msgs(clean, "telemetry-registry") == []

    doc = root / "raydp_tpu_torch" / "doc" / "observability.md"
    doc.write_text(doc.read_text().replace(
        "| `store_ops_total` |", "| `store_ops_totally` |"))
    report = run([str(root / "raydp_tpu_torch")], root=str(root),
                 rules=["telemetry-registry"])
    assert any("stale" in m and "raydp_tpu_torch.metrics --write-docs" in m
               for m in _msgs(report, "telemetry-registry"))

    from raydp_tpu_torch.metrics import main as metrics_main
    assert metrics_main(["--write-docs", "--root", str(root)]) == 0
    assert "rewrote" in capsys.readouterr().out
    report = run([str(root / "raydp_tpu_torch")], root=str(root),
                 rules=["telemetry-registry"])
    assert _msgs(report, "telemetry-registry") == []


# ---------------------------------------------------------------------------
# the registries the lint reads: the port's against the reference's
# ---------------------------------------------------------------------------

#: the reference's knobs whose slices are not ported yet: the sharded train
#: state's role map (ROADMAP 12c)
KNOBS_NOT_PORTED = {"RDT_TRAIN_SHARD_ROLES"}
#: the gang knobs whose docs name the port's process group where the
#: reference's name ``jax.distributed`` (the names stay the reference's)
PORT_KNOB_DOCS = {
    "RDT_SPMD_COORDINATOR":
        "torch.distributed rendezvous address override (the host:port of "
        "init_process_group's tcp:// store).",
    "RDT_SPMD_JAX_DISTRIBUTED":
        "Whether a rank worker calls "
        "torch.distributed.init_process_group().",
}
#: the reference's telemetry the port does not emit yet: the pipeline
#: schedule's gauge and span (ROADMAP 12d)
TELEMETRY_NOT_PORTED = {"train_pipeline_stages", "train:pipeline"}


def _standalone(package: str, module: str):
    """``<package>/<module>.py`` loaded on its own, stdlib only, as the lint
    loads a registry: registered in ``sys.modules`` while it executes (its
    dataclasses resolve their module there)."""
    name = f"_standalone_{package}_{module}"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, package, f"{module}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(name, None)
    return mod


def _port_named(text: str) -> str:
    """The reference's text with its package name re-pointed at the port."""
    return re.sub(r"raydp_tpu(?!_torch)", "raydp_tpu_torch", text)


def test_every_port_knob_is_the_reference_entry_field_for_field():
    ref = _standalone("raydp_tpu", "knobs")
    port = _standalone("raydp_tpu_torch", "knobs")
    assert [f.name for f in dataclasses.fields(port.Knob)] \
        == [f.name for f in dataclasses.fields(ref.Knob)]
    assert (port.PER_ACTION, port.PROCESS_START) \
        == (ref.PER_ACTION, ref.PROCESS_START)
    assert len(port.KNOBS) == 97
    for name, knob in port.KNOBS.items():
        got = dataclasses.asdict(knob)
        want = dataclasses.asdict(ref.KNOBS[name])
        want["doc"] = _port_named(want["doc"])
        if name in PORT_KNOB_DOCS:
            assert "jax.distributed" in want["doc"]
            assert got.pop("doc") == PORT_KNOB_DOCS[name]
            want.pop("doc")
        if name == "RDT_WARM_IMPORTS":
            # the prototype pre-imports torch where the reference's imports
            # jax
            assert got.pop("default").split(",") == [
                "torch" if m == "jax" else m
                for m in want.pop("default").split(",")]
        assert got == want, name


def test_the_knobs_the_port_lacks_are_the_gang_and_sharding_ones():
    ref = _standalone("raydp_tpu", "knobs")
    port = _standalone("raydp_tpu_torch", "knobs")
    assert set(ref.KNOBS) - set(port.KNOBS) == KNOBS_NOT_PORTED
    assert not set(port.KNOBS) - set(ref.KNOBS)


def test_every_port_telemetry_entry_is_the_reference_s():
    ref = _standalone("raydp_tpu", "metrics")
    port = _standalone("raydp_tpu_torch", "metrics")
    for reg in ("METRICS", "SPANS", "EVENTS"):
        theirs, ours = getattr(ref, reg), getattr(port, reg)
        assert not set(ours) - set(theirs), reg
        for name, entry in ours.items():
            assert dataclasses.asdict(entry) \
                == dataclasses.asdict(theirs[name]), name
    lacking = {n for reg in ("METRICS", "SPANS", "EVENTS")
               for n in set(getattr(ref, reg)) - set(getattr(port, reg))}
    assert lacking == TELEMETRY_NOT_PORTED


def test_every_knob_category_has_a_generated_table():
    port = _standalone("raydp_tpu_torch", "knobs")
    tables = dict((cat, rel) for rel, cat in port.DOC_TABLES)
    assert {k.category for k in port.KNOBS.values()} | {None} == set(tables)
    for rel in tables.values():
        assert rel.startswith("raydp_tpu_torch/doc/")
        assert os.path.exists(os.path.join(REPO, rel)), rel


@pytest.mark.parametrize("module", ["knobs", "metrics"])
def test_write_docs_twice_changes_nothing_the_second_time(tmp_path, capsys,
                                                          module):
    """``python -m raydp_tpu_torch.<module> --write-docs`` over a copy of
    the port's docs with one stale table rewrites it back to the committed
    file, and a second run rewrites nothing."""
    mod = _standalone("raydp_tpu_torch", module)
    shutil.copytree(os.path.join(PKG, "doc"),
                    tmp_path / "raydp_tpu_torch" / "doc")
    rel, row = ("raydp_tpu_torch/doc/etl.md", "| `RDT_ETL_AQE` |")
    if module == "metrics":
        rel, row = mod.DOC_FILE, "| `store_ops_total` |"
    doc = tmp_path / rel
    assert doc.read_text().count(row) == 1
    doc.write_text(doc.read_text().replace(row, "| `stale` |"))
    assert mod.main(["--write-docs", "--root", str(tmp_path)]) == 0
    assert f"rewrote {rel}" in capsys.readouterr().out
    assert mod.main(["--write-docs", "--root", str(tmp_path)]) == 0
    assert "rewrote" not in capsys.readouterr().out
    for name in os.listdir(os.path.join(PKG, "doc")):
        with open(os.path.join(PKG, "doc", name), encoding="utf-8") as fh:
            assert (tmp_path / "raydp_tpu_torch" / "doc" / name).read_text(
                encoding="utf-8") == fh.read(), name


def test_write_rpc_docs_on_the_port_tree_is_already_fresh(capsys):
    assert rdtlint_main([PKG, "--root", REPO, "--write-rpc-docs"]) == 0
    assert capsys.readouterr().out.strip() == "rpc-surface table already fresh"
