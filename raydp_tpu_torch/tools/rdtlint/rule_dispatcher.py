"""Rule ``dispatcher-blocking``: no blocking primitive may be reachable from
an RPC dispatcher entry point by direct calls.

The invariant this encodes (PAPER.md §(a) actor discipline, load-bearing
since the pipelined shuffle): **waits never park head dispatchers**. An RPC
handler runs on a bounded thread pool; if it blocks on work that needs that
same pool — a long-poll, a ``Future.result`` completed by another handler, a
synchronous call back over the connection that is delivering it — the pool
can wedge entirely. Both historical deadlocks had this shape:

- ``_free_late_result`` fired as a Future done-callback on an executor
  connection's READ LOOP and synchronously called back over that same
  connection — blocking the only thread able to deliver its own response.
- a streaming ``run_task`` waiting for seal notifications on a bounded
  dispatcher thread while the map tasks it waited on queued behind it.

Escapes are structural: hand the blocking work to a spawned thread and (for
handlers) return a ``DeferredReply`` — a function that is only *referenced*
(thread target, ``pool.submit``, done-callback) is not an edge, so escaped
work is invisible to the traversal by construction.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

from raydp_tpu_torch.tools.rdtlint import callgraph
from raydp_tpu_torch.tools.rdtlint.core import Project, Violation

RULE = "dispatcher-blocking"


def check(project: Project) -> List[Violation]:
    graph = callgraph.build(project)
    entries = graph.entry_functions()
    # BFS over direct-call edges from every entry, remembering one shortest
    # path per reached function for the report
    reached: Dict[str, Tuple[str, List[str]]] = {}  # qual -> (why, path)
    for entry_qual, why in entries:
        if entry_qual not in graph.functions:
            continue
        q = deque([(entry_qual, [entry_qual])])
        while q:
            qual, path = q.popleft()
            if qual in reached:
                continue
            reached[qual] = (why if qual == entry_qual
                             else reached[path[0]][0], path)
            fn = graph.functions[qual]
            for ref, _line in fn.calls:
                target = graph.resolve(fn.module, fn.class_name, ref)
                if target and target in graph.functions \
                        and target not in reached:
                    q.append((target, path + [target]))

    out: List[Violation] = []
    seen: set = set()
    for qual, (why, path) in sorted(reached.items()):
        fn = graph.functions[qual]
        for blk in fn.blocking:
            key = (fn.rel, blk.line)
            if key in seen:
                continue
            seen.add(key)
            chain = " -> ".join(p.rsplit(".", 1)[-1] for p in path)
            out.append(Violation(
                rule=RULE, path=fn.rel, line=blk.line,
                message=(
                    f"{blk.detail} runs on an RPC dispatcher/read-loop "
                    f"thread ({why}; call path {chain}) — hand off to a "
                    "spawned thread and return a DeferredReply, or suppress "
                    "with a reason if the wait is provably bounded and "
                    "never feeds back into this pool")))
    return out
