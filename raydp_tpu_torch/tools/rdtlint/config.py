"""Project-native configuration of the rdtlint rules, for the port's tree.

rdtlint is not a generic linter: these names encode *this* package's runtime
architecture. Keep them in sync with the modules they describe (the
``fault-site-sync`` and ``knob-registry`` rules are self-syncing; this file
covers what cannot be derived from the AST alone). Every class named here
exists in ``raydp_tpu_torch``; the gang runner's ``_DriverService`` and
``_WorkerService`` (``spmd/``, with their ``"driver"`` and ``"worker"``
surfaces) are not ported yet and are added back with it.
"""

# ---- where the port's docs and tests are -----------------------------------

#: the directory, relative to the repo root, that holds the port's docs: the
#: generated knob, telemetry and RPC-surface tables and the fault-site table
#: (the repo's ``doc/`` is the reference's)
DOC_DIR = "raydp_tpu_torch/doc"

#: the repo subdirectories the cross-checks scan (``RDT_FAULTS`` specs), each
#: with the file pattern that selects the port's files there: the rest of
#: ``tests/`` arms the reference's fault sites
EXTRA_FILE_GLOBS = {"tests": "test_torch_*.py"}

#: classes whose PUBLIC methods run on a bounded RPC dispatcher thread pool
#: (``RpcServer(MethodDispatcher(...))`` targets, actor dispatch targets, and
#: the store server the head proxies into). The dispatcher-blocking rule also
#: auto-detects ``MethodDispatcher(Cls(...))`` / ``RpcServer(Cls(...))``
#: constructions; this list covers targets built through intermediate
#: variables the AST pass cannot follow.
ENTRY_CLASS_NAMES = frozenset({
    "HeadService",        # runtime/head.py — the head's RPC surface
    "NodeAgentService",   # runtime/node_agent.py
    "ObjectStoreServer",  # runtime/object_store.py — head dispatchers proxy
                          # store_* calls straight into it
    "ShuffleStreamLedger",  # runtime/object_store.py — ditto, stream_* calls
    "EtlExecutor",        # etl/executor.py — actor dispatch target
    "EtlMaster",          # etl/master.py — actor dispatch target; its
                          # executors also host the serving replicas
                          # (serve_* methods, serve/replica.py)
})

#: attribute names whose *call* is treated as a blocking primitive by the
#: dispatcher-blocking rule (receiver heuristics in callgraph.py narrow the
#: noisy ones: ``.join`` skips str/os.path joins, ``.get`` only fires on
#: store/queue-shaped receivers)
BLOCKING_ATTRS = frozenset({
    "sleep",   # time.sleep — parks the thread outright
    "result",  # concurrent.futures.Future.result — may wait on work that
               # needs THIS dispatcher pool to complete (the classic
               # self-deadlock)
    "call",    # RpcClient.call — a synchronous round trip; a head handler
               # calling back into a peer can deadlock on pool exhaustion
    "wait",    # Event/Condition wait, long-polls
    "join",    # Thread.join
})

#: receiver names (or suffixes) for which a ``.get(...)`` call is treated as
#: a blocking store/queue read rather than a dict lookup
STORE_GET_RECEIVERS = frozenset({"client", "store", "queue", "q"})
STORE_GET_SUFFIXES = ("_client", "_store", "_queue")

# ---- rule: rpc-surface ------------------------------------------------------

#: the RPC server surfaces, keyed by the short surface tag the receiver map
#: below points into. Every ``*.call("name", ...)`` site with a literal method
#: name resolves against one of these (or their union). ``_ActorServer``
#: dispatches through a ``__call__(method, ...)`` if-chain
#: rather than a MethodDispatcher — the surface builder extracts their
#: ``method == "literal"`` branches.
RPC_SURFACE_CLASSES = {
    "head": ("HeadService",),            # runtime/head.py
    "agent": ("NodeAgentService",),      # runtime/node_agent.py — also the
                                         # machine-local payload server that
                                         # ObjectStoreClient._peer dials
    "store": ("ObjectStoreServer",),     # runtime/object_store.py — reached
                                         # through the head's store_* proxies
    "actor": ("_ActorServer", "EtlExecutor", "EtlMaster"),
}

#: call-site receiver name → surface tag. The name is the receiver variable
#: (``head.call``), its attribute (``self._head.call``, ``ctx.head.call``),
#: or the function that PRODUCED it (``self._head_client().call(...)``,
#: ``self._peer(addr).call(...)``). ``"*"`` means "any surface" — used for
#: generic handles whose target class is dynamic (ActorHandle, the bootstrap
#: RpcClient). Receivers not in this map are checked against the union too:
#: inside this package a literal ``.call("name")`` is always an RPC.
RPC_RECEIVER_SURFACES = {
    "head": "head",
    "_head": "head",
    "_head_client": "head",
    "agent": "agent",
    "_agent": "agent",
    "_peer": "agent",
    "handle": "*",
    "client": "*",
    # the serving plane's replica handles (serve/session.py) are executor
    # actors: serve_* call sites resolve strictly against the actor surface
    "replica": "actor",
    "_replica": "actor",
}

#: actor-runtime intrinsics served by ``_ActorServer.__call__`` BEFORE the
#: MethodDispatcher underscore guard — the only legitimate underscore-leading
#: remote names.
RPC_INTRINSIC_METHODS = frozenset({
    "__rdt_ping__", "__rdt_shutdown__", "__rdt_spans__",
    "__rdt_metrics__", "__rdt_clock__",
})

#: head proxy naming: ``HeadService.store_<m>`` forwards to
#: ``ObjectStoreServer.<m>`` (the shape StoreTableProxy relies on)
RPC_STORE_PROXY_PREFIX = "store_"

#: the client class whose ``self._server.<m>(...)`` calls define which store
#: methods must stay proxy-reachable from a driver/actor process
RPC_STORE_CLIENT_CLASS = "ObjectStoreClient"
RPC_STORE_SERVER_CLASS = "ObjectStoreServer"
RPC_HEAD_SERVICE_CLASS = "HeadService"

# ---- rule: step-registry ----------------------------------------------------

#: the class whose instances read a shuffle stage through the seal-stream
#: ledger — it carries no ObjectRefs itself (ranges arrive at run time), but
#: every task holding one must be routed/resolved through the stream plane
STEP_STREAM_SOURCE_CLASS = "StreamingRangeSource"

#: handler functions in etl/tasks.py that every REF-carrying (and
#: nested-task-carrying) step class must be isinstance-handled in
STEP_REF_HANDLERS = ("_patch_step_refs", "task_input_ids")

#: handler functions in etl/tasks.py that every STREAM-carrying step class
#: (and nested-task carrier) must be handled in — by isinstance, or by a
#: ``getattr(step, "<attr>", ...)`` literal on each stream attribute
STEP_STREAM_HANDLERS = ("stream_sources_of", "resolve_stream_sources")

#: result-dict keys through which a task result may carry store refs; the
#: executor must write ref-valued results only under these keys and
#: ``engine._result_refs`` must harvest every one (a key missing there is an
#: orphan-blob leak on every failed stage)
STEP_RESULT_REF_KEYS = ("ref", "bucket_refs", "consolidated_ref")

#: engine.py functions that must each isinstance-handle ``_StreamBucket``
#: (the pipelined stage's bucket placeholder): locality weighting, reduce
#: source construction, and stream-key tagging
STEP_STREAM_BUCKET_FUNCS = ("_locality", "_bucket_source", "_bucket_task")

# ---- rule: exc-contract -----------------------------------------------------

#: non-builtin exception names that may legitimately cross the RPC boundary
#: as ``RemoteError.exc_type`` strings without a class definition in this
#: repo (the rule validates builtins via the ``builtins`` module and repo
#: classes from the AST; everything else must be listed here)
EXC_EXTERNAL_ALLOWLIST = frozenset({
    # pyarrow: raised by Arrow kernels inside executor task bodies
    "ArrowException", "ArrowInvalid", "ArrowNotImplementedError",
    "ArrowKeyError", "ArrowTypeError", "ArrowIndexError",
    "ArrowMemoryError", "ArrowCapacityError", "ArrowSerializationError",
})
