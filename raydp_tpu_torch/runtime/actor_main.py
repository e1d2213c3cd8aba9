"""Actor process bootstrap (``python -m raydp_tpu_torch.runtime.actor_main``).

The spawn handshake mirrors the reference's conn-info protocol — the reference
launches its gateway JVM and reads the bound port back through a temp file
(ray_cluster_master.py:103-183, AppMasterEntryPoint.scala:50-94); here the child
instead reports its bound RPC address to the head over the head's own RPC channel
and fetches its cloudpickled spec. Like the reference's entry point, the process
must die with its supervisor: we watch the head connection and exit when it drops
(AppMasterEntryPoint.scala exits on stdin EOF).
"""

from __future__ import annotations

import os
import sys
import threading
import time

import cloudpickle

from raydp_tpu_torch.log import init_logging
from raydp_tpu_torch.runtime import object_store as objstore
from raydp_tpu_torch.runtime.actor import ActorContext, actor_context
from raydp_tpu_torch.runtime.head import (
    ENV_ACTOR_ID, ENV_HEAD, ENV_SESSION, ENV_SESSION_DIR, session_root,
)
from raydp_tpu_torch.runtime.object_store import ObjectStoreClient
from raydp_tpu_torch.runtime.rpc import (
    MethodDispatcher, RpcClient, RpcServer, connect_with_retry,
)


class StoreTableProxy:
    """Forwards ObjectStoreServer's table methods to the head over RPC."""

    def __init__(self, head: RpcClient):
        self._head = head

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        method = f"store_{item}"

        def _call(*args):
            return self._head.call(method, *args)

        return _call


class _ActorServer:
    """Wraps the user object: exposes its public methods plus runtime intrinsics."""

    def __init__(self, instance):
        self._instance = instance
        self._dispatch = MethodDispatcher(instance)

    def __call__(self, method: str, args: tuple, kwargs: dict):
        if method == "__rdt_ping__":
            return "pong"
        if method == "__rdt_shutdown__":
            threading.Thread(target=_delayed_exit, daemon=True).start()
            return True
        if method == "__rdt_spans__":
            from raydp_tpu_torch import profiler
            return profiler.export_spans()
        if method == "__rdt_metrics__":
            from raydp_tpu_torch import metrics
            return metrics.export_state()
        if method == "__rdt_clock__":
            # the driver's clock-offset handshake: this process's wall
            # clock, nothing else — the round trip must stay minimal
            return time.time_ns()
        return self._dispatch(method, args, kwargs)


def _delayed_exit():
    time.sleep(0.2)
    _close_store()
    os._exit(0)


def _close_store():
    """Close this actor process's store client before exit: detaches cached
    segment handles and closes peer payload-host connections, so a graceful
    executor shutdown (or a scale-down cycle) does not strand sockets on the
    node agents it fetched from."""
    try:
        client = objstore._client  # noqa: SLF001 (process-global)
        if client is not None:
            client.close()
    except Exception:
        pass


def main() -> None:
    head_url = os.environ[ENV_HEAD]
    actor_id = os.environ[ENV_ACTOR_ID]
    session_id = os.environ[ENV_SESSION]
    session_dir = os.environ.get(ENV_SESSION_DIR) or session_root()

    host, port = head_url.rsplit(":", 1)
    head = connect_with_retry((host, int(port)))
    spec = head.call("fetch_actor_spec", actor_id)

    name = spec["name"]
    role = name or actor_id
    init_logging(role, spec.get("log_level", "INFO"),
                 os.path.join(session_dir, "logs"), session_id)

    store = ObjectStoreClient(StoreTableProxy(head), session_id,
                              default_owner=name or actor_id)
    objstore.set_client(store)

    ctx = ActorContext(
        actor_id=actor_id,
        name=name,
        node_id=spec["node_id"],
        was_restarted=spec["was_restarted"],
        restart_count=spec["restart_count"],
        head_client=head,
        session_id=session_id,
    )
    actor_context(ctx)

    cls = cloudpickle.loads(spec["cls_bytes"])
    args, kwargs = cloudpickle.loads(spec["args_bytes"])
    instance = cls(*args, **kwargs)

    server = RpcServer(_ActorServer(instance), host="127.0.0.1", port=0,
                       max_concurrency=max(2, int(spec["max_concurrency"])),
                       name=role)
    head.call("actor_ready", actor_id, server.address[0], server.address[1])

    # die with the head: if the driver goes away, so do we
    try:
        while True:
            head.call("ping", timeout=30.0)
            time.sleep(5.0)
    except Exception:
        pass
    finally:
        server.stop()
        _close_store()
        os._exit(0)


if __name__ == "__main__":
    main()
