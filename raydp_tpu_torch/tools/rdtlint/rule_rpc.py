"""Rule ``rpc-surface``: every literal cross-process call resolves.

The control plane is stringly typed by design (one wire format, getattr
dispatch — ``runtime/rpc.py``), which makes three drifts invisible until the
exact hop fires at run time, inside a ``RemoteError``:

1. **typo'd / renamed method** — ``head.call("lokup", ...)`` is an
   AttributeError on the server;
2. **arity drift** — a server signature gained a required parameter and some
   call site still passes the old shape (TypeError on the server);
3. **proxy drift** — the head proxies the store table verbatim
   (``HeadService.store_<m>`` → ``ObjectStoreServer.<m>``); a store method
   the client drives through ``self._server.<m>`` without a matching proxy
   works in-process (the head holds the real server) and explodes only in a
   client-mode driver or actor process, where ``self._server`` is the
   ``StoreTableProxy``.

Checks, against the AST-built surface map (:mod:`surfaces`):

- every ``<recv>.call("name", ...)`` / ``<recv>.submit("name", ...)`` with a
  literal method name resolves on the receiver's surface
  (:data:`config.RPC_RECEIVER_SURFACES`; unmapped receivers check against
  the union of all surfaces) with compatible arity (``timeout=`` excluded —
  RpcClient consumes it);
- no literal call targets an underscore method (MethodDispatcher refuses
  them) except the ``__rdt_*`` actor intrinsics;
- head proxy completeness both ways: every store method the client calls
  has a ``store_<m>`` proxy, and every ``store_<m>`` proxy forwards to a
  real, same-named store server method;
- the generated RPC-surface table in ``raydp_tpu_torch/doc/dev_lint.md``
  matches the map
  (``python -m raydp_tpu_torch.tools.rdtlint --write-rpc-docs`` regenerates).

Precision limits: calls whose method name is a variable (the StoreTableProxy
forwarders) and attribute-style actor calls (``handle.run_task(...)``)
create no check; a receiver the map cannot name falls back to the union, so
a method existing on ANY surface passes.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional

from raydp_tpu_torch.tools.rdtlint import config, surfaces
from raydp_tpu_torch.tools.rdtlint.core import (
    Project, Violation, marker_block_violation)

RULE = "rpc-surface"

_CALL_ATTRS = ("call", "submit")


def _receiver_name(recv: ast.AST) -> Optional[str]:
    """The name the receiver map keys on: the variable, its attribute, or
    the function that produced it (``self._peer(addr).call``)."""
    if isinstance(recv, ast.Name):
        return recv.id
    if isinstance(recv, ast.Attribute):
        return recv.attr
    if isinstance(recv, ast.Call):
        return _receiver_name(recv.func)
    return None


def _surface_tags(recv_name: Optional[str], smap: surfaces.SurfaceMap
                  ) -> Optional[List[str]]:
    """Surfaces to resolve against, or None to skip the site (a mapped tag
    whose server class is outside this lint run)."""
    tag = config.RPC_RECEIVER_SURFACES.get(recv_name or "")
    if tag is None or tag == "*":
        tags = [t for t in smap.surfaces if smap.has_surface(t)]
        return tags or None
    if not smap.has_surface(tag):
        return None  # targeted run without the server class: unknowable
    return [tag]


def _check_site(src, node: ast.Call, smap: surfaces.SurfaceMap,
                out: List[Violation]) -> None:
    meth_node = node.args[0]
    method = meth_node.value
    recv_name = _receiver_name(node.func.value)

    if method.startswith("_") \
            and method not in config.RPC_INTRINSIC_METHODS:
        out.append(Violation(
            rule=RULE, path=src.rel, line=node.lineno,
            message=(f"remote call targets underscore method {method!r} — "
                     "MethodDispatcher refuses it; this site can only ever "
                     "raise AttributeError inside a RemoteError")))
        return
    if method in config.RPC_INTRINSIC_METHODS:
        return  # served by _ActorServer before dispatch, any arity

    tags = _surface_tags(recv_name, smap)
    if tags is None:
        return
    candidates = [smap.methods(t)[method] for t in tags
                  if method in smap.methods(t)]
    if not candidates:
        where = (f"surface {tags[0]!r}" if len(tags) == 1
                 else "any linted RPC surface")
        out.append(Violation(
            rule=RULE, path=src.rel, line=node.lineno,
            message=(f"remote call {method!r} resolves on no method of "
                     f"{where} — a typo'd or renamed RPC is a runtime "
                     "AttributeError inside a RemoteError")))
        return
    errors = []
    for sig in candidates:
        err = sig.check_call(list(node.args[1:]), list(node.keywords))
        if err is None:
            return
        errors.append(err)
    out.append(Violation(
        rule=RULE, path=src.rel, line=node.lineno,
        message=f"remote call {method!r}: {errors[0]}"))


def _check_proxy_completeness(project: Project,
                              smap: surfaces.SurfaceMap,
                              out: List[Violation]) -> None:
    client = smap.class_defs.get(config.RPC_STORE_CLIENT_CLASS)
    server = smap.class_defs.get(config.RPC_STORE_SERVER_CLASS)
    head = smap.class_defs.get(config.RPC_HEAD_SERVICE_CLASS)
    if client is None or server is None or head is None:
        return  # targeted run: the triple is not in scope
    prefix = config.RPC_STORE_PROXY_PREFIX
    server_methods = {n.name for n in server[1].body
                      if isinstance(n, ast.FunctionDef)}
    head_methods = {n.name: n for n in head[1].body
                    if isinstance(n, ast.FunctionDef)}

    # every client-driven store method has a head proxy and a real target
    src, cls = client
    seen = set()
    for node in ast.walk(cls):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Attribute)
                and isinstance(node.func.value.value, ast.Name)
                and node.func.value.value.id == "self"
                and node.func.value.attr == "_server"):
            continue
        m = node.func.attr
        if m in seen:
            continue
        seen.add(m)
        if m not in server_methods:
            out.append(Violation(
                rule=RULE, path=src.rel, line=node.lineno,
                message=(f"{config.RPC_STORE_CLIENT_CLASS} calls "
                         f"self._server.{m}() but "
                         f"{config.RPC_STORE_SERVER_CLASS} defines no such "
                         "method")))
        if prefix + m not in head_methods:
            out.append(Violation(
                rule=RULE, path=src.rel, line=node.lineno,
                message=(f"store method {m!r} is driven through "
                         "self._server but the head has no "
                         f"{prefix}{m} proxy — works in-process, "
                         "AttributeError inside a RemoteError for every "
                         "actor/client-mode process (StoreTableProxy "
                         "forwards it to the head)")))

    # every store_* proxy forwards to a real, same-named server method
    hsrc, _hcls = head
    for name, fn in head_methods.items():
        if not name.startswith(prefix) or name.startswith("_"):
            continue
        target = name[len(prefix):]
        forwards: List[str] = [
            sub.func.attr for sub in ast.walk(fn)
            if isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and isinstance(sub.func.value, ast.Attribute)
            and sub.func.value.attr == "store_server"]
        if target not in server_methods:
            out.append(Violation(
                rule=RULE, path=hsrc.rel, line=fn.lineno,
                message=(f"head proxy {name} forwards to "
                         f"{config.RPC_STORE_SERVER_CLASS}.{target} which "
                         "does not exist — dead proxy or renamed server "
                         "method")))
        elif forwards and target not in forwards:
            out.append(Violation(
                rule=RULE, path=hsrc.rel, line=fn.lineno,
                message=(f"head proxy {name} forwards to store_server."
                         f"{forwards[0]} but its name promises {target!r} — "
                         "StoreTableProxy routes by name, so this proxy "
                         "serves the wrong method")))


def _check_doc_table(project: Project, smap: surfaces.SurfaceMap,
                     out: List[Violation]) -> None:
    """Mirror of the knob-table drift fence: only meaningful on a run that
    sees the real surfaces (≥ 3 configured surface tags present)."""
    present = sum(1 for tag in config.RPC_SURFACE_CLASSES
                  if smap.has_surface(tag))
    doc_rel = f"{config.DOC_DIR}/dev_lint.md"
    path = os.path.join(project.root, doc_rel)
    if present < 3 or not os.path.exists(path):
        return
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    v = marker_block_violation(
        RULE, doc_rel, text, surfaces.RPC_TABLE_BEGIN,
        surfaces.RPC_TABLE_END, surfaces.render_block(smap), "RPC-surface",
        "python -m raydp_tpu_torch.tools.rdtlint --write-rpc-docs")
    if v is not None:
        out.append(v)


def check(project: Project) -> List[Violation]:
    smap = surfaces.build(project)
    out: List[Violation] = []
    if smap.surfaces:
        for src in project.files:
            for node in ast.walk(src.tree):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _CALL_ATTRS \
                        and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    _check_site(src, node, smap, out)
    _check_proxy_completeness(project, smap, out)
    _check_doc_table(project, smap, out)
    return out
