"""The static RPC surface map: which remote methods exist, with what
signatures, on which server class.

Everything control-plane in this repo is stringly-typed glue — every hop is
``client.call("method_name", args...)`` resolved by ``getattr`` at run time
(``runtime/rpc.py`` MethodDispatcher), so a typo'd name or drifted arity is
a runtime ``AttributeError``/``TypeError`` inside a ``RemoteError``, found
only when that exact hop fires. This module rebuilds the surface from the
AST so rule ``rpc-surface`` (and the generated table in
``raydp_tpu_torch/doc/dev_lint.md``) can check call sites against it:

- public methods of the configured dispatch-target classes
  (:data:`config.RPC_SURFACE_CLASSES`) plus any class auto-detected as a
  ``MethodDispatcher(Cls(...))`` / ``RpcServer(Cls(...))`` target;
- ``__call__(self, method, ...)`` if-chain handlers (``_ActorServer``):
  their ``method == "literal"`` branches become surface
  entries, with the arity of the helper the branch forwards ``*args`` to;
- the head's ``store_<m>`` proxies, resolved through to the
  ``ObjectStoreServer.<m>`` signature they forward to.

Pure AST — no raydp_tpu_torch runtime import.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from raydp_tpu_torch.tools.rdtlint import config
from raydp_tpu_torch.tools.rdtlint.core import Project, SourceFile


@dataclass
class MethodSig:
    """One remote method's call contract, extracted from its ``def``."""

    name: str
    cls: str
    rel: str
    line: int
    pos_names: Tuple[str, ...] = ()     # positional params, self stripped
    min_pos: int = 0
    max_pos: Optional[int] = None       # None = *args
    kwnames: frozenset = frozenset()
    has_kwargs: bool = False
    note: str = ""                      # e.g. "proxy → ObjectStoreServer.seal"

    def render_args(self) -> str:
        parts = list(self.pos_names[:self.min_pos])
        parts += [f"{n}=…" for n in self.pos_names[self.min_pos:]]
        if self.max_pos is None:
            parts.append("*args")
        parts += [f"{n}=…" for n in sorted(self.kwnames
                                           - set(self.pos_names))]
        if self.has_kwargs:
            parts.append("**kw")
        return ", ".join(parts)

    def check_call(self, pos_args: List[ast.AST],
                   keywords: List[ast.keyword]) -> Optional[str]:
        """None when the call site fits this signature, else a message.
        ``timeout=`` is excluded (consumed by RpcClient.call, never
        forwarded)."""
        if any(isinstance(a, ast.Starred) for a in pos_args) \
                or any(kw.arg is None for kw in keywords):
            return None  # *args / **kwargs at the call site: unknowable
        npos = len(pos_args)
        named = set()
        for kw in keywords:
            if kw.arg == "timeout":
                continue
            if kw.arg in self.kwnames or self.has_kwargs:
                named.add(kw.arg)
            else:
                return (f"unknown keyword {kw.arg!r} (remote signature: "
                        f"{self.name}({self.render_args()}))")
        if self.max_pos is not None and npos > self.max_pos:
            return (f"{npos} positional argument(s) but the remote "
                    f"signature takes at most {self.max_pos}: "
                    f"{self.name}({self.render_args()})")
        # positional params satisfied positionally or by a matching keyword
        satisfied = npos + len(named & set(self.pos_names[npos:]))
        if satisfied < self.min_pos:
            return (f"{npos} positional argument(s) but the remote "
                    f"signature requires {self.min_pos}: "
                    f"{self.name}({self.render_args()})")
        return None


@dataclass
class SurfaceMap:
    #: surface tag -> method name -> MethodSig
    surfaces: Dict[str, Dict[str, MethodSig]] = field(default_factory=dict)
    #: class name -> (SourceFile, ClassDef) for every scanned class
    class_defs: Dict[str, Tuple[SourceFile, ast.ClassDef]] = field(
        default_factory=dict)

    def methods(self, tag: str) -> Dict[str, MethodSig]:
        return self.surfaces.get(tag, {})

    def union(self) -> Dict[str, List[MethodSig]]:
        out: Dict[str, List[MethodSig]] = {}
        for tag in self.surfaces:
            for name, sig in self.surfaces[tag].items():
                out.setdefault(name, []).append(sig)
        return out

    def has_surface(self, tag: str) -> bool:
        return bool(self.surfaces.get(tag))


def sig_of(fn: ast.FunctionDef, cls: str, rel: str,
           note: str = "") -> MethodSig:
    a = fn.args
    pos = [p.arg for p in a.posonlyargs + a.args]
    if pos and pos[0] in ("self", "cls"):
        pos = pos[1:]
    n_def = len(a.defaults)
    return MethodSig(
        name=fn.name, cls=cls, rel=rel, line=fn.lineno,
        pos_names=tuple(pos),
        min_pos=max(0, len(pos) - n_def),
        max_pos=None if a.vararg else len(pos),
        kwnames=frozenset(pos) | {p.arg for p in a.kwonlyargs},
        has_kwargs=a.kwarg is not None,
        note=note)


def _if_chain_entries(src: SourceFile, cls: ast.ClassDef
                      ) -> Optional[Dict[str, MethodSig]]:
    """Surface of a ``__call__(self, method, args, kwargs)`` if-chain
    handler; None when the class has no such handler. A branch returning
    ``self._helper(*args)`` takes the helper's signature; anything else is
    arity-unconstrained."""
    call = next((n for n in cls.body if isinstance(n, ast.FunctionDef)
                 and n.name == "__call__"), None)
    if call is None:
        return None
    params = [p.arg for p in call.args.args]
    if len(params) < 2 or params[1] != "method":
        return None
    helpers = {n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)}
    out: Dict[str, MethodSig] = {}
    for node in ast.walk(call):
        if not isinstance(node, ast.If):
            continue
        t = node.test
        if not (isinstance(t, ast.Compare) and isinstance(t.left, ast.Name)
                and t.left.id == "method" and len(t.ops) == 1
                and isinstance(t.ops[0], ast.Eq)
                and isinstance(t.comparators[0], ast.Constant)
                and isinstance(t.comparators[0].value, str)):
            continue
        meth = t.comparators[0].value
        sig = MethodSig(name=meth, cls=cls.name, rel=src.rel,
                        line=node.lineno, note="dispatch if-chain")
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and isinstance(sub.func.value, ast.Name) \
                    and sub.func.value.id == "self" \
                    and sub.func.attr in helpers \
                    and any(isinstance(arg, ast.Starred)
                            for arg in sub.args):
                helper = sig_of(helpers[sub.func.attr], cls.name, src.rel,
                                note=f"dispatch if-chain → "
                                     f"{cls.name}.{sub.func.attr}")
                sig = MethodSig(name=meth, cls=cls.name, rel=src.rel,
                                line=node.lineno, pos_names=helper.pos_names,
                                min_pos=helper.min_pos,
                                max_pos=helper.max_pos,
                                kwnames=helper.kwnames,
                                has_kwargs=helper.has_kwargs,
                                note=sig.note or helper.note)
                break
        out[meth] = sig
    return out or None


def _detected_dispatch_classes(project: Project) -> List[str]:
    """Class names constructed directly inside ``MethodDispatcher(...)`` /
    ``RpcServer(...)`` — the same auto-detection the dispatcher-blocking
    rule uses, so fixtures need no config edits."""
    out: List[str] = []
    for src in project.files:
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in ("MethodDispatcher", "RpcServer")
                    and node.args):
                continue
            inner = node.args[0]
            if isinstance(inner, ast.Call) \
                    and isinstance(inner.func, ast.Name):
                if inner.func.id == "MethodDispatcher" and inner.args \
                        and isinstance(inner.args[0], ast.Call) \
                        and isinstance(inner.args[0].func, ast.Name):
                    inner = inner.args[0]
                if inner.func.id != "MethodDispatcher":
                    out.append(inner.func.id)
    return out


def build(project: Project) -> SurfaceMap:
    smap = SurfaceMap()
    for src in project.files:
        for node in src.tree.body:
            if isinstance(node, ast.ClassDef):
                smap.class_defs.setdefault(node.name, (src, node))

    by_class: Dict[str, str] = {}
    for tag, classes in config.RPC_SURFACE_CLASSES.items():
        for cls in classes:
            by_class[cls] = tag
    for cls in _detected_dispatch_classes(project):
        by_class.setdefault(cls, f"detected:{cls}")

    for cls, tag in sorted(by_class.items()):
        found = smap.class_defs.get(cls)
        if found is None:
            continue
        src, node = found
        methods = smap.surfaces.setdefault(tag, {})
        chain = _if_chain_entries(src, node)
        if chain:
            methods.update(chain)
        for item in node.body:
            if isinstance(item, ast.FunctionDef) \
                    and not item.name.startswith("_"):
                methods[item.name] = sig_of(item, cls, src.rel)

    # resolve head store_* proxies through to the store server's signature:
    # `def store_seal(self, *a)` carries no arity of its own
    head = smap.surfaces.get("head", {})
    store = smap.surfaces.get("store", {})
    prefix = config.RPC_STORE_PROXY_PREFIX
    for name in list(head):
        if not name.startswith(prefix):
            continue
        target = store.get(name[len(prefix):])
        proxy = head[name]
        if target is not None and proxy.max_pos is None \
                and not proxy.pos_names:
            head[name] = MethodSig(
                name=name, cls=proxy.cls, rel=proxy.rel, line=proxy.line,
                pos_names=target.pos_names, min_pos=target.min_pos,
                max_pos=target.max_pos, kwnames=target.kwnames,
                has_kwargs=target.has_kwargs,
                note=f"proxy → {target.cls}.{target.name}")
    return smap


# ---- generated doc table -----------------------------------------------------

RPC_TABLE_BEGIN = "<!-- rdtlint:rpc-table:begin -->"
RPC_TABLE_END = "<!-- rdtlint:rpc-table:end -->"

#: tag → how the table labels the surface (detected:* tags are fixture-only
#: and never reach the doc)
_TABLE_SURFACES = (
    ("head", "head (`HeadService`)"),
    ("agent", "node agent (`NodeAgentService`)"),
    ("store", "store table (`ObjectStoreServer`)"),
    ("actor", "actor dispatch"),
)


def generate_table(smap: SurfaceMap) -> str:
    lines = ["| Surface | Method | Arguments | Notes |",
             "| --- | --- | --- | --- |"]
    for tag, label in _TABLE_SURFACES:
        for name in sorted(smap.methods(tag)):
            sig = smap.methods(tag)[name]
            args = sig.render_args() or "—"
            note = sig.note
            if tag == "actor" and sig.cls != "_ActorServer":
                note = (note + "; " if note else "") + f"`{sig.cls}`"
            lines.append(f"| {label} | `{name}` | `{args}` | {note} |")
    return "\n".join(lines)


def render_block(smap: SurfaceMap) -> str:
    return f"{RPC_TABLE_BEGIN}\n{generate_table(smap)}\n{RPC_TABLE_END}"


def write_doc_table(project: Project,
                    doc_rel: str = f"{config.DOC_DIR}/dev_lint.md"
                    ) -> List[str]:
    """Rewrite the marker block from the current surface map; returns the
    files changed (empty = already fresh). Used by ``--write-rpc-docs``.

    Fails LOUDLY when the doc or its markers are missing — a wrong ``--root``
    must not report success while the drift fence keeps failing (the same
    contract as core.Project.load's missing-path error)."""
    import os

    path = os.path.join(project.root, doc_rel)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no {doc_rel} under {project.root} — wrong --root?")
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    if RPC_TABLE_BEGIN not in text or RPC_TABLE_END not in text:
        raise ValueError(
            f"{doc_rel} has no {RPC_TABLE_BEGIN} / {RPC_TABLE_END} markers "
            "— add them where the table should live, then rerun")
    head_part, rest = text.split(RPC_TABLE_BEGIN, 1)
    _, tail = rest.split(RPC_TABLE_END, 1)
    new = head_part + render_block(build(project)) + tail
    if new == text:
        return []
    with open(path, "w", encoding="utf-8") as f:
        f.write(new)
    return [doc_rel]
