"""A lightweight, name-resolved call graph over the package's AST.

Deliberately conservative: an edge exists only for a DIRECT call the pass can
resolve by name — ``self.method(...)`` within a class, ``func(...)`` to a
module-level or imported function, ``mod.func(...)`` through an import alias,
and ``inner()`` to a nested def. A function merely *referenced* — passed to
``threading.Thread(target=...)``, ``pool.submit(...)``, or completing a
future behind a :class:`DeferredReply` — creates **no** edge: running code on
another thread is exactly how a handler legitimately escapes the dispatcher,
so "no direct call" and "escaped the dispatcher" coincide by construction.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from raydp_tpu_torch.tools.rdtlint import config
from raydp_tpu_torch.tools.rdtlint.core import Project, SourceFile

# call descriptors: ("local", name) | ("module", name) | ("self", attr)
# | ("import_func", fullname) | ("module_attr", module_fullname, attr)
# | ("self_attr", attr, meth) — self.<attr>.<meth>() through an instance
#   attribute whose class is known (constructed in __init__, or assigned
#   from an annotated __init__ parameter)
CallRef = Tuple


@dataclass
class Blocking:
    line: int
    kind: str
    detail: str


@dataclass
class FunctionInfo:
    qualname: str
    name: str
    module: str
    class_name: Optional[str]
    rel: str                      # file, repo-relative
    line: int
    calls: List[Tuple[CallRef, int]] = field(default_factory=list)
    blocking: List[Blocking] = field(default_factory=list)
    locals_defs: Dict[str, str] = field(default_factory=dict)


@dataclass
class CallGraph:
    functions: Dict[str, FunctionInfo] = field(default_factory=dict)
    #: module -> bare function name -> qualname
    module_funcs: Dict[str, Dict[str, str]] = field(default_factory=dict)
    #: module -> class name -> method name -> qualname
    classes: Dict[str, Dict[str, Dict[str, str]]] = field(
        default_factory=dict)
    #: per-module import alias -> module fullname
    mod_imports: Dict[str, Dict[str, str]] = field(default_factory=dict)
    #: per-module imported-function alias -> fullname
    func_imports: Dict[str, Dict[str, str]] = field(default_factory=dict)
    #: completion callbacks (add_done_callback): either an already-resolved
    #: qualname or an unresolved ("self", module, class, attr) /
    #: ("module", module, name) descriptor resolved once the whole index
    #: exists (the callback method may be defined later in the class body)
    callback_entries: List[Tuple[Tuple, int]] = field(default_factory=list)
    #: class names detected as RPC dispatch targets
    detected_entry_classes: List[str] = field(default_factory=list)
    #: (module, class) -> instance attr -> class name of what it holds
    attr_types: Dict[Tuple[str, str], Dict[str, str]] = field(
        default_factory=dict)

    # -- resolution -----------------------------------------------------------
    def resolve(self, module: str, class_name: Optional[str],
                ref: CallRef) -> Optional[str]:
        kind = ref[0]
        if kind == "local":
            return ref[1]  # already a qualname
        if kind == "self" and class_name:
            return self.classes.get(module, {}).get(
                class_name, {}).get(ref[1])
        if kind == "module":
            q = self.module_funcs.get(module, {}).get(ref[1])
            if q:
                return q
            full = self.func_imports.get(module, {}).get(ref[1])
            if full and full in self.functions:
                return full
            return None
        if kind == "import_func":
            return ref[1] if ref[1] in self.functions else None
        if kind == "module_attr":
            return self.module_funcs.get(ref[1], {}).get(ref[2])
        if kind == "self_attr" and class_name:
            held = self.attr_types.get((module, class_name), {}).get(ref[1])
            if held:
                return self._class_method(module, held, ref[2])
        return None

    def _class_method(self, prefer_module: str, cls: str,
                      meth: str) -> Optional[str]:
        q = self.classes.get(prefer_module, {}).get(cls, {}).get(meth)
        if q:
            return q
        for mod in sorted(self.classes):
            q = self.classes[mod].get(cls, {}).get(meth)
            if q:
                return q
        return None

    def entry_functions(self) -> List[Tuple[str, str]]:
        """(qualname, why) for every analysis entry point: public methods of
        dispatch-target classes + registered completion callbacks."""
        entries: List[Tuple[str, str]] = []
        names = set(config.ENTRY_CLASS_NAMES) | set(
            self.detected_entry_classes)
        for module, classes in self.classes.items():
            for cls, methods in classes.items():
                if cls not in names:
                    continue
                for meth, qual in methods.items():
                    if meth.startswith("_"):
                        continue  # MethodDispatcher refuses these remotely
                    entries.append((qual, f"RPC dispatch method {cls}.{meth}"))
        for desc, line in self.callback_entries:
            if desc[0] == "resolved":
                qual: Optional[str] = desc[1]
            elif desc[0] == "self":
                qual = self.classes.get(desc[1], {}).get(
                    desc[2], {}).get(desc[3])
            else:  # ("module", module, name)
                qual = self.module_funcs.get(desc[1], {}).get(desc[2])
            if qual and qual in self.functions:
                entries.append(
                    (qual, f"completion callback registered at line {line} "
                           "(runs on the RPC read loop / completing thread)"))
        return entries


# ---- blocking-call heuristics ------------------------------------------------

def _recv_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _is_str_join(call: ast.Call, recv: ast.AST) -> bool:
    """True when a ``.join(...)`` is a string/path join, not a thread join."""
    if isinstance(recv, ast.Constant) and isinstance(recv.value, str):
        return True
    rname = _recv_name(recv) or ""
    if rname in ("path", "pathsep", "sep", "linesep"):
        return True
    if any(kw.arg == "timeout" for kw in call.keywords):
        return False
    if len(call.args) == 1 and not call.keywords:
        a = call.args[0]
        if isinstance(a, ast.Constant) and isinstance(a.value, (int, float)):
            return False  # t.join(5.0)
        return True  # sep.join(iterable)
    return False


def _is_store_get(recv: ast.AST) -> bool:
    rname = _recv_name(recv)
    if rname is None:
        if isinstance(recv, ast.Call):
            return _recv_name(recv.func) == "get_client"
        return False
    low = rname.lower().lstrip("_")
    return (low in config.STORE_GET_RECEIVERS
            or rname.endswith(config.STORE_GET_SUFFIXES))


def classify_blocking(call: ast.Call) -> Optional[Tuple[str, str]]:
    """(kind, detail) when this call is a blocking primitive, else None."""
    f = call.func
    if isinstance(f, ast.Name):
        if f.id == "sleep":
            return ("sleep", "sleep()")
        if f.id == "wait":
            return ("wait", "wait(...) on futures")
        return None
    if not isinstance(f, ast.Attribute):
        return None
    a = f.attr
    if a == "sleep":
        return ("sleep", "time.sleep")
    if a == "result":
        return ("result", "Future.result() — may wait on work needing this "
                          "dispatcher pool")
    if a == "call":
        return ("rpc-call", "synchronous RpcClient.call round trip")
    if a == "wait":
        return ("wait", "event/condition wait")
    if a == "join":
        if _is_str_join(call, f.value):
            return None
        return ("join", "thread join")
    if a == "get":
        if _is_store_get(f.value):
            return ("store-get", "blocking store/queue get")
        return None
    return None


# ---- the indexing pass -------------------------------------------------------

class _Indexer(ast.NodeVisitor):
    def __init__(self, graph: CallGraph, src: SourceFile, module: str):
        self.g = graph
        self.src = src
        self.module = module
        self.class_stack: List[str] = []
        self.fn_stack: List[FunctionInfo] = []
        self.g.module_funcs.setdefault(module, {})
        self.g.classes.setdefault(module, {})
        self.g.mod_imports.setdefault(module, {})
        self.g.func_imports.setdefault(module, {})

    # imports ---------------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.g.mod_imports[self.module][
                alias.asname or alias.name.split(".")[0]] = alias.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level or not node.module:
            return  # relative imports: out of scope for this pass
        for alias in node.names:
            local = alias.asname or alias.name
            full = f"{node.module}.{alias.name}"
            # could be a submodule (from raydp_tpu_torch.etl import tasks) or a
            # function (from x import run_task_body); record as both and let
            # resolution pick whichever exists
            self.g.mod_imports[self.module][local] = full
            self.g.func_imports[self.module][local] = full

    # definitions -----------------------------------------------------------
    def _qualname(self, name: str) -> str:
        if self.fn_stack:
            return f"{self.fn_stack[-1].qualname}.<locals>.{name}"
        if self.class_stack:
            return f"{self.module}.{'.'.join(self.class_stack)}.{name}"
        return f"{self.module}.{name}"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if not self.fn_stack:
            self.class_stack.append(node.name)
            self.g.classes[self.module].setdefault(node.name, {})
            self._collect_attr_types(node)
            self.generic_visit(node)
            self.class_stack.pop()
        # classes defined inside functions: skip their internals

    def _collect_attr_types(self, cls: ast.ClassDef) -> None:
        """What class each ``self.X`` holds, when __init__ makes it obvious:
        ``self.x = SomeClass(...)`` or ``self.x = param`` with ``param``
        annotated (``job: "SPMDJob"``)."""
        init = next((n for n in cls.body
                     if isinstance(n, ast.FunctionDef)
                     and n.name == "__init__"), None)
        if init is None:
            return
        ann: Dict[str, str] = {}
        for arg in init.args.args + init.args.kwonlyargs:
            a = arg.annotation
            name = None
            if isinstance(a, ast.Name):
                name = a.id
            elif isinstance(a, ast.Constant) and isinstance(a.value, str):
                name = a.value.split("[")[0].split(".")[-1].strip('"\' ')
            if name:
                ann[arg.arg] = name
        types: Dict[str, str] = {}
        for node in ast.walk(init):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            attr = None
            t = node.targets[0]
            if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)\
                    and t.value.id == "self":
                attr = t.attr
            if attr is None:
                continue
            v = node.value
            if isinstance(v, ast.Call) and isinstance(v.func, ast.Name):
                types[attr] = v.func.id
            elif isinstance(v, ast.Name) and v.id in ann:
                types[attr] = ann[v.id]
        if types:
            self.g.attr_types[(self.module, cls.name)] = types

    def _visit_function(self, node, name: str) -> None:
        qual = self._qualname(name)
        info = FunctionInfo(
            qualname=qual, name=name, module=self.module,
            class_name=self.class_stack[-1] if self.class_stack else None,
            rel=self.src.rel, line=node.lineno)
        self.g.functions[qual] = info
        if self.fn_stack:
            self.fn_stack[-1].locals_defs[name] = qual
        elif self.class_stack:
            self.g.classes[self.module][self.class_stack[-1]][name] = qual
        else:
            self.g.module_funcs[self.module][name] = qual
        self.fn_stack.append(info)
        self.generic_visit(node)
        self.fn_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_function(node, node.name)

    def visit_AsyncFunctionDef(self, node) -> None:
        self._visit_function(node, node.name)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._visit_function(node, f"<lambda:{node.lineno}>")

    # calls -----------------------------------------------------------------
    def _call_ref(self, call: ast.Call) -> Optional[CallRef]:
        f = call.func
        if isinstance(f, ast.Name):
            for fn in reversed(self.fn_stack):
                if f.id in fn.locals_defs:
                    return ("local", fn.locals_defs[f.id])
            return ("module", f.id)
        if isinstance(f, ast.Attribute):
            v = f.value
            if isinstance(v, ast.Name):
                if v.id == "self":
                    return ("self", f.attr)
                target = self.g.mod_imports[self.module].get(v.id)
                if target:
                    return ("module_attr", target, f.attr)
            elif isinstance(v, ast.Attribute) \
                    and isinstance(v.value, ast.Name) \
                    and v.value.id == "self":
                return ("self_attr", v.attr, f.attr)
        return None

    def visit_Call(self, node: ast.Call) -> None:
        if self.fn_stack:
            fn = self.fn_stack[-1]
            ref = self._call_ref(node)
            if ref is not None:
                fn.calls.append((ref, node.lineno))
            blk = classify_blocking(node)
            if blk is not None:
                fn.blocking.append(Blocking(node.lineno, blk[0], blk[1]))
        self._detect_entry_patterns(node)
        self.generic_visit(node)

    def _detect_entry_patterns(self, node: ast.Call) -> None:
        fname = _recv_name(node.func) if isinstance(
            node.func, ast.Attribute) else (
            node.func.id if isinstance(node.func, ast.Name) else None)
        # MethodDispatcher(Cls(...)) / RpcServer(Cls(...), ...)
        if fname in ("MethodDispatcher", "RpcServer") and node.args:
            a0 = node.args[0]
            if isinstance(a0, ast.Call) and isinstance(a0.func, ast.Name):
                inner = a0
                if inner.func.id == "MethodDispatcher" and inner.args \
                        and isinstance(inner.args[0], ast.Call) \
                        and isinstance(inner.args[0].func, ast.Name):
                    inner = inner.args[0]
                if inner.func.id != "MethodDispatcher":
                    # dispatch through an intermediate variable the AST pass
                    # cannot follow: config.ENTRY_CLASS_NAMES covers those
                    self.g.detected_entry_classes.append(inner.func.id)
        # fut.add_done_callback(X): X runs on whatever thread completes fut —
        # for RPC client futures that is the connection's READ LOOP
        if fname == "add_done_callback" and node.args:
            cb = node.args[0]
            desc: Optional[Tuple] = None
            if isinstance(cb, ast.Name):
                for fn in reversed(self.fn_stack):
                    if cb.id in fn.locals_defs:
                        desc = ("resolved", fn.locals_defs[cb.id])
                        break
                if desc is None:
                    desc = ("module", self.module, cb.id)
            elif isinstance(cb, ast.Attribute) \
                    and isinstance(cb.value, ast.Name) \
                    and cb.value.id == "self" and self.class_stack:
                desc = ("self", self.module, self.class_stack[-1], cb.attr)
            elif isinstance(cb, ast.Lambda):
                desc = ("resolved", self._qualname(f"<lambda:{cb.lineno}>"))
            if desc:
                self.g.callback_entries.append((desc, node.lineno))


def build(project: Project,
          files: Optional[Sequence[SourceFile]] = None) -> CallGraph:
    graph = CallGraph()
    for src in (files if files is not None else project.files):
        _Indexer(graph, src, src.module_name(project.root)).visit(src.tree)
    return graph
