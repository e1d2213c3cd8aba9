"""Rule ``exc-contract``: every exception-name string in a cross-process
comparison names a real exception class.

Failures cross the RPC boundary as ``RemoteError.exc_type`` — a *string* —
and the retry/recovery plane keys on it: ``"ObjectLostError"`` routes into
lineage recovery, ``_NO_RETRY_EXC_TYPES`` fails fast, the store client's
``"FileNotFoundError"``/``"KeyError"`` duck-typing decides between a
fresh-lookup retry and a typed loss. Rename (or mistype) one of those
classes and nothing breaks loudly: the comparison just stops matching, and
a no-retry application error quietly becomes a retry storm, or a lost blob
burns the whole retry budget before recovery fires.

The rule collects every comparison of the shape::

    err.exc_type == "Name"            getattr(e, "exc_type", None) in (...)
    err.exc_type in _SOME_CONSTANT    type(e).__name__ == "Name"

(module-level str-tuple/set/frozenset constants are resolved, same as the
knob rule's constant resolution) and validates each name against, in order:

1. a class defined in the linted code whose base chain reaches a builtin
   exception (or an ``*Error``/``*Exception``-named base);
2. a builtin exception (checked via the ``builtins`` module — stdlib, no
   runtime import);
3. the external allowlist in ``rdtlint/config.py``
   (:data:`config.EXC_EXTERNAL_ALLOWLIST` — pyarrow kernels today).

Precision limits: comparisons against names the constant resolution cannot
reach (function parameters, cross-module constants) are skipped; a class
defined in NON-linted code must go through the allowlist. The whole rule is
skipped when ``rpc.py`` (RemoteError's home) is outside the run — without
the wire format the contract does not exist.
"""

from __future__ import annotations

import ast
import builtins
from typing import Dict, List, Optional, Set, Tuple

from raydp_tpu_torch.tools.rdtlint import config
from raydp_tpu_torch.tools.rdtlint.core import Project, SourceFile, Violation

RULE = "exc-contract"

_BUILTIN_EXCS = frozenset(
    name for name in dir(builtins)
    if isinstance(getattr(builtins, name), type)
    and issubclass(getattr(builtins, name), BaseException))


def _is_exc_type_expr(node: ast.AST) -> bool:
    """``x.exc_type`` / ``getattr(x, "exc_type", ...)`` /
    ``type(x).__name__``."""
    if isinstance(node, ast.Attribute):
        if node.attr == "exc_type":
            return True
        if node.attr == "__name__" and isinstance(node.value, ast.Call) \
                and isinstance(node.value.func, ast.Name) \
                and node.value.func.id == "type":
            return True
        return False
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id == "getattr" and len(node.args) >= 2:
        k = node.args[1]
        return isinstance(k, ast.Constant) and k.value == "exc_type"
    return False


def _str_constants(src: SourceFile) -> Dict[str, List[Tuple[str, int]]]:
    """NAME -> [(value, line)] for module-level tuple/set/frozenset/list
    constants made of string literals (e.g. ``_NO_RETRY_EXC_TYPES``)."""
    out: Dict[str, List[Tuple[str, int]]] = {}
    for node in src.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        val = node.value
        if isinstance(val, ast.Call) and isinstance(val.func, ast.Name) \
                and val.func.id in ("frozenset", "set", "tuple") and val.args:
            val = val.args[0]
        if isinstance(val, (ast.Tuple, ast.Set, ast.List)):
            items = [(e.value, e.lineno) for e in val.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str)]
            if items and len(items) == len(val.elts):
                out[node.targets[0].id] = items
    return out


def _comparand_names(node: ast.AST,
                     consts: Dict[str, List[Tuple[str, int]]]
                     ) -> List[Tuple[str, int]]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [(node.value, node.lineno)]
    if isinstance(node, (ast.Tuple, ast.Set, ast.List)):
        return [(e.value, e.lineno) for e in node.elts
                if isinstance(e, ast.Constant)
                and isinstance(e.value, str)]
    if isinstance(node, ast.Name):
        return consts.get(node.id, [])
    return []


def _project_exceptions(project: Project) -> Set[str]:
    """Class names defined in the linted files whose base chain looks like
    an exception (reaches a builtin exception, or any base named *Error /
    *Exception — lenient when a base is imported from outside the run)."""
    bases: Dict[str, List[str]] = {}
    for src in project.files:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                names = []
                for b in node.bases:
                    if isinstance(b, ast.Name):
                        names.append(b.id)
                    elif isinstance(b, ast.Attribute):
                        names.append(b.attr)
                bases.setdefault(node.name, names)

    def excish(name: str, seen=()) -> bool:
        if name in _BUILTIN_EXCS:
            return True
        if name in seen:
            return False
        if name.endswith("Error") or name.endswith("Exception") \
                or name == "Warning":
            if name not in bases:
                return True  # imported exception-named base: lenient
        for b in bases.get(name, []):
            if excish(b, seen + (name,)):
                return True
        return False

    return {name for name in bases if excish(name)}


def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    if project.find_file("rpc.py") is None:
        return out  # no RemoteError in scope: the contract is not checkable
    known = _project_exceptions(project)
    allow = config.EXC_EXTERNAL_ALLOWLIST
    for src in project.files:
        consts = _str_constants(src)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Compare):
                continue
            if not _is_exc_type_expr(node.left):
                continue
            for op, comp in zip(node.ops, node.comparators):
                if not isinstance(op, (ast.Eq, ast.NotEq, ast.In,
                                       ast.NotIn)):
                    continue
                for name, line in _comparand_names(comp, consts):
                    if not name or not name[0].isupper():
                        continue  # not an exception-class shape
                    if name in known or name in _BUILTIN_EXCS \
                            or name in allow:
                        continue
                    out.append(Violation(
                        rule=RULE, path=src.rel, line=line,
                        message=(
                            f"exc_type contract names {name!r}, which is "
                            "neither a linted exception class, a builtin, "
                            "nor allowlisted in rdtlint/config.py — a "
                            "renamed exception here silently demotes this "
                            "comparison (e.g. a no-retry error becomes a "
                            "retry storm)")))
    return out
