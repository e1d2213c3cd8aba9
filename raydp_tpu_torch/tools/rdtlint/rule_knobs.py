"""Rule ``knob-registry``: every ``RDT_*`` environment knob is declared in
``raydp_tpu_torch/knobs.py``, read through it, and documented from it.

Four checks:

1. **No scattered reads** — a direct ``os.environ`` / ``os.getenv`` read of
   an ``RDT_*`` name outside ``knobs.py`` is a violation (reads through
   module-level string constants are resolved). Env *writes* are fine: the
   head/agents inject framework knobs into child environments by design.
2. **No unregistered names** — ``knobs.get("RDT_X")`` (and ``get_raw`` /
   ``require``) with a name missing from the registry.
3. **No import-time caching of per-action knobs** — a per-action knob read
   at module scope, class scope, or in a function default is pinned to
   whatever the process first saw; this is the ``RDT_FAULTS`` re-arm bug
   class. (Process-start knobs MAY be read at import.) Registered knobs
   that no package code references at all are flagged too (registry drift).
4. **Docs are generated** — the knob tables under
   ``raydp_tpu_torch/doc/`` (the registry's ``DOC_TABLES``) must equal its
   rendered output (``python -m raydp_tpu_torch.knobs --write-docs``
   regenerates).
"""

from __future__ import annotations

import ast
import importlib.util
import os
from typing import Dict, List, Optional, Set, Tuple

from raydp_tpu_torch.tools.rdtlint import config
from raydp_tpu_torch.tools.rdtlint.core import (
    Project, SourceFile, Violation, marker_block_violation)

RULE = "knob-registry"

_KNOB_FUNCS = ("get", "get_raw", "require")


def _load_registry(path: str):
    """Load knobs.py standalone (it is stdlib-only by contract) without
    importing the raydp_tpu_torch runtime."""
    import sys

    spec = importlib.util.spec_from_file_location("_rdtlint_knobs", path)
    mod = importlib.util.module_from_spec(spec)
    # dataclass decorators resolve the defining module through sys.modules
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)  # type: ignore[union-attr]
    finally:
        sys.modules.pop(spec.name, None)
    return mod


def _module_constants(src: SourceFile) -> Dict[str, str]:
    """NAME -> literal for module/class-level ``NAME = "RDT_..."``."""
    consts: Dict[str, str] = {}
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            consts[node.targets[0].id] = node.value.value
    return consts


def _is_environ(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return node.id == "environ"
    return (isinstance(node, ast.Attribute) and node.attr == "environ"
            and isinstance(node.value, ast.Name) and node.value.id == "os")


def _env_read_key(node: ast.AST) -> Optional[ast.AST]:
    """The key expression when ``node`` READS the environment."""
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in ("get", "setdefault") \
                and _is_environ(f.value) and node.args:
            return node.args[0]
        if isinstance(f, ast.Attribute) and f.attr == "getenv" \
                and isinstance(f.value, ast.Name) and f.value.id == "os" \
                and node.args:
            return node.args[0]
        if isinstance(f, ast.Name) and f.id == "getenv" and node.args:
            return node.args[0]
    if isinstance(node, ast.Subscript) and _is_environ(node.value) \
            and isinstance(node.ctx, ast.Load):
        return node.slice
    return None


def _resolve_key(key: ast.AST, consts: Dict[str, str]) -> Optional[str]:
    if isinstance(key, ast.Constant) and isinstance(key.value, str):
        return key.value
    if isinstance(key, ast.Name):
        return consts.get(key.id)
    return None


def _default_nodes(src: SourceFile) -> Set[int]:
    """ids of AST nodes inside function-default expressions (evaluated at
    def time, i.e. import time for top-level functions)."""
    out: Set[int] = set()
    for node in ast.walk(src.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in list(node.args.defaults) + \
                    [d for d in node.args.kw_defaults if d is not None]:
                for sub in ast.walk(d):
                    out.add(id(sub))
    return out


def _is_import_time(src: SourceFile, node: ast.AST,
                    defaults: Set[int]) -> bool:
    funcs = [a for a in src.ancestors(node)
             if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda))]
    if not funcs:
        return True  # module or class scope
    # inside a default of the outermost enclosing function, and that
    # function is itself defined at import time
    return id(node) in defaults and len(funcs) == 1


def _knob_aliases(src: SourceFile) -> Set[str]:
    """Local names bound to the knobs module in this file."""
    aliases: Set[str] = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith("knobs") or a.name == "knobs":
                    aliases.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if a.name == "knobs":
                    aliases.add(a.asname or a.name)
    return aliases


def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    knobs_src = project.find_file("knobs.py")
    registry = None
    registry_mod = None
    if knobs_src is not None:
        try:
            registry_mod = _load_registry(knobs_src.path)
            registry = registry_mod.KNOBS
        except Exception as e:  # noqa: BLE001 - a broken registry IS a finding
            out.append(Violation(
                rule=RULE, path=knobs_src.rel, line=1,
                message=f"could not load knob registry: {e!r}"))

    referenced: Set[str] = set()
    for src in project.files:
        if knobs_src is not None and src.path == knobs_src.path:
            continue
        consts = _module_constants(src)
        defaults = _default_nodes(src)
        aliases = _knob_aliases(src)
        for node in ast.walk(src.tree):
            # ---- direct environment reads -------------------------------
            key = _env_read_key(node)
            if key is not None:
                name = _resolve_key(key, consts)
                if name and name.startswith("RDT_"):
                    referenced.add(name)
                    out.append(Violation(
                        rule=RULE, path=src.rel, line=node.lineno,
                        message=(
                            f"direct environment read of {name} — go "
                            "through raydp_tpu_torch.knobs (get/require) so "
                            "the registry stays the single source of "
                            "truth")))
                continue
            # ---- knobs API calls ----------------------------------------
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _KNOB_FUNCS \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id in aliases and node.args:
                name = _resolve_key(node.args[0], consts)
                if name is None:
                    continue
                referenced.add(name)
                if registry is not None and name not in registry:
                    out.append(Violation(
                        rule=RULE, path=src.rel, line=node.lineno,
                        message=(f"knobs.{node.func.attr}({name!r}): not "
                                 "declared in raydp_tpu_torch/knobs.py")))
                elif registry is not None \
                        and registry[name].scope == "per-action" \
                        and _is_import_time(src, node, defaults):
                    out.append(Violation(
                        rule=RULE, path=src.rel, line=node.lineno,
                        message=(
                            f"{name} is a per-action knob but is read at "
                            "import time — the value pins to whatever this "
                            "process first saw (the RDT_FAULTS re-arm bug "
                            "class); read it inside the function that uses "
                            "it")))
            # ---- plain string references (for the drift check) ----------
            elif isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and node.value.startswith("RDT_"):
                parent = src.parent(node)
                if not isinstance(parent, ast.Expr):  # skip docstrings
                    referenced.add(node.value)

    # ---- registry drift: declared but never referenced by package code ---
    if registry is not None and knobs_src is not None \
            and any(f.path != knobs_src.path for f in project.files):
        for name in registry:
            if name not in referenced:
                out.append(Violation(
                    rule=RULE, path=knobs_src.rel, line=1,
                    message=(f"{name} is declared in the registry but no "
                             "linted code references it — dead knob or "
                             "missed migration")))

    # ---- generated doc tables -------------------------------------------
    if registry_mod is not None and os.path.isdir(
            os.path.join(project.root, config.DOC_DIR)):
        for rel, category in registry_mod.DOC_TABLES:
            path = os.path.join(project.root, rel)
            if not os.path.exists(path):
                out.append(Violation(
                    rule=RULE, path=rel, line=1,
                    message="knob-table doc file missing"))
                continue
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
            begin, end = registry_mod.table_markers(category)
            v = marker_block_violation(
                RULE, rel, text, begin, end,
                registry_mod.render_block(category), "knob",
                "python -m raydp_tpu_torch.knobs --write-docs")
            if v is not None:
                out.append(v)
    return out
