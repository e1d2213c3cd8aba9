"""Rule ``step-registry``: every ref-carrying task step is registered with
the lineage-recovery plane.

The bug class this encodes re-surfaced four times: a new ``Step``
subclass carries ``ObjectRef``s (or a nested ``Task``, or a streaming
source) and must be hand-registered in the recovery surgery
(``tasks._patch_step_refs`` / ``tasks.task_input_ids``) and — when it
carries a stream — the stream plane (``tasks.stream_sources_of`` /
``tasks.resolve_stream_sources``). Forgetting any of them is a
lineage-recovery hole that stays invisible until a blob dies under exactly
that step ("patch_task_refs learns RangeRefSource / BroadcastJoinStep /
StreamingRangeSource" — each a review-caught re-fix).

The registry is the ``# carries-refs: attr, attr`` annotation on the class
line in ``etl/tasks.py``; the rule keeps it honest in both directions and
then checks the handlers:

1. **declaration sync** — a ``Step`` subclass whose dataclass fields are
   typed with ``ObjectRef`` / ``Task`` / the streaming source class must
   declare exactly those attributes; an annotation naming anything else (or
   a carrying field left undeclared) is drift.
2. **ref/task attrs** — the class is isinstance-handled in every
   :data:`config.STEP_REF_HANDLERS` function, and each declared attr is
   touched inside one of its branches (attribute access or a
   ``dataclasses.replace(..., attr=...)`` keyword).
3. **stream attrs** (and nested-task attrs) — handled in every
   :data:`config.STEP_STREAM_HANDLERS` function, by isinstance or by a
   ``getattr(step, "<attr>", ...)`` literal.
4. **result-ref keys** — the executor writes ref-valued task results only
   under :data:`config.STEP_RESULT_REF_KEYS`, and ``engine._result_refs``
   harvests every one (the single extraction shared by the lineage ledger,
   regeneration, and frees — a key missing there orphans blobs on every
   failed stage).
5. **stream buckets** — each :data:`config.STEP_STREAM_BUCKET_FUNCS`
   function in ``engine.py`` isinstance-handles ``_StreamBucket`` (the
   pipelined stage's placeholder: locality weighting, reduce-source
   construction, stream-key tagging).

Precision limits: carrier inference reads dataclass field annotations — a
ref hidden in an untyped container (``List[Any]``) is invisible, so keep
ref-bearing fields typed; attr-touch checking is per-isinstance-branch but
does not prove the patch is *correct*, only present.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from raydp_tpu_torch.tools.rdtlint import config
from raydp_tpu_torch.tools.rdtlint.core import Project, SourceFile, Violation

RULE = "step-registry"

_CARRIES_RE = re.compile(r"#\s*carries-refs:\s*([\w,\s]+)")

_REF_WORD = re.compile(r"\bObjectRef\b")
_TASK_WORD = re.compile(r"\bTask\b")


@dataclass
class StepClass:
    name: str
    line: int
    ref_attrs: Set[str] = field(default_factory=set)      # ObjectRef-typed
    task_attrs: Set[str] = field(default_factory=set)     # nested Task
    stream_attrs: Set[str] = field(default_factory=set)   # streaming source
    declared: Optional[Set[str]] = None                   # carries-refs attrs
    declared_line: int = 0

    @property
    def inferred(self) -> Set[str]:
        return self.ref_attrs | self.task_attrs | self.stream_attrs


def _annotation_kind(ann: ast.AST) -> Optional[str]:
    try:
        text = ast.unparse(ann)
    except Exception:  # noqa: BLE001 - unparse is best-effort
        return None
    if _REF_WORD.search(text):
        return "ref"
    if re.search(rf"\b{config.STEP_STREAM_SOURCE_CLASS}\b", text):
        return "stream"
    if _TASK_WORD.search(text):
        return "task"
    return None


def _declared_attrs(src: SourceFile, cls: ast.ClassDef
                    ) -> Tuple[Optional[Set[str]], int]:
    """The ``# carries-refs:`` annotation on the class line, or a
    comment-only line directly above the first decorator/class line."""
    first = min([cls.lineno] + [d.lineno for d in cls.decorator_list])
    for cand in (cls.lineno, first - 1):
        c = src.comments.get(cand)
        if not c or (cand != cls.lineno and not src.comment_only_line(cand)):
            continue
        m = _CARRIES_RE.search(c)
        if m:
            attrs = {a.strip() for a in m.group(1).split(",") if a.strip()}
            return attrs, cand
    return None, 0


def _step_classes(src: SourceFile) -> Dict[str, StepClass]:
    """Every subclass of ``Step`` in the tasks file (transitive within the
    file), with carrier attrs inferred from field annotations."""
    classes: Dict[str, ast.ClassDef] = {
        n.name: n for n in src.tree.body if isinstance(n, ast.ClassDef)}
    bases: Dict[str, List[str]] = {
        name: [b.id for b in node.bases if isinstance(b, ast.Name)]
        for name, node in classes.items()}

    def is_step(name: str, seen=()) -> bool:
        if name == "Step":
            return True
        if name in seen or name not in bases:
            return False
        return any(is_step(b, seen + (name,)) for b in bases[name])

    out: Dict[str, StepClass] = {}
    for name, node in classes.items():
        if name == "Step" or not is_step(name):
            continue
        sc = StepClass(name=name, line=node.lineno)
        for item in node.body:
            if isinstance(item, ast.AnnAssign) \
                    and isinstance(item.target, ast.Name):
                kind = _annotation_kind(item.annotation)
                if kind == "ref":
                    sc.ref_attrs.add(item.target.id)
                elif kind == "task":
                    sc.task_attrs.add(item.target.id)
                elif kind == "stream":
                    sc.stream_attrs.add(item.target.id)
        sc.declared, sc.declared_line = _declared_attrs(src, node)
        out[name] = sc
    return out


def _isinstance_branches(fn: ast.FunctionDef
                         ) -> List[Tuple[Set[str], Set[str]]]:
    """(class names, touched attrs) per ``isinstance`` branch: attrs are
    attribute accesses plus call keywords (``dataclasses.replace(step,
    right_parts=...)``) in the branch body."""
    out: List[Tuple[Set[str], Set[str]]] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        names: Set[str] = set()
        for sub in ast.walk(node.test):
            if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)\
                    and sub.func.id == "isinstance" and len(sub.args) == 2:
                t = sub.args[1]
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                names |= {e.id for e in elts if isinstance(e, ast.Name)}
        if not names:
            continue
        attrs: Set[str] = set()
        for sub in node.body:
            for n in ast.walk(sub):
                if isinstance(n, ast.Attribute):
                    attrs.add(n.attr)
                elif isinstance(n, ast.Call):
                    attrs |= {kw.arg for kw in n.keywords if kw.arg}
        out.append((names, attrs))
    return out


def _getattr_literals(fn: ast.FunctionDef) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "getattr" and len(node.args) >= 2 \
                and isinstance(node.args[1], ast.Constant) \
                and isinstance(node.args[1].value, str):
            out.add(node.args[1].value)
    return out


def _module_functions(src: SourceFile) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in src.tree.body
            if isinstance(n, ast.FunctionDef)}


def _class_functions(src: SourceFile) -> Dict[str, ast.FunctionDef]:
    out: Dict[str, ast.FunctionDef] = {}
    for node in src.tree.body:
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    out.setdefault(item.name, item)
    return out


def _check_handler(sc: StepClass, attrs: Set[str], fn_name: str,
                   fn: Optional[ast.FunctionDef], tasks_rel: str,
                   allow_getattr: bool, out: List[Violation]) -> None:
    if fn is None:
        return  # absence of the handler itself is reported once, not per class
    branches = _isinstance_branches(fn)
    mine = [(names, touched) for names, touched in branches
            if sc.name in names]
    if not mine:
        if allow_getattr and attrs:
            gets = _getattr_literals(fn)
            if all(a in gets for a in attrs):
                return  # duck-typed handling (getattr on every stream attr)
        out.append(Violation(
            rule=RULE, path=tasks_rel, line=sc.line,
            message=(f"step class {sc.name} carries refs "
                     f"({', '.join(sorted(attrs))}) but is not handled in "
                     f"{fn_name}() — a lost blob under this step cannot be "
                     "recovered (the BroadcastJoinStep regression "
                     "shape)")))
        return
    touched = set().union(*(t for _, t in mine))
    for a in sorted(attrs - touched):
        out.append(Violation(
            rule=RULE, path=tasks_rel, line=sc.line,
            message=(f"{fn_name}() handles {sc.name} but never touches its "
                     f"declared carrier attribute {a!r} — the registry says "
                     "this attr carries refs; patch it or fix the "
                     "declaration")))


def _check_result_keys(engine_src: SourceFile, exec_src: SourceFile,
                       out: List[Violation]) -> None:
    keys = config.STEP_RESULT_REF_KEYS
    fns = _module_functions(engine_src)
    fns.update(_class_functions(engine_src))
    rref = fns.get("_result_refs")
    if rref is not None:
        read = {n.value for n in ast.walk(rref)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)}
        for k in keys:
            if k not in read:
                out.append(Violation(
                    rule=RULE, path=engine_src.rel, line=rref.lineno,
                    message=(f"engine._result_refs() never reads result key "
                             f"{k!r} — outputs under it escape the lineage "
                             "ledger, regeneration, AND the failed-stage "
                             "free (orphan leak)")))
    else:
        out.append(Violation(
            rule=RULE, path=engine_src.rel, line=1,
            message=("engine.py defines no _result_refs() — the single "
                     "output-ref extraction the ledger/regenerate/free "
                     "plane shares is gone")))

    run_fn = _class_functions(exec_src).get("_run_task_obj")
    if run_fn is None:
        return
    refish: Dict[str, int] = {}
    for node in ast.walk(run_fn):
        pairs: List[Tuple[ast.AST, ast.AST, int]] = []
        if isinstance(node, ast.Dict):
            pairs = [(k, v, node.lineno)
                     for k, v in zip(node.keys, node.values)
                     if k is not None]
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Subscript):
            pairs = [(node.targets[0].slice, node.value, node.lineno)]
        for k, v, line in pairs:
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)):
                continue
            if _value_is_refish(v):
                refish.setdefault(k.value, line)
    for k, line in sorted(refish.items()):
        if k not in keys:
            out.append(Violation(
                rule=RULE, path=exec_src.rel, line=line,
                message=(f"executor task result carries refs under key "
                         f"{k!r}, which is not in the registered "
                         f"result-ref keys {tuple(keys)} — "
                         "engine._result_refs() will never free or "
                         "re-ledger it (register the key in "
                         "rdtlint/config.py AND read it there)")))


def _value_is_refish(v: ast.AST) -> bool:
    """Does a result-value expression smell like store refs? Names/attrs
    called ``ref``/``refs`` (or ``*_ref``/``*_refs``) and direct put calls."""
    for node in ast.walk(v):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name and (name in ("ref", "refs") or name.endswith("_ref")
                     or name.endswith("_refs")
                     or name in ("put_arrow", "put_raw", "put",
                                 "put_arrow_many", "put_raw_many")):
            return True
    return False


def _check_stream_buckets(engine_src: SourceFile,
                          out: List[Violation]) -> None:
    fns = _module_functions(engine_src)
    fns.update(_class_functions(engine_src))
    for fn_name in config.STEP_STREAM_BUCKET_FUNCS:
        fn = fns.get(fn_name)
        if fn is None:
            out.append(Violation(
                rule=RULE, path=engine_src.rel, line=1,
                message=(f"engine.py defines no {fn_name}() — the "
                         "_StreamBucket handling registry in "
                         "rdtlint/config.py is stale")))
            continue
        handles = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
            and n.func.id == "isinstance" and len(n.args) == 2
            and any(isinstance(e, ast.Name) and e.id == "_StreamBucket"
                    for e in (n.args[1].elts
                              if isinstance(n.args[1], ast.Tuple)
                              else [n.args[1]]))
            for n in ast.walk(fn))
        if not handles:
            out.append(Violation(
                rule=RULE, path=engine_src.rel, line=fn.lineno,
                message=(f"{fn_name}() no longer isinstance-handles "
                         "_StreamBucket — a pipelined stage's bucket "
                         "placeholder would fall through the plain-ref "
                         "path (wrong locality / broken reduce source)")))


def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    tasks_src = project.find_file("etl/tasks.py") \
        or project.find_file("tasks.py")
    if tasks_src is None:
        return out

    steps = _step_classes(tasks_src)
    fns = _module_functions(tasks_src)

    # declaration sync (both directions)
    for sc in steps.values():
        if sc.name == config.STEP_STREAM_SOURCE_CLASS:
            continue  # the stream source itself carries no ref fields
        if sc.inferred and sc.declared is None:
            out.append(Violation(
                rule=RULE, path=tasks_src.rel, line=sc.line,
                message=(f"step class {sc.name} has ref-carrying fields "
                         f"({', '.join(sorted(sc.inferred))}) but no "
                         "`# carries-refs:` declaration on its class line "
                         "— declare them so the recovery-handler checks "
                         "cover this class")))
            continue
        if sc.declared is None:
            continue
        missing = sc.inferred - sc.declared
        extra = sc.declared - sc.inferred
        for a in sorted(missing):
            out.append(Violation(
                rule=RULE, path=tasks_src.rel, line=sc.declared_line,
                message=(f"{sc.name}: field {a!r} is typed as a carrier "
                         "but missing from its # carries-refs: "
                         "declaration")))
        for a in sorted(extra):
            out.append(Violation(
                rule=RULE, path=tasks_src.rel, line=sc.declared_line,
                message=(f"{sc.name}: # carries-refs: names {a!r} but no "
                         "field of that name carries ObjectRef/Task/"
                         "stream types — stale declaration")))

    # handler registration for declared carriers
    for fn_name in config.STEP_REF_HANDLERS:
        if fn_name not in fns:
            out.append(Violation(
                rule=RULE, path=tasks_src.rel, line=1,
                message=(f"tasks.py defines no {fn_name}() — the lineage "
                         "ref-surgery registry is gone")))
    for fn_name in config.STEP_STREAM_HANDLERS:
        if fn_name not in fns:
            out.append(Violation(
                rule=RULE, path=tasks_src.rel, line=1,
                message=(f"tasks.py defines no {fn_name}() — the stream "
                         "routing/resolution registry is gone")))
    for sc in steps.values():
        declared = sc.declared if sc.declared is not None else set()
        ref_like = (declared & (sc.ref_attrs | sc.task_attrs))
        stream_like = (declared & sc.stream_attrs) | sc.task_attrs & declared
        if ref_like:
            for fn_name in config.STEP_REF_HANDLERS:
                _check_handler(sc, ref_like, fn_name, fns.get(fn_name),
                               tasks_src.rel, allow_getattr=False, out=out)
        if stream_like:
            for fn_name in config.STEP_STREAM_HANDLERS:
                _check_handler(sc, stream_like, fn_name, fns.get(fn_name),
                               tasks_src.rel, allow_getattr=True, out=out)

    # the stream source class itself must be routed and resolvable
    if config.STEP_STREAM_SOURCE_CLASS in steps:
        ssc = steps[config.STEP_STREAM_SOURCE_CLASS]
        for fn_name in config.STEP_STREAM_HANDLERS:
            fn = fns.get(fn_name)
            if fn is None:
                continue
            handled = any(ssc.name in names
                          for names, _ in _isinstance_branches(fn))
            if not handled:
                out.append(Violation(
                    rule=RULE, path=tasks_src.rel, line=ssc.line,
                    message=(f"{fn_name}() does not isinstance-handle "
                             f"{ssc.name} — streamed reads would not be "
                             "routed onto stream threads / resolved into "
                             "concrete ranges for recipes")))

    # engine/executor side (skipped on targeted runs without those files)
    engine_src = project.find_file("etl/engine.py") \
        or project.find_file("engine.py")
    exec_src = project.find_file("etl/executor.py") \
        or project.find_file("executor.py")
    if engine_src is not None and exec_src is not None:
        _check_result_keys(engine_src, exec_src, out)
    if engine_src is not None and any(
            isinstance(n, ast.ClassDef) and n.name == "_StreamBucket"
            for n in engine_src.tree.body):
        _check_stream_buckets(engine_src, out)
    return out
