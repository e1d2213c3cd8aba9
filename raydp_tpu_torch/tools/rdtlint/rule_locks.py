"""Rule ``lock-discipline``: attributes declared ``# guarded-by: <lock>``
must be accessed under that lock.

Convention (the reference's doc/dev_lint.md):

- Declaration — on the attribute's initialization line::

      self._blocks = {}  # guarded-by: _lock

  declares that every read/write of ``self._blocks`` anywhere in the class
  must sit lexically inside ``with self._lock:`` (``__init__`` itself is
  exempt: construction happens-before sharing).

- A method that RUNS with the lock held (the ``*_locked`` helper pattern)
  declares it on its ``def`` line::

      def _resp_locked(self, ...):  # guarded-by: _lock

  making its whole body count as guarded — the callers' ``with`` blocks are
  the enforcement boundary.

Only annotated attributes are checked: adoption is incremental, seeded
across the four concurrency-heavy runtime modules where instance state is
mutated from thread targets, deferred-reply bodies, and late-result
callbacks. The check is lexical (no alias or happens-before analysis);
deliberate lock-free reads carry an ``allow[lock-discipline]`` with the
reason they are safe.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from raydp_tpu_torch.tools.rdtlint.core import Project, SourceFile, Violation

RULE = "lock-discipline"


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _find_guards(src: SourceFile, cls: ast.ClassDef) -> Dict[str, str]:
    """attr -> guard name, from ``self.X = ...  # guarded-by: _lock`` lines
    anywhere in the class body (typically ``__init__``)."""
    guards: Dict[str, str] = {}
    for node in ast.walk(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            # any line of the assignment (a wrapped initializer may carry
            # the comment on a continuation line), or a comment-only line
            # directly above when the statement has no room
            guard = None
            for line in range(node.lineno,
                              (node.end_lineno or node.lineno) + 1):
                guard = src.guarded_by(line)
                if guard:
                    break
            guard = guard or src.guarded_by(node.lineno, allow_above=True)
            if not guard:
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                attr = _self_attr(t)
                if attr:
                    guards[attr] = guard
    return guards


def _enclosing_function(src: SourceFile, node: ast.AST,
                        cls: ast.ClassDef) -> Optional[ast.AST]:
    """The METHOD of ``cls`` lexically containing ``node`` (the outermost
    function between the node and the class body)."""
    method = None
    for anc in src.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            method = anc
        if anc is cls:
            return method
    return None


def _is_guarded(src: SourceFile, node: ast.AST, guard: str,
                cls: ast.ClassDef) -> bool:
    for anc in src.ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                if _self_attr(item.context_expr) == guard:
                    return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # method-level "runs with the lock held" annotation
            if src.guarded_by(anc.lineno) == guard:
                return True
        if anc is cls:
            return False
    return False


def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    for src in project.files:
        for cls in [n for n in ast.walk(src.tree)
                    if isinstance(n, ast.ClassDef)]:
            guards = _find_guards(src, cls)
            if not guards:
                continue
            for node in ast.walk(cls):
                attr = _self_attr(node)
                if attr is None or attr not in guards:
                    continue
                guard = guards[attr]
                method = _enclosing_function(src, node, cls)
                if method is None or method.name == "__init__":
                    continue  # class body / construction happens-before
                if src.guarded_by(node.lineno, allow_above=True) is not None:
                    continue  # the declaration line itself
                if _is_guarded(src, node, guard, cls):
                    continue
                out.append(Violation(
                    rule=RULE, path=src.rel, line=node.lineno,
                    message=(
                        f"self.{attr} ({cls.name}) is declared guarded-by "
                        f"self.{guard} but is accessed in {method.name}() "
                        f"outside `with self.{guard}:`")))
    return out
