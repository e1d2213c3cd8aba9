"""rdtlint plumbing: source loading, comments, suppressions, the project view.

Everything here is a pure AST/text pass — no raydp_tpu_torch runtime import,
no actor spin-up — so the CLI and the tier-1 test stay fast and runnable in any
environment that can parse the sources.
"""

from __future__ import annotations

import ast
import fnmatch
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

from raydp_tpu_torch.tools.rdtlint import config

#: the rule families (raydp_tpu_torch/doc/dev_lint.md)
RULES = (
    "dispatcher-blocking",
    "lock-discipline",
    "knob-registry",
    "fault-site-sync",
    "rpc-surface",
    "step-registry",
    "exc-contract",
    "telemetry-registry",
)

_SUPPRESS_RE = re.compile(
    r"#\s*rdtlint:\s*allow\[([a-z-]+)\]\s*(.*)$")
_GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*(\w+)")


@dataclass
class Violation:
    rule: str
    path: str          # repo-root-relative
    line: int
    message: str
    suppressed: bool = False
    reason: str = ""

    def render(self) -> str:
        tag = f" (suppressed: {self.reason})" if self.suppressed else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{tag}"


class SourceFile:
    """One parsed source file: AST with parent links + per-line comments +
    suppression/annotation lookup."""

    def __init__(self, path: str, rel: str):
        self.path = path
        self.rel = rel
        with open(path, "r", encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=path)
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._rdt_parent = node  # type: ignore[attr-defined]
        #: line -> full comment text (from tokenize, so strings never
        #: masquerade as comments)
        self.comments: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except tokenize.TokenError:
            pass

    # -- annotations ----------------------------------------------------------
    def comment_only_line(self, line: int) -> bool:
        """True when ``line`` holds nothing but a comment — a trailing
        comment on a statement must never annotate the NEXT line."""
        if not (1 <= line <= len(self.lines)):
            return False
        return self.lines[line - 1].lstrip().startswith("#")

    def suppression(self, rule: str, line: int) -> Optional[str]:
        """The reason of an ``# rdtlint: allow[rule] reason`` covering
        ``line`` (same line, or a comment-only line directly above), or
        None. An allow with an empty reason does NOT count — the reason is
        the audit trail."""
        for cand in (line, line - 1):
            c = self.comments.get(cand)
            if not c or (cand != line and not self.comment_only_line(cand)):
                continue
            m = _SUPPRESS_RE.search(c)
            if m and m.group(1) == rule and m.group(2).strip():
                return m.group(2).strip()
        return None

    def guarded_by(self, line: int, allow_above: bool = False
                   ) -> Optional[str]:
        """The guard name of a ``# guarded-by: _lock`` annotation on
        ``line`` (optionally also a comment-only line directly above)."""
        for cand in ((line, line - 1) if allow_above else (line,)):
            c = self.comments.get(cand)
            if not c or (cand != line and not self.comment_only_line(cand)):
                continue
            m = _GUARDED_BY_RE.search(c)
            if m:
                return m.group(1)
        return None

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return getattr(node, "_rdt_parent", None)

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def module_name(self, root: str) -> str:
        rel = os.path.relpath(self.path, root)
        mod = rel[:-3] if rel.endswith(".py") else rel
        parts = mod.replace(os.sep, "/").split("/")
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)


def find_repo_root(start: str) -> str:
    """Walk up from ``start`` to the nearest directory with a pyproject.toml
    (fallback: the starting directory itself)."""
    cur = os.path.abspath(start if os.path.isdir(start)
                          else os.path.dirname(start) or ".")
    while True:
        if os.path.exists(os.path.join(cur, "pyproject.toml")):
            return cur
        nxt = os.path.dirname(cur)
        if nxt == cur:
            return os.path.abspath(start if os.path.isdir(start)
                                   else os.path.dirname(start) or ".")
        cur = nxt


def _iter_py(path: str) -> Iterable[str]:
    if os.path.isfile(path):
        if path.endswith(".py"):
            yield path
        return
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames[:] = [d for d in dirnames
                       if d != "__pycache__" and not d.startswith(".")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


@dataclass
class Project:
    """What one lint run sees: the target files plus repo-level context for
    the cross-checks (docs, test fault specs)."""

    root: str
    files: List[SourceFile] = field(default_factory=list)
    errors: List[Violation] = field(default_factory=list)
    _extra: Dict[str, List[SourceFile]] = field(default_factory=dict)

    @classmethod
    def load(cls, paths: Iterable[str],
             root: Optional[str] = None) -> "Project":
        paths = [os.path.abspath(p) for p in paths]
        for p in paths:
            if not os.path.exists(p):
                # fail LOUDLY: a typo'd CI path must not report a clean tree
                raise FileNotFoundError(f"no such file or directory: {p}")
        root = os.path.abspath(root) if root else find_repo_root(paths[0])
        proj = cls(root=root)
        seen = set()
        for p in paths:
            for f in _iter_py(p):
                f = os.path.abspath(f)
                if f in seen:
                    continue
                seen.add(f)
                rel = os.path.relpath(f, root)
                try:
                    proj.files.append(SourceFile(f, rel))
                except SyntaxError as e:
                    proj.errors.append(Violation(
                        rule="parse", path=rel, line=e.lineno or 1,
                        message=f"syntax error: {e.msg}"))
        return proj

    def extra_files(self, subdir: str) -> List[SourceFile]:
        """Parsed files of a repo subdir (``tests``) for the cross-checks,
        only those matching the subdir's pattern in
        :data:`config.EXTRA_FILE_GLOBS` — cached, empty when the dir is
        absent."""
        if subdir not in self._extra:
            out: List[SourceFile] = []
            base = os.path.join(self.root, subdir)
            pattern = config.EXTRA_FILE_GLOBS[subdir]
            if os.path.isdir(base):
                for f in _iter_py(base):
                    if not fnmatch.fnmatch(os.path.basename(f), pattern):
                        continue
                    try:
                        out.append(SourceFile(
                            f, os.path.relpath(f, self.root)))
                    except SyntaxError:
                        pass
            self._extra[subdir] = out
        return self._extra[subdir]

    def find_file(self, rel_suffix: str) -> Optional[SourceFile]:
        for f in self.files:
            if f.rel.replace(os.sep, "/").endswith(rel_suffix):
                return f
        return None


def apply_suppressions(project: Project,
                       violations: List[Violation]) -> List[Violation]:
    """Mark violations covered by an ``allow[...]`` annotation as
    suppressed (the tool still counts and prints them)."""
    by_rel = {f.rel: f for f in project.files}
    for extra in project._extra.values():
        for f in extra:
            by_rel.setdefault(f.rel, f)
    for v in violations:
        f = by_rel.get(v.path)
        if f is None:
            continue
        reason = f.suppression(v.rule, v.line)
        if reason is not None:
            v.suppressed = True
            v.reason = reason
    return violations


def marker_block_violation(rule: str, rel: str, text: str, begin: str,
                           end: str, expected: str, what: str,
                           regen_cmd: str) -> Optional[Violation]:
    """The one drift check shared by every generated-doc fence (knob tables,
    the RPC-surface table): missing markers or a block differing from
    ``expected`` is a violation pointing at ``regen_cmd``."""
    if begin not in text or end not in text:
        return Violation(
            rule=rule, path=rel, line=1,
            message=f"missing generated {what} table markers ({begin})")
    block = begin + text.split(begin, 1)[1].split(end, 1)[0] + end
    if block != expected:
        line = text[:text.index(begin)].count("\n") + 1
        return Violation(
            rule=rule, path=rel, line=line,
            message=f"generated {what} table is stale — run `{regen_cmd}`")
    return None


@dataclass
class Report:
    violations: List[Violation]
    files_linted: int = 0

    @property
    def unsuppressed(self) -> List[Violation]:
        return [v for v in self.violations if not v.suppressed]

    @property
    def suppressed(self) -> List[Violation]:
        return [v for v in self.violations if v.suppressed]

    def render(self, show_suppressed: bool = False) -> str:
        lines = [v.render() for v in self.unsuppressed]
        if show_suppressed:
            lines += [v.render() for v in self.suppressed]
        lines.append(
            f"rdtlint: {len(self.unsuppressed)} violation(s), "
            f"{len(self.suppressed)} suppressed")
        return "\n".join(lines)
