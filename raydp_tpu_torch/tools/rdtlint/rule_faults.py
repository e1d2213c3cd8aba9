"""Rule ``fault-site-sync``: the fault-injection site namespace cannot
drift between code, parser, docs, and tests.

A fault site exists in four places and they historically drifted by hand:

1. the ``faults.check("<site>", ...)`` / ``faults.apply(rule, "<site>")``
   call sites in the runtime;
2. ``faults.KNOWN_SITES`` — the registry ``parse_spec`` validates an
   ``RDT_FAULTS`` env spec against (a typo'd site used to arm nothing,
   silently);
3. the site table in ``raydp_tpu_torch/doc/fault_tolerance.md``;
4. the ``RDT_FAULTS`` spec strings chaos tests and benches arm.

The rule cross-checks all four: every code site must be registered and
documented, every registered/documented site must exist in code, and every
site a test spec names must be a real injection point (a chaos test aimed at
a renamed site would silently test nothing — the exact failure mode the
fault plane's loud-parse contract exists to prevent).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from raydp_tpu_torch.tools.rdtlint import config
from raydp_tpu_torch.tools.rdtlint.core import Project, SourceFile, Violation

RULE = "fault-site-sync"

_ACTIONS = "crash|delay|raise|drop|connloss"
_SPEC_RE = re.compile(
    rf"(?:^|;)\s*([a-z_][\w.]*)\s*:\s*(?:{_ACTIONS})\b")
_DOC_HEADER = re.compile(r"^\|\s*Site\s*\|", re.IGNORECASE)
_DOC_SITE = re.compile(r"^\|\s*`([\w.]+)`\s*\|")


def _faults_aliases(src: SourceFile) -> Set[str]:
    aliases: Set[str] = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith(".faults") or a.name == "faults":
                    aliases.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if a.name == "faults":
                    aliases.add(a.asname or a.name)
    return aliases


def _code_sites(project: Project) -> Dict[str, Tuple[str, int]]:
    """site -> (rel, line) of one arming call (``faults.check`` first arg /
    ``faults.apply`` second arg, string literals only)."""
    sites: Dict[str, Tuple[str, int]] = {}
    for src in project.files:
        rel = src.rel.replace(os.sep, "/")
        if rel.startswith("tests/"):
            # tests arm via RDT_FAULTS spec strings (checked below), and
            # test_faults deliberately probes synthetic sites — neither is a
            # code arming site, so a combined package+tests lint run must
            # not register them against KNOWN_SITES / the doc table
            continue
        aliases = _faults_aliases(src)
        if not aliases:
            continue
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in aliases):
                continue
            lit: Optional[ast.AST] = None
            if node.func.attr == "check" and node.args:
                lit = node.args[0]
            elif node.func.attr == "apply" and len(node.args) >= 2:
                lit = node.args[1]
            if isinstance(lit, ast.Constant) and isinstance(lit.value, str) \
                    and lit.value:
                sites.setdefault(lit.value, (src.rel, node.lineno))
    return sites


def _known_sites(src: SourceFile) -> Optional[Tuple[Set[str], int]]:
    """The KNOWN_SITES literal declared in faults.py, with its line."""
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "KNOWN_SITES":
            val = node.value
            if isinstance(val, ast.Call) and val.args:  # frozenset((...))
                val = val.args[0]
            if isinstance(val, (ast.Tuple, ast.List, ast.Set)):
                items = {e.value for e in val.elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str)}
                return items, node.lineno
    return None


def _doc_sites(path: str) -> Dict[str, int]:
    """site -> line from the `| Site | Fires at | Actions |` table."""
    sites: Dict[str, int] = {}
    in_table = False
    with open(path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f, start=1):
            if _DOC_HEADER.match(line):
                in_table = True
                continue
            if in_table:
                if not line.startswith("|"):
                    in_table = False
                    continue
                m = _DOC_SITE.match(line)
                if m:
                    sites.setdefault(m.group(1), i)
    return sites


def _spec_strings(src: SourceFile) -> List[Tuple[str, int]]:
    """(text, line) of every string literal in the file that could carry a
    fault spec (f-string constant parts included)."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.append((node.value, node.lineno))
        elif isinstance(node, ast.JoinedStr):
            parts = [v.value for v in node.values
                     if isinstance(v, ast.Constant)
                     and isinstance(v.value, str)]
            if parts:
                out.append(("\x00".join(parts), node.lineno))
    return out


def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    faults_src = project.find_file("faults.py")
    code_sites = _code_sites(project)

    known: Optional[Set[str]] = None
    known_line = 1
    if faults_src is not None:
        found = _known_sites(faults_src)
        if found is None:
            out.append(Violation(
                rule=RULE, path=faults_src.rel, line=1,
                message=("faults.py declares no KNOWN_SITES registry for "
                         "parse_spec to validate env specs against")))
        else:
            known, known_line = found

    if known is not None:
        for site, (rel, line) in sorted(code_sites.items()):
            if site not in known:
                out.append(Violation(
                    rule=RULE, path=rel, line=line,
                    message=(f"fault site {site!r} is armed here but "
                             "missing from faults.KNOWN_SITES — an "
                             "RDT_FAULTS spec naming it would be "
                             "rejected")))
        for site in sorted(known - set(code_sites)):
            if code_sites:  # whole-package runs only
                out.append(Violation(
                    rule=RULE, path=faults_src.rel, line=known_line,
                    message=(f"KNOWN_SITES entry {site!r} has no "
                             "faults.check() call site in the linted "
                             "code — stale registry entry")))

    # ---- doc table --------------------------------------------------------
    doc_rel = f"{config.DOC_DIR}/fault_tolerance.md"
    doc_path = os.path.join(project.root, doc_rel)
    if code_sites and os.path.isdir(
            os.path.join(project.root, config.DOC_DIR)):
        if not os.path.exists(doc_path):
            out.append(Violation(
                rule=RULE, path=doc_rel, line=1,
                message="fault-site doc table file missing"))
        else:
            doc = _doc_sites(doc_path)
            for site, (rel, line) in sorted(code_sites.items()):
                if site not in doc:
                    out.append(Violation(
                        rule=RULE, path=rel, line=line,
                        message=(f"fault site {site!r} is missing from the "
                                 f"site table in {doc_rel}")))
            for site, line in sorted(doc.items()):
                if site not in code_sites:
                    out.append(Violation(
                        rule=RULE, path=doc_rel, line=line,
                        message=(f"documented fault site {site!r} has no "
                                 "faults.check() call site in code")))

    # ---- test / bench specs ----------------------------------------------
    if code_sites:
        valid = set(code_sites) | (known or set())
        for subdir in config.EXTRA_FILE_GLOBS:
            for src in project.extra_files(subdir):
                for text, line in _spec_strings(src):
                    for m in _SPEC_RE.finditer(text):
                        site = m.group(1)
                        if site not in valid:
                            out.append(Violation(
                                rule=RULE, path=src.rel, line=line,
                                message=(
                                    f"RDT_FAULTS spec names site {site!r} "
                                    "which no code arms — this schedule "
                                    "would inject nothing")))
    return out
