"""rdtlint — project-native static analysis for raydp_tpu_torch.

The port's copy of the reference's ``raydp_tpu.tools.rdtlint``, pointed at
the port's package, its docs (``raydp_tpu_torch/doc/``, :data:`config.DOC_DIR`)
and its tests (``tests/test_torch_*.py``). Eight rule families, each encoding
an invariant this repo's reviews kept re-finding by hand (the reference's
``doc/dev_lint.md`` is the full reference and gives the annotation
conventions):

- ``dispatcher-blocking`` — blocking primitives must not be reachable from
  RPC dispatcher entry points ("waits never park head dispatchers").
- ``lock-discipline`` — ``# guarded-by: _lock`` attributes are accessed
  under their lock.
- ``knob-registry`` — every ``RDT_*`` knob is declared in
  ``raydp_tpu_torch/knobs.py``, read through it (never cached at import
  time when per-action), and the doc tables are generated from it.
- ``fault-site-sync`` — fault-injection sites agree across code,
  ``faults.KNOWN_SITES``, ``raydp_tpu_torch/doc/fault_tolerance.md``,
  and test specs.
- ``rpc-surface`` — every literal ``*.call("name", ...)`` resolves to a
  real remote method with compatible arity, no underscore targets, the
  head's store proxies are complete, and the generated RPC table is fresh.
- ``step-registry`` — every ref-carrying ``Step`` class (declared via
  ``# carries-refs:``) is registered with the lineage-recovery and stream
  planes; result-ref keys stay in sync with ``engine._result_refs``.
- ``exc-contract`` — every ``RemoteError.exc_type`` string comparison names
  a real exception class (repo, builtin, or allowlisted external).
- ``telemetry-registry`` — every literal ``profiler.trace(...)`` or
  ``profiler.timed(...)`` span name, ``metrics.*`` metric name (with the right kind), and flight-recorder
  event kind is declared in ``raydp_tpu_torch/metrics.py``, and the generated
  tables in raydp_tpu_torch/doc/observability.md are fresh.

Run it::

    python -m raydp_tpu_torch.tools.rdtlint raydp_tpu_torch --root .

Exit code 0 = no unsuppressed violations. Deliberate exceptions carry an
inline ``# rdtlint: allow[<rule>] <reason>`` (the reason is mandatory).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from raydp_tpu_torch.tools.rdtlint import (
    rule_dispatcher, rule_exc, rule_faults, rule_knobs, rule_locks,
    rule_rpc, rule_steps, rule_telemetry)
from raydp_tpu_torch.tools.rdtlint.core import (
    RULES, Project, Report, Violation, apply_suppressions)

_RULE_CHECKS = {
    "dispatcher-blocking": rule_dispatcher.check,
    "lock-discipline": rule_locks.check,
    "knob-registry": rule_knobs.check,
    "fault-site-sync": rule_faults.check,
    "rpc-surface": rule_rpc.check,
    "step-registry": rule_steps.check,
    "exc-contract": rule_exc.check,
    "telemetry-registry": rule_telemetry.check,
}


def run(paths: Iterable[str], root: Optional[str] = None,
        rules: Optional[Iterable[str]] = None) -> Report:
    """Lint ``paths`` and return the :class:`Report` (violations carry their
    suppression state; callers gate on ``report.unsuppressed``)."""
    project = Project.load(list(paths), root=root)
    violations: List[Violation] = list(project.errors)
    for name in (rules if rules is not None else RULES):
        violations.extend(_RULE_CHECKS[name](project))
    # rule 4 scans tests lazily; load order guarantees their
    # suppressions are visible here
    apply_suppressions(project, violations)
    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return Report(violations, files_linted=len(project.files))


__all__ = ["run", "Report", "Violation", "Project", "RULES"]
