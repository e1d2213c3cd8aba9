"""Deterministic fault-injection plane.

The test matrix of the reference provokes failures by killing processes ad hoc
(``Executor.crash()``, node removal); that proves recovery *can* happen but not
that a given schedule of failures yields correct results. This module gives the
repo a seeded, declarative injection plane so a chaos test (or a CI leg) can
state *exactly* which call dies, and replay it:

- rules come from the ``RDT_FAULTS`` env spec (inherited by every spawned actor
  / rank process) or the programmatic :func:`inject` API (this process only);
- schedules are deterministic: ``nth=N`` (the Nth matching call in a process),
  ``every=N``, or seeded-PRNG ``p=0.3`` — never wall-clock;
- ``once=<path>`` makes a rule fire at most once across ALL processes (an
  O_EXCL sentinel file), which is what keeps a ``crash`` rule from also killing
  the restarted actor that inherits the same env.

Spec grammar (documented in doc/fault_tolerance.md)::

    RDT_FAULTS = rule (';' rule)*
    rule       = site ':' action (':' key '=' value)*

    sites   : executor.run_task | shuffle.write | shuffle.fetch | store.get
              | store.spill | rpc.call | estimator.epoch | serve.predict
              | pool.drain | pool.scale | stream.epoch
              (env specs must name a KNOWN_SITES entry)
    actions : crash | delay | raise | drop | connloss   (interpreted by the site)
    keys    : nth= every= p= times= seed= match= once= ms= ms_per_mb= bucket=

Example — crash the executor on its 3rd task, exactly once in the session::

    RDT_FAULTS="executor.run_task:crash:nth=3:once=/tmp/crash.sentinel"

The ``executor.run_task`` key is ``"<executor name>|<task id>"``, so
``match=`` can pin a rule to ONE executor — the seeded-straggler schedule
the speculation bench uses (delay every task entering a single executor)::

    RDT_FAULTS="executor.run_task:delay:ms=1500:match=rdt-executor-app-0|"

This module must stay importable everywhere (actor bootstrap, rank workers,
the RPC client): stdlib only, no raydp_tpu_torch imports.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

ENV_FAULTS = "RDT_FAULTS"
ENV_SEED = "RDT_FAULTS_SEED"

#: every action any site interprets; parse_spec rejects anything else so a
#: typo'd action fails loudly instead of firing (claiming its once-sentinel)
#: while injecting nothing
KNOWN_ACTIONS = frozenset(("crash", "delay", "raise", "drop", "connloss"))

#: every site the runtime actually arms (the ``faults.check(...)`` call
#: sites). parse_spec rejects env-spec sites outside this registry — a chaos
#: schedule aimed at a renamed/typo'd site used to arm nothing, silently.
#: The programmatic :func:`inject` stays permissive: unit tests arm synthetic
#: sites (``unit.site``) to test the plane itself. Kept in sync with code,
#: doc/fault_tolerance.md's site table, and test specs by rdtlint's
#: ``fault-site-sync`` rule.
KNOWN_SITES = frozenset((
    "executor.run_task",
    "shuffle.write",
    "shuffle.fetch",
    "store.get",
    "store.spill",
    "rpc.call",
    "estimator.epoch",
    "serve.predict",
    "pool.drain",
    "pool.scale",
    "pool.fork",
    "store.budget",
    "stream.epoch",
))

#: the site-specific actions and the only call sites that interpret them —
#: crash/delay/raise are generic (any site routes them through apply());
#: a drop armed at rpc.call would claim its sentinel and inject nothing,
#: the same silent-no-op the action-name check exists to prevent
SITE_SPECIFIC_ACTIONS = {
    "drop": ("shuffle.write", "store.get", "shuffle.fetch", "store.spill",
             "stream.epoch"),
    "connloss": ("rpc.call",),
}

#: exit code of an injected crash — same code the ad-hoc ``Executor.crash()``
#: used, so supervisors/tests keyed on it keep working
CRASH_EXIT_CODE = 23

#: flight-recorder hook: ``cb(site, key, action)`` called for every fired
#: rule. This module is stdlib-only by contract, so it cannot import the
#: telemetry plane — ``raydp_tpu_torch/profiler.py`` arms the hook at ITS import
#: (any process running runtime code), and bootstrap-only processes simply
#: record nothing. Failures in the hook never mask the injected fault.
_fire_hook = None


def set_fire_hook(cb) -> None:
    global _fire_hook
    _fire_hook = cb


def _notify_fire(site: str, key: str, action: str) -> None:
    if _fire_hook is None:
        return
    try:
        _fire_hook(site, key, action)
    except Exception:  # noqa: BLE001 - telemetry must never break injection
        pass


@dataclass
class FaultRule:
    """One armed fault. ``check()`` decides *whether* it fires; the call site
    interprets ``action`` (a store knows ``drop``, an RPC client ``connloss``;
    ``crash``/``delay``/``raise`` are generic via :func:`apply`)."""

    site: str
    action: str
    nth: Optional[int] = None      # fire on exactly the Nth matching call
    every: Optional[int] = None    # fire on every Nth matching call
    p: Optional[float] = None      # fire with this probability (seeded PRNG)
    times: Optional[int] = None    # stop after this many fires (this process)
    seed: int = 0
    match: Optional[str] = None    # substring filter on the call key
    once: Optional[str] = None     # sentinel path: at most one fire, ALL procs
    ms: float = 50.0               # delay duration for action=delay
    #: extra delay per MiB the call site reports moving (sites that pass
    #: ``nbytes`` to :func:`apply` — e.g. ``shuffle.fetch``); models a slow
    #: data plane whose cost scales with payload size. 0 = fixed delay only.
    ms_per_mb: float = 0.0
    bucket: int = 0                # which output bucket a shuffle drop targets
    #: registry position — part of the PRNG stream so two stacked rules with
    #: identical (seed, site, action) still draw independent p= schedules;
    #: spec order is stable, so runs stay reproducible
    index: int = 0
    # runtime state (per process)
    calls: int = 0
    fires: int = 0
    _rng: random.Random = field(default=None, repr=False)  # type: ignore

    def __post_init__(self):
        # the same loud-failure contract as parse_spec, for the programmatic
        # path too: a typo'd action would fire-and-claim (rule.fires grows,
        # once-sentinels get consumed) while injecting nothing
        if self.action not in KNOWN_ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r} "
                f"(known: {', '.join(sorted(KNOWN_ACTIONS))})")
        sites = SITE_SPECIFIC_ACTIONS.get(self.action)
        if sites is not None and self.site not in sites:
            raise ValueError(
                f"action {self.action!r} is only interpreted at "
                f"{'/'.join(sites)}, not {self.site!r}")
        if self._rng is None:
            # per-rule stream: independent of firing order at other sites
            self._rng = random.Random(
                repr((self.seed, self.site, self.action, self.index)))

    def _schedule_fires(self) -> bool:
        if self.nth is not None:
            return self.calls == self.nth
        if self.every is not None:
            return self.every > 0 and self.calls % self.every == 0
        if self.p is not None:
            return self._rng.random() < self.p
        return True  # no schedule: every matching call

    def register_call(self, key: str) -> bool:
        """Count the call; True when the schedule selects it. No claim yet —
        a rule that loses to an earlier same-site rule must NOT consume its
        ``once`` sentinel or ``times`` budget for a fire that never happened."""
        if self.match is not None and self.match not in key:
            return False
        self.calls += 1
        if self.times is not None and self.fires >= self.times:
            return False
        return self._schedule_fires()

    def claim(self) -> bool:
        """Commit a selected fire: atomically claims the ``once`` sentinel so
        exactly one process (and one call) wins."""
        if self.once is not None and not _claim_sentinel(self.once):
            return False
        self.fires += 1
        return True

    def should_fire(self, key: str) -> bool:
        """Count the call and decide, claiming on success."""
        return self.register_call(key) and self.claim()


def _claim_sentinel(path: str) -> bool:
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    except OSError as exc:
        # an unwritable/nonexistent once= path would otherwise permanently
        # and silently disarm the rule — the exact failure mode this module
        # promises to surface loudly; the schedule stays disarmed (firing in
        # every process is worse) but the disarm is now visible in logs
        logger.warning(
            "fault once= sentinel %s is unusable (%s); rule will not fire",
            path, exc)
        return False
    os.write(fd, str(os.getpid()).encode())
    os.close(fd)
    return True


def parse_spec(spec: str, default_seed: int = 0,
               start_index: int = 0) -> List[FaultRule]:
    """Parse the ``RDT_FAULTS`` grammar; raises ValueError on a bad rule so a
    typo fails loudly instead of silently disarming the chaos schedule.
    ``start_index`` offsets the per-rule PRNG ``index`` so env rules parsed
    into a registry that already holds inject()-ed rules (reset() keeps
    them) don't reuse an existing rule's stream."""
    rules: List[FaultRule] = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        if len(parts) < 2:
            raise ValueError(f"fault rule needs site:action, got {raw!r}")
        site, action = parts[0].strip(), parts[1].strip()
        if site not in KNOWN_SITES:
            raise ValueError(
                f"unknown fault site {site!r} (known: "
                f"{', '.join(sorted(KNOWN_SITES))}) in rule {raw!r}")
        kw: Dict[str, object] = {"seed": default_seed,
                                 "index": start_index + len(rules)}
        for opt in parts[2:]:
            if "=" not in opt:
                raise ValueError(f"fault option {opt!r} is not key=value")
            k, v = opt.split("=", 1)
            k = k.strip()
            if k in ("nth", "every", "times", "seed", "bucket"):
                kw[k] = int(v)
            elif k in ("p", "ms", "ms_per_mb"):
                kw[k] = float(v)
            elif k in ("match", "once"):
                kw[k] = v
            else:
                raise ValueError(f"unknown fault option {k!r} in {raw!r}")
        try:
            # action-name and action/site validation live in
            # FaultRule.__post_init__ (shared with the programmatic path);
            # re-raise with the offending rule text for env-spec context
            rules.append(FaultRule(site=site, action=action, **kw))  # type: ignore
        except ValueError as e:
            raise ValueError(f"{e} (in rule {raw!r})") from None
    return rules


class FaultPlane:
    """Process-local registry: env rules (loaded once) + programmatic rules."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: List[FaultRule] = []
        #: inject()-armed rules — they survive reset() (only env rules are
        #: reloaded); wiping them there would be the silent-no-op failure
        #: mode this module otherwise rejects loudly
        self._prog_rules: List[FaultRule] = []
        self._env_loaded = False
        # lock-free hot-path gate: check() is wired into every RPC submit and
        # every store read, so the zero-rules case (production) must not
        # serialize all threads through the lock just to see an empty list
        self._armed = False

    def _ensure_env(self) -> None:
        if self._env_loaded:
            return
        with self._lock:
            if self._env_loaded:
                return
            # both knobs ARE declared in raydp_tpu_torch/knobs.py, but this module
            # must stay stdlib-only and importable before the package
            # (actor bootstrap), so it reads the env directly; init()
            # re-arms from the current env
            # rdtlint: allow[knob-registry] bootstrap module, stdlib-only
            spec = os.environ.get(ENV_FAULTS, "")
            # rdtlint: allow[knob-registry] bootstrap module, stdlib-only
            seed = int(os.environ.get(ENV_SEED, "0") or 0)
            if spec:
                # after reset() the registry may still hold inject()-ed
                # rules whose indices were assigned against the OLD env
                # load; start past the highest survivor so an env rule with
                # the same (seed, site, action) draws an independent stream
                start = (max(r.index for r in self._rules) + 1
                         if self._rules else 0)
                self._rules.extend(
                    parse_spec(spec, default_seed=seed, start_index=start))
            self._armed = bool(self._rules)
            self._env_loaded = True

    def inject(self, site: str, action: str, **opts) -> FaultRule:
        """Arm a rule in THIS process (spawned processes only see the env)."""
        self._ensure_env()
        with self._lock:
            opts.setdefault("index", (max(r.index for r in self._rules) + 1
                                      if self._rules else 0))
            rule = FaultRule(site=site, action=action, **opts)
            self._rules.append(rule)
            self._prog_rules.append(rule)
            self._armed = True
        return rule

    def clear(self) -> None:
        """Disarm everything, including env-loaded rules (tests)."""
        with self._lock:
            self._rules = []
            self._prog_rules = []
            self._armed = False
            self._env_loaded = True

    def reset(self) -> None:
        """Re-arm from the CURRENT env on next use, keeping inject()-ed
        rules: a harness arms programmatically and then calls init() —
        silently disarming its rule would make the chaos run test nothing."""
        with self._lock:
            self._rules = list(self._prog_rules)
            self._armed = bool(self._rules)
            self._env_loaded = False

    def rules(self) -> List[FaultRule]:
        self._ensure_env()
        with self._lock:
            return list(self._rules)

    def check(self, site: str, key: str = "") -> Optional[FaultRule]:
        """The first armed rule for ``site`` whose schedule fires on this
        call, or None. Cheap when nothing is armed (the common case). Every
        same-site rule counts the call, so stacked rules keep independent
        schedules (an earlier rule firing never shifts a later rule's nth)."""
        self._ensure_env()
        if not self._armed:  # lock-free: bool read is atomic in CPython
            return None
        with self._lock:
            if not self._rules:
                return None
            fired: Optional[FaultRule] = None
            for rule in self._rules:
                if rule.site != site:
                    continue
                # register on every rule (independent schedules), but claim
                # only the winner — a loser keeps its once-sentinel unclaimed
                # so the missed fire is observable, not silently swallowed
                if rule.register_call(key) and fired is None and rule.claim():
                    fired = rule
        if fired is not None:
            # outside the lock: the hook may take the telemetry lock
            _notify_fire(site, key, fired.action)
        return fired


_plane = FaultPlane()

# module-level facade ---------------------------------------------------------
inject = _plane.inject
clear = _plane.clear
reset = _plane.reset
rules = _plane.rules
check = _plane.check


def active() -> bool:
    return bool(_plane.rules())


def crash_process(code: int = CRASH_EXIT_CODE) -> None:
    """Die abruptly, bypassing atexit/finally — the node-kill analogue."""
    os._exit(code)


def apply(rule: FaultRule, site: str = "", nbytes: int = 0) -> None:
    """Execute a generic action (``crash``/``delay``/``raise``). Site-specific
    actions (``drop``, ``connloss``) are interpreted by their call sites and
    ignored here, so a site can safely route every fired rule through apply()
    after handling its own. ``nbytes`` lets a data-plane site scale a delay
    by the payload it moves (``ms_per_mb=``)."""
    if rule.action == "crash":
        crash_process()
    elif rule.action == "delay":
        # an injected delay IS the fault: chaos schedules deliberately stall
        # the serving thread to model a slow peer, bounded by ms/ms_per_mb
        # rdtlint: allow[dispatcher-blocking] injected delay is the fault
        time.sleep((rule.ms + rule.ms_per_mb * nbytes / float(1 << 20))
                   / 1000.0)
    elif rule.action == "raise":
        raise InjectedFault(
            f"injected fault at {site or rule.site} (rule {rule.action})")


class InjectedFault(RuntimeError):
    """The generic ``raise`` action. Deliberately NOT in the engine's no-retry
    set: an injected raise models a transient fault, so task retry absorbs it."""
