"""``rdt-submit-torch`` — non-inline job submission; the port's copy of
:mod:`raydp_tpu.cli.submit`.

Parity: the reference's ``bin/raydp-submit`` + SparkSubmit fork (the fork's one
load-bearing change is accepting ``--master ray``, SparkSubmit.scala:231-240;
the wrapper assembles classpaths and forwards ``--conf``). Here there is no
JVM to assemble: the CLI packages the cluster configuration into the
environment and execs the user script in a child interpreter —
``raydp_tpu_torch.init`` inside the script resolves any argument the script
left at its default from the submitted values (explicit arguments in code
still win, Spark's precedence). The child's exit code is propagated, and
SIGINT/SIGTERM forward to the child's process group.

    rdt-submit-torch --num-executors 4 --executor-cores 2 \\
                     --conf raydp.tpu.shuffle.partitions=16 train.py --epochs 3
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
from typing import List, Optional

ENV_SUBMIT = "RDT_SUBMIT_ARGS"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="rdt-submit-torch",
        description="Run a raydp_tpu_torch script with cluster configuration "
                    "supplied at submit time (parity: bin/raydp-submit)")
    ap.add_argument("--name", default=None, help="application name override")
    ap.add_argument("--num-executors", type=int, default=None)
    ap.add_argument("--executor-cores", type=int, default=None)
    ap.add_argument("--executor-memory", default=None, help="e.g. 2GB")
    ap.add_argument("--placement-group-strategy", default=None,
                    choices=["PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"])
    ap.add_argument("--conf", action="append", default=[], metavar="K=V",
                    help="config entry (repeatable), e.g. raydp.tpu.x=y")
    ap.add_argument("--py-files", default=None, metavar="PATHS",
                    help="comma-separated .py files, .zip archives or "
                         "directories added to the driver's import path "
                         "(parity: spark-submit --py-files through "
                         "bin/raydp-submit)")
    ap.add_argument("--env", action="append", default=[], metavar="K=V",
                    help="extra environment for the script (repeatable)")
    ap.add_argument("script", help="python script to run")
    ap.add_argument("script_args", nargs=argparse.REMAINDER,
                    help="arguments passed through to the script")
    return ap


def _parse_kv(items: List[str], flag: str) -> dict:
    out = {}
    for item in items:
        key, sep, value = item.partition("=")
        if not sep or not key:
            raise SystemExit(
                f"rdt-submit-torch: {flag} expects K=V, got {item!r}")
        out[key] = value
    return out


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.exists(args.script):
        raise SystemExit(f"rdt-submit-torch: script not found: {args.script}")

    submit = {
        "app_name": args.name,
        "num_executors": args.num_executors,
        "executor_cores": args.executor_cores,
        "executor_memory": args.executor_memory,
        "placement_group_strategy": args.placement_group_strategy,
        "configs": _parse_kv(args.conf, "--conf"),
    }
    env = dict(os.environ)
    env.update(_parse_kv(args.env, "--env"))
    stage_dir = None
    if args.py_files:
        # Bare .py files are staged into one scratch dir and only that dir
        # goes on the path — putting a file's parent dir up would expose
        # every sibling module (and can shadow installed packages), which
        # spark-submit's --py-files never does. Zips and directories go on
        # the path directly.
        entries = []
        staged = {}  # basename → source path; a silent overwrite would make
        #              the LAST listed file win, inverting path precedence
        try:
            for raw in args.py_files.split(","):
                raw = raw.strip()
                if not raw:  # trailing/doubled comma must not resolve to cwd
                    continue
                p = os.path.abspath(raw)
                if not os.path.exists(p):
                    raise SystemExit(
                        f"rdt-submit-torch: --py-files entry not found: {p}")
                if p.endswith(".py"):
                    base = os.path.basename(p)
                    prev = staged.get(base)
                    if prev is not None and prev != p:
                        raise SystemExit(
                            f"rdt-submit-torch: --py-files lists two files "
                            f"named "
                            f"{base!r} ({prev} and {p}); module names must "
                            "be unique")
                    if stage_dir is None:
                        stage_dir = tempfile.mkdtemp(prefix="rdt-pyfiles-")
                        entries.append(stage_dir)
                    staged[base] = p
                    shutil.copy2(p, stage_dir)
                else:
                    entries.append(p)
        except BaseException:
            # a bad LATER entry must not leak the dir staged so far (the
            # normal-path cleanup lives in the wait() finally below, which
            # is never reached on a staging abort)
            if stage_dir is not None:
                shutil.rmtree(stage_dir, ignore_errors=True)
            raise
        seen = dict.fromkeys(entries)  # dedupe, keep order
        env["PYTHONPATH"] = os.pathsep.join(
            list(seen) + [env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env[ENV_SUBMIT] = json.dumps(
        {k: v for k, v in submit.items() if v not in (None, {})})

    proc = subprocess.Popen(
        [sys.executable, args.script] + list(args.script_args),
        env=env, start_new_session=True)

    def _forward(signum, _frame):
        try:
            os.killpg(proc.pid, signum)
        except (ProcessLookupError, PermissionError):
            pass

    old = {s: signal.signal(s, _forward)
           for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        return proc.wait()
    finally:
        for s, handler in old.items():
            signal.signal(s, handler)
        if stage_dir is not None:
            shutil.rmtree(stage_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
