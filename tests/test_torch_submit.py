"""The port's ``rdt-submit-torch`` CLI (``raydp_tpu_torch.cli.submit``): the
counterparts of ``tests/test_submit.py`` (parity: bin/raydp-submit — conf
handoff into the session, exit-code propagation), with scripts that start
the port's session."""

import os
import subprocess
import sys
import textwrap


def _run(args, cwd):
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "raydp_tpu_torch.cli.submit"] + args,
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_torch_submit_conf_handoff(tmp_path):
    script = tmp_path / "job.py"
    script.write_text(textwrap.dedent("""
        import raydp_tpu_torch
        session = raydp_tpu_torch.init("submitted")   # all defaults in code
        print("EXECUTORS=%d" % len(session.executors))
        print("CONF=%s" % session.config.get("raydp.tpu.custom.key"))
        raydp_tpu_torch.stop()
    """))
    proc = _run(["--num-executors", "2",
                 "--conf", "raydp.tpu.custom.key=hello",
                 str(script)], cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "EXECUTORS=2" in proc.stdout
    assert "CONF=hello" in proc.stdout


def test_torch_submit_explicit_args_win(tmp_path):
    script = tmp_path / "job.py"
    script.write_text(textwrap.dedent("""
        import raydp_tpu_torch
        session = raydp_tpu_torch.init("submitted", num_executors=1)
        print("EXECUTORS=%d" % len(session.executors))
        raydp_tpu_torch.stop()
    """))
    proc = _run(["--num-executors", "3", str(script)], cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "EXECUTORS=1" in proc.stdout


def test_torch_submit_exit_code_and_args_passthrough(tmp_path):
    script = tmp_path / "job.py"
    script.write_text(textwrap.dedent("""
        import sys
        assert sys.argv[1:] == ["--flag", "value"]
        sys.exit(7)
    """))
    proc = _run([str(script), "--flag", "value"], cwd=str(tmp_path))
    assert proc.returncode == 7


def test_torch_submit_missing_script(tmp_path):
    proc = _run(["/nonexistent/script.py"], cwd=str(tmp_path))
    assert proc.returncode != 0
    assert "not found" in proc.stderr


def test_torch_submit_py_files(tmp_path):
    """--py-files makes sidecar modules importable in the submitted driver
    (parity: the reference's raydp-submit --py-files examples,
    examples/test_raydp_submit_pyfiles.py + test_pyfile.py)."""
    lib_dir = tmp_path / "deps"
    lib_dir.mkdir()
    (lib_dir / "helper_mod.py").write_text("VALUE = 41\n")
    # the bare .py lives in a third directory (NOT the script's dir, which
    # python puts on sys.path anyway) with a sibling that must NOT become
    # importable: only the named file ships, as with spark-submit
    other_dir = tmp_path / "elsewhere"
    other_dir.mkdir()
    (other_dir / "single.py").write_text("OTHER = 1\n")
    (other_dir / "sibling_mod.py").write_text("LEAKED = True\n")

    script_dir = tmp_path / "app"
    script_dir.mkdir()
    script = script_dir / "job.py"
    script.write_text(textwrap.dedent("""
        import helper_mod
        import single
        try:
            import sibling_mod
            print("SIBLING_LEAKED")
        except ImportError:
            pass
        print("SUM=%d" % (helper_mod.VALUE + single.OTHER))
    """))
    proc = _run(["--py-files", f"{lib_dir},{other_dir / 'single.py'}",
                 str(script)], cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "SUM=42" in proc.stdout
    assert "SIBLING_LEAKED" not in proc.stdout


def test_torch_submit_py_files_missing(tmp_path):
    script = tmp_path / "job.py"
    script.write_text("print('hi')\n")
    proc = _run(["--py-files", "/nonexistent/dep.py", str(script)],
                cwd=str(tmp_path))
    assert proc.returncode != 0
    assert "not found" in proc.stderr
