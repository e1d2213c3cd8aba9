"""raydp_tpu_torch as a package: no JAX, no reference imports, no quiet CPU
fallback, and a kernel wrapper that refuses what its kernel does not take."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

from raydp_tpu_torch import profiler, resolve_device
from raydp_tpu_torch.data import DeviceEpochCache, DeviceFeed
from raydp_tpu_torch.models import DLRM, MLP, NYCTaxiModel, TransformerLM
from raydp_tpu_torch.models.dlrm import DotInteraction
from raydp_tpu_torch.models.transformer import Attention, Block, RMSNorm
from raydp_tpu_torch.ops import _build
from raydp_tpu_torch.ops import flash_attention as tfa
from raydp_tpu_torch.train import TorchEstimator

REPO = Path(__file__).resolve().parent.parent


def test_imports_neither_jax_nor_the_reference():
    code = (
        "import pkgutil, importlib, sys, raydp_tpu_torch\n"
        "for m in pkgutil.walk_packages(raydp_tpu_torch.__path__, "
        "'raydp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith(('jax.', 'flax', 'optax')) or n == 'raydp_tpu' or "
        "n.startswith('raydp_tpu.'))\n"
        "for name in ('models.transformer', 'models.mlp', 'models.dlrm', "
        "'models.layers', 'models.convert', 'data.dataset', 'data.feed', "
        "'native.stage', 'train.torch_estimator', 'train.checkpoint', "
        "'train.metrics', 'train.estimator', 'knobs', 'log', 'config', "
        "'utils', 'faults', 'metrics', 'profiler', 'native.arena', "
        "'runtime.rpc', 'runtime.actor', 'runtime.placement', "
        "'runtime.cluster_resources', 'runtime.object_store', "
        "'runtime.head', 'runtime.actor_main', 'runtime.client', "
        "'runtime.node_agent', 'runtime.warm_fork', 'etl.expressions', "
        "'etl.window', 'etl.functions', 'etl.plan', 'etl.optimizer', "
        "'etl.tasks', 'etl.executor', 'etl.master', 'etl.engine', "
        "'etl.frame', 'etl.autoscale', 'etl.session', 'context', 'cluster', "
        "'examples.nyctaxi_features', 'examples.generate_nyctaxi', "
        "'examples.dlrm_criteo', 'parallel.roles', 'train.step_graph', "
        "'stream.sources', 'stream.pipeline', 'serve.servable', "
        "'serve.replica', 'serve.session', 'serve.rollout', "
        "'serve.autoscale', 'models.gbdt', 'train.gbdt_estimator', "
        "'data.bridges', 'cli.submit', 'examples.gbdt_nyctaxi', "
        "'examples.torch_loop_nyctaxi', 'examples.nyctaxi_mlp', "
        "'examples.stroke_pipeline', 'tools.rdtlint', "
        "'tools.rdtlint.rule_steps', 'tools.rdtlint.__main__', "
        "'spmd.job', 'spmd.worker', 'parallel.gang', "
        "'examples.spmd_job'):\n"
        "    assert 'raydp_tpu_torch.' + name in sys.modules, name\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def _string_constants(tree):
    """Every string literal of a module that is not a docstring."""
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [node for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


def test_no_string_names_the_reference_package():
    """Module paths and directories named in strings (``python -m ...``
    spawn commands, logger names, the session directory) are the port's:
    a copied string naming ``raydp_tpu`` would have the port's actors run
    the reference's code."""
    found = []
    for path in sorted((REPO / "raydp_tpu_torch").rglob("*.py")):
        for node in _string_constants(ast.parse(path.read_text())):
            if re.search(r"raydp_tpu(?!_torch)\b", node.value):
                found.append(f"{path.relative_to(REPO)}:{node.lineno}")
    assert found == []


def test_version_is_the_project_s_and_importing_does_not_import_torch():
    """``__version__`` is ``pyproject.toml``'s version and in ``__all__``,
    as in the reference; reading it imports no torch (the runtime's actor
    processes import the package without it)."""
    text = (REPO / "pyproject.toml").read_text()
    version = re.search(r'^version = "([^"]+)"', text, re.M).group(1)
    code = ("import sys, raydp_tpu_torch as p\n"
            "print(p.__version__, '__version__' in p.__all__, "
            "'torch' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [version, "True", "False"]
    assert version == "0.1.0"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_default_device_model_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerLM(64, dim=16, num_heads=2, num_layers=1)


@pytest.mark.parametrize("make", [
    lambda **kw: RMSNorm(16, **kw),
    lambda **kw: Attention(16, 2, **kw),
    lambda **kw: Block(16, 2, **kw),
], ids=["RMSNorm", "Attention", "Block"])
def test_default_device_modules_raise_without_cuda(no_cuda, make):
    """Each public module resolves its device as the model does: CUDA by
    default, an error without it, the CPU only when asked for."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    assert all(p.device.type == "cpu" for p in make(device="cpu").parameters())


def _tiny_dataset():
    import numpy as np
    import pyarrow as pa

    from raydp_tpu_torch.data import TableDataset

    x = np.arange(8, dtype=np.float32)
    return TableDataset([pa.table({"x": x, "y": x})])


@pytest.mark.parametrize("make", [
    lambda **kw: MLP(3, (4,), **kw),
    lambda **kw: NYCTaxiModel(3, **kw),
    lambda **kw: DLRM([5, 5], embedding_dim=4, bottom_mlp=(4,),
                      top_mlp=(4, 1), **kw),
    lambda **kw: DotInteraction(3, **kw),
], ids=["MLP", "NYCTaxiModel", "DLRM", "DotInteraction"])
def test_default_device_main_path_models_raise_without_cuda(no_cuda, make):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    module = make(device="cpu")
    assert all(t.device.type == "cpu"
               for t in [*module.parameters(), *module.buffers()])


@pytest.mark.parametrize("make", [
    lambda **kw: TorchEstimator(model=NYCTaxiModel(1, device="cpu"),
                                feature_columns=["x"], label_column="y",
                                **kw),
    lambda **kw: DeviceFeed(_tiny_dataset(), 4,
                            {"features": ("x", "float32")}, **kw),
    lambda **kw: DeviceEpochCache(_tiny_dataset(),
                                  {"features": ("x", "float32")}, **kw),
], ids=["TorchEstimator", "DeviceFeed", "DeviceEpochCache"])
def test_default_device_estimator_and_feeds_raise_without_cuda(no_cuda, make):
    """The estimator and both device feeds run on CUDA unless the caller
    passes device="cpu"; without CUDA they raise instead of training or
    feeding on the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    assert make(device="cpu").device == torch.device("cpu")


def test_init_runs_the_etl_on_the_host_and_training_still_needs_cuda(no_cuda):
    """``raydp_tpu_torch.init`` starts the ETL on host executors, which load
    no torch; what it feeds to training does not make training quietly run
    on the CPU: ``fit_on_frame``'s estimator and the feeds of a
    frame-converted dataset raise without CUDA unless asked for the CPU."""
    import raydp_tpu_torch
    from raydp_tpu_torch.data import from_frame

    session = raydp_tpu_torch.init("pytest-package", num_executors=1,
                                   executor_cores=1, executor_memory="256MB")
    try:
        ds = from_frame(session.range(64).withColumnRenamed("id", "x"))
        assert ds.count() == 64
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TorchEstimator(model=NYCTaxiModel(1, device="cpu"),
                           feature_columns=["x"], label_column="x")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeviceFeed(ds, 8, {"features": ("x", "float32")})
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeviceEpochCache(ds, {"features": ("x", "float32")})
        assert DeviceFeed(ds, 8, {"features": ("x", "float32")},
                          device="cpu").device == torch.device("cpu")
    finally:
        raydp_tpu_torch.stop()



class _InProcessExecutor:
    """An executor handle that runs the replica registry's calls in this
    process, as an executor runs them in its own."""

    name = "ex0"

    def submit(self, method, *args):
        from concurrent.futures import Future

        from raydp_tpu_torch.serve import replica

        fut = Future()
        try:
            fut.set_result(replica.load(args[0], args[1], self.name,
                                        *args[2:]))
        except Exception as e:  # noqa: BLE001 - what the RPC would carry
            fut.set_exception(e)
        return fut

    def call(self, method, *args, timeout=None):
        from raydp_tpu_torch.serve import replica

        assert method == "serve_unload"
        return replica.unload(args[0])


def test_serving_defaults_to_cuda_and_raises_without_it(no_cuda, tmp_path):
    """``load_servable`` and each replica a ``ServingSession`` loads run on
    CUDA unless asked for the CPU: without CUDA the load raises, and the
    session fails at its start instead of serving on the CPU."""
    from raydp_tpu_torch.data import TableDataset
    from raydp_tpu_torch.serve import ServingSession, load_servable

    table = pa.table({"x": np.arange(64, dtype=np.float32),
                      "y": np.ones(64, np.float32)})
    est = TorchEstimator(model=NYCTaxiModel(1, device="cpu"),
                         feature_columns=["x"], label_column="y",
                         batch_size=32, num_epochs=1, device="cpu")
    est.fit(TableDataset([table]))
    path = est.export_serving(str(tmp_path / "bundle"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_servable(path)
    assert load_servable(path, device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingSession(path, executors=[_InProcessExecutor()], name="nocuda")
    srv = ServingSession(path, executors=[_InProcessExecutor()],
                         name="oncpu", device="cpu")
    srv.close()


def test_torch_trace_defaults_to_cuda_and_writes_a_chrome_trace(no_cuda,
                                                                tmp_path):
    """``profiler.torch_trace`` traces the card unless asked for the CPU,
    and raises without CUDA; on the CPU it writes one Chrome trace per
    use into the log dir."""
    import json

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with profiler.torch_trace(str(tmp_path)):
            pass
    for _ in range(2):
        with profiler.torch_trace(str(tmp_path), device="cpu") as log_dir:
            torch.ones(64).sum()
    traces = sorted(os.listdir(log_dir))
    assert log_dir == str(tmp_path) and len(traces) == 2
    events = json.loads((tmp_path / traces[0]).read_text())["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)


def _qkv3(bh=2, t=16, d=64, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(bh, t, d, generator=g).to(dtype) for _ in range(3)]


def test_fwd_cuda_refuses_cpu_tensors():
    """The kernel wrapper never hands CPU tensors to the plain version: a
    dispatch mistake raises instead of hiding behind the plain path."""
    before = tfa.FWD_LAUNCHES
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfa._fwd_cuda(*_qkv3(), 0.125, True)
    assert tfa.FWD_LAUNCHES == before


@pytest.mark.parametrize("case", ["head_dim", "dtype", "mixed", "shape"])
def test_fwd_cuda_refuses_what_the_kernel_does_not_take(case):
    q, k, v = _qkv3()
    if case == "head_dim":
        q, k, v = _qkv3(d=48)
    elif case == "dtype":
        q, k, v = _qkv3(dtype=torch.float16)
    elif case == "mixed":
        v = v.bfloat16()
    else:
        k = k[:, :8]
    with pytest.raises(ValueError):
        tfa._fwd_cuda(q, k, v, 0.125, True)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler is an error, never a quiet fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("flash_attention_fwd")


def _copy_csrc(monkeypatch, tmp_path):
    """Point the builder at a copy of csrc/ (sources and shared headers)."""
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)


def test_library_path_tracks_source_content(monkeypatch, tmp_path):
    """An unchanged source maps to the same library; an edited one to a new
    library, so a stale build is never loaded."""
    path = _build.library_path("flash_attention_fwd")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("flash_attention_fwd-")
    assert path == _build.library_path("flash_attention_fwd")
    _copy_csrc(monkeypatch, tmp_path)
    assert _build.library_path("flash_attention_fwd") == path
    source = tmp_path / "flash_attention_fwd.cu"
    source.write_text(source.read_text() + "\n// edit\n")
    assert _build.library_path("flash_attention_fwd") != path


@pytest.mark.parametrize("name", ["flash_attention_fwd",
                                  "flash_attention_bwd"])
@pytest.mark.parametrize("change", ["edit", "add"])
def test_library_path_tracks_shared_headers(monkeypatch, tmp_path, name,
                                            change):
    """Every library is rebuilt when a shared csrc/*.cuh header is edited or
    added, since any source may include it."""
    path = _build.library_path(name)
    _copy_csrc(monkeypatch, tmp_path)
    assert _build.library_path(name) == path
    if change == "edit":
        header = tmp_path / "flash_attention_common.cuh"
        header.write_text(header.read_text() + "\n// edit\n")
    else:
        (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path(name) != path


def _bwd_inputs(bh=2, t=16, d=64, dtype=torch.float32):
    """(q, k, v, out, lse, do) for _bwd_cuda on the CPU."""
    q, k, v = _qkv3(bh, t, d, dtype)
    out, lse = tfa._fwd_plain(q, k, v, 0.125, True)
    return q, k, v, out, lse, torch.ones_like(out)


def _launches():
    return tfa.FWD_LAUNCHES, tfa.DKDV_LAUNCHES, tfa.DQ_LAUNCHES


def test_bwd_cuda_refuses_cpu_tensors():
    """As the forward: CPU tensors never reach the plain backward through
    the kernel wrapper, and no launch is counted."""
    before = _launches()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfa._bwd_cuda(*_bwd_inputs(), 0.125, True)
    assert _launches() == before


@pytest.mark.parametrize("case", ["head_dim", "dtype", "mixed", "shape",
                                  "lse"])
def test_bwd_cuda_refuses_what_the_kernels_do_not_take(case):
    q, k, v, out, lse, do = _bwd_inputs()
    if case == "head_dim":
        q, k, v, out, lse, do = _bwd_inputs(d=48)
    elif case == "dtype":
        q, k, v, out, lse, do = _bwd_inputs(dtype=torch.float16)
    elif case == "mixed":
        do = do.bfloat16()
    elif case == "shape":
        k = k[:, :8]
    else:
        lse = lse[:, :8]
    before = _launches()
    with pytest.raises(ValueError, match="lse" if case == "lse" else None):
        tfa._bwd_cuda(q, k, v, out, lse, do, 0.125, True)
    assert _launches() == before
