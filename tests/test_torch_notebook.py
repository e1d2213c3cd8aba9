"""The port's DLRM notebook (``raydp_tpu_torch/examples/dlrm_tutorial.ipynb``)
executed as the reference's CI executes its own (``jupyter nbconvert
--to notebook --execute``), on the CPU (``NB_DEVICE=cpu``) at 4000 rows and
2 epochs, and held to the reference's pipeline on the same TSV:

- the notebook's TSV is byte for byte the reference's ``generate_criteo``
  at the same rows and seed;
- the row count and the first eight categorical cardinalities it prints
  equal those of the reference's ``pre_process`` on that TSV, run through a
  reference session of the notebook's shape (column by column, so as a
  multiset too);
- its trained parameter count equals the leaf count of the Flax ``DLRM``
  with the same arguments over the reference's cardinalities, initialised
  as the reference's tests initialise it on the CPU;
- its train loss falls and stays finite (the notebook asserts the fall
  itself, so a failed assert fails the execution);
- the reference's parameter count at the notebook's defaults (40,000
  rows) is the one ``chip_smoke.py`` holds the card's run of the notebook
  to (``NOTEBOOK_PARAMS``).

The kernel is a subprocess that imports only the port. The reference's
session runs in this process while the kernel runs (a runtime of each
package, never two in one process).
"""

import ast
import glob
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOK = os.path.join(REPO, "raydp_tpu_torch", "examples",
                        "dlrm_tutorial.ipynb")
ROWS, EPOCHS = 4000, 2
#: the notebook's DLRM and session, as its cells 5 and 7 build them
WIDTHS = dict(embedding_dim=16, bottom_mlp=(64, 32, 16), top_mlp=(128, 64, 1))
SESSION = dict(num_executors=2, executor_cores=2, executor_memory="2GB")


def _reference_example():
    """The reference's ``examples/dlrm_criteo.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "ref_example_dlrm_criteo",
        os.path.join(REPO, "examples", "dlrm_criteo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _start(tmp_path):
    """Starts nbconvert on a copy of the notebook; returns the process, the
    executed notebook's path and the TMPDIR the kernel writes under."""
    work, tmp = tmp_path / "nb", tmp_path / "tmp"
    work.mkdir()
    tmp.mkdir()
    shutil.copy(NOTEBOOK, work / "dlrm_tutorial.ipynb")
    env = dict(os.environ, NB_DEVICE="cpu", NB_ROWS=str(ROWS),
               NB_EPOCHS=str(EPOCHS), TMPDIR=str(tmp),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    with open(tmp_path / "nbconvert.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "jupyter", "nbconvert", "--to",
             "notebook", "--execute", "--ExecutePreprocessor.timeout=300",
             "--output", "executed.ipynb",
             str(work / "dlrm_tutorial.ipynb")],
            env=env, stdout=log, stderr=subprocess.STDOUT)
    return proc, work / "executed.ipynb", tmp


def _outputs(proc, executed, log):
    """The text of each code cell's standard output, once nbconvert
    exited 0."""
    try:
        rc = proc.wait(timeout=420)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log) as f:
        assert rc == 0, f"nbconvert failed:\n{f.read()[-6000:]}"
    with open(executed) as f:
        nb = json.load(f)
    return ["".join("".join(o.get("text", "")) for o in cell["outputs"]
                    if o.get("name") == "stdout")
            for cell in nb["cells"] if cell["cell_type"] == "code"]


def _line(text, prefix):
    (line,) = [x for x in text.splitlines() if x.startswith(prefix)]
    return line[len(prefix):].strip()


def _reference_pipeline(tsvs):
    """The reference notebook's cells 5 and 7 up to the model's build, for
    each TSV in one reference session: the row count, the cardinalities,
    and the Flax DLRM's parameter count."""
    import jax
    import jax.numpy as jnp

    import raydp_tpu
    from raydp_tpu.models import DLRM

    ex = _reference_example()
    names = [ex.LABEL] + ex.DENSE_COLS + ex.CAT_COLS
    found = []
    session = raydp_tpu.init("pytest-notebook-ref", **SESSION)
    try:
        for tsv in tsvs:
            df = session.read.csv(tsv, num_partitions=4, options={
                "delimiter": "\t", "column_names": names})
            df, cat_sizes = ex.pre_process(session, df)
            found.append((df.count(), cat_sizes))
    finally:
        raydp_tpu.stop()
    out = []
    for rows, cat_sizes in found:
        model = DLRM(categorical_sizes=cat_sizes, num_dense=ex.NUM_DENSE,
                     **WIDTHS)
        variables = model.init(jax.random.PRNGKey(0), {
            "dense": jnp.zeros((2, ex.NUM_DENSE), jnp.float32),
            "sparse": jnp.zeros((2, len(cat_sizes)), jnp.int32)})
        out.append((rows, cat_sizes, sum(
            int(np.prod(p.shape)) for p in jax.tree.leaves(variables))))
    return out


def test_notebook_matches_the_reference_pipeline(tmp_path):
    import chip_smoke

    proc, executed, tmp = _start(tmp_path)
    try:
        # the reference's TSVs: the notebook's rows here, and its defaults
        ex = _reference_example()
        small, full = tmp_path / "reference.tsv", tmp_path / "default.tsv"
        ex.generate_criteo(ROWS, str(small))
        ex.generate_criteo(chip_smoke.NOTEBOOK_ROWS, str(full))
        (rows, cat_sizes, n_params), (_, _, default_params) = \
            _reference_pipeline([str(small), str(full)])
    finally:
        outputs = _outputs(proc, executed, tmp_path / "nbconvert.log")

    # the outputs of cells 3 (generate), 5 (pre_process), 7 (fit), 9
    generate, prep, fit, model = outputs[1:]
    history = [ast.literal_eval(x) for x in fit.splitlines()
               if x.startswith("{'epoch'")]
    losses = [r["train_loss"] for r in history]
    assert len(history) == EPOCHS, fit
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], losses

    # the TSV the kernel wrote (cell 3 prints its path) is the reference's
    tsv = generate.split()[0]
    assert tsv.startswith(str(tmp)) and glob.glob(
        os.path.join(str(tmp), "rdt-nb-*", "criteo.tsv")) == [tsv], generate
    with open(tsv, "rb") as a, open(small, "rb") as b:
        assert a.read() == b.read(), "the notebook's TSV is not the reference's"

    assert int(_line(prep, "rows:")) == rows == ROWS
    assert ast.literal_eval(_line(
        prep, "categorical cardinalities (first 8):")) == cat_sizes[:8]
    assert int(_line(model, "trained parameters:").replace(",", "")) \
        == n_params
    assert default_params == chip_smoke.NOTEBOOK_PARAMS
