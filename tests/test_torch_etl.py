"""The port's ETL engine against the reference's, on the CPU.

The same seeded inputs go through each package's ETL session (2 executors
× 1 core × 512MB, as ``tests/conftest.py::session``): the reference's
session runs every query first and is stopped, then the port's (the two
runtimes never run at once; they share environment names and the segment
prefix). Both engines make the same pyarrow calls in the same order, so the
outputs must be equal exactly: the same schema and the same values, bit for
bit. Where the plan has no shuffle the blocks are compared one by one;
elsewhere both sides are sorted by all columns first.

The aggregates are ones whose value does not depend on the order in which
partial results meet (integer sums and means, counts, minima, maxima): the
reference's reduce side folds partials in their arrival order, so a float
sum may differ in its last bit between two runs of the reference itself.
Every operator query runs under each setting of ``RDT_ETL_OPTIMIZER`` and
``RDT_ETL_AQE``; the adaptive re-planning events each stage reports
(broadcast conversions, skew splits, coalesced buckets) must match too.
The data plane (``from_frame``, ``from_frame_recoverable``, ``to_frame``,
the session's ``random_shuffle``) is compared the same way, and the port's
lineage recovery, ownership transfer and executor environment are checked
on their own.
"""

import importlib.util
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.compute as pc
import pytest

REPO = Path(__file__).resolve().parent.parent
SESSION = dict(num_executors=2, executor_cores=1, executor_memory="512MB")
NYC_ROWS, CRITEO_ROWS, SEED = 3000, 2000, 3
MODES = [(opt, aqe) for opt in ("1", "0") for aqe in ("1", "0")]
MODE_IDS = [f"opt{o}-aqe{a}" for o, a in MODES]


def _load(path: Path, name: str):
    """A module of ``examples/`` by file, without touching ``sys.path``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _api(side: str) -> types.SimpleNamespace:
    """One package's ETL surface under common names."""
    if side == "ref":
        import raydp_tpu as root
        from raydp_tpu import data
        from raydp_tpu.etl import functions as F
        from raydp_tpu.etl.expressions import col
        from raydp_tpu.etl.window import Window
        nyc = _load(REPO / "examples" / "nyctaxi_features.py",
                    "ref_nyctaxi_features")
        criteo = _load(REPO / "examples" / "dlrm_criteo.py",
                       "ref_dlrm_criteo")
    else:
        import raydp_tpu_torch as root
        from raydp_tpu_torch import data
        from raydp_tpu_torch.etl import functions as F
        from raydp_tpu_torch.etl.expressions import col
        from raydp_tpu_torch.etl.window import Window
        from raydp_tpu_torch.examples import dlrm_criteo as criteo
        from raydp_tpu_torch.examples import nyctaxi_features as nyc
    return types.SimpleNamespace(root=root, data=data, F=F, col=col,
                                 Window=Window, nyc=nyc, criteo=criteo)


def _frame(n=4000, seed=0) -> pd.DataFrame:
    rng = np.random.RandomState(seed)
    return pd.DataFrame({
        "k": rng.randint(0, 40, n),
        "s": [f"tag{i % 23}" for i in range(n)],
        "a": rng.randint(0, 1000, n).astype(np.int64),
        "b": rng.randint(0, 7, n),
        "x": rng.randn(n),
        "ts": rng.permutation(n),
    })


def _dim() -> pd.DataFrame:
    return pd.DataFrame({"k": np.arange(40), "label": np.arange(40) * 3.5})


#: query name -> (build(api, session, base, dim), compare block by block)
QUERIES = {
    "filter_withcolumn_select": (lambda a, s, base, dim: base.filter(
        (a.col("a") > 100) & (a.col("b") != 3)).withColumn(
        "c", a.col("a") * 2 + a.col("x")).select("k", "s", "c"), True),
    "groupby_agg": (lambda a, s, base, dim: base.groupBy("k", "b").agg(
        a.F.sum("a").alias("sa"), a.F.count("a").alias("n"),
        a.F.mean("a").alias("ma"), a.F.min("x").alias("mx"),
        a.F.max("ts").alias("mt")), False),
    "broadcast_join": (lambda a, s, base, dim: base.join(
        dim, on="k").select("k", "a", "x", "label"), False),
    "shuffle_join": (lambda a, s, base, dim: base.join(
        base.groupBy("k").agg(a.F.max("x").alias("top")), on="k"), False),
    "window": (lambda a, s, base, dim: base.withColumn(
        "rn", a.F.row_number().over(
            a.Window.partitionBy("k").orderBy("ts"))).withColumn(
        "prev", a.F.lag("x", 1, -1.0).over(
            a.Window.partitionBy("k").orderBy("ts"))), False),
    "sort": (lambda a, s, base, dim: base.sort("b", "ts"), False),
    "repartition": (lambda a, s, base, dim: base.repartition(3), False),
}


def _aqe_events(engine):
    """Each stage's adaptive events, sorted: the two sides of a join run
    at once and report in the order they finish."""
    return sorted((r["stage"], r.get("aqe_broadcast", 0),
                   r.get("aqe_split", 0), r.get("aqe_coalesced", 0))
                  for r in engine.shuffle_stage_report())


def _blocks(api, df):
    """The frame's partitions, materialized into the store and copied out
    (they outlive the session)."""
    ds = api.data.from_frame(df)
    return [pa.concat_tables([b]).combine_chunks() for b in ds.blocks()]


def _read_nyc(session, csv):
    return session.read.csv(csv, num_partitions=4)


def _read_criteo(api, session, tsv):
    names = [api.criteo.LABEL] + api.criteo.DENSE_COLS + api.criteo.CAT_COLS
    return session.read.csv(tsv, num_partitions=4, options={
        "delimiter": "\t", "column_names": names})


def _run_side(side: str, files: dict) -> dict:
    """Every query of the file through one package's session; the session
    is stopped before returning."""
    api = _api(side)
    out = {"queries": {}, "nyc": {}, "criteo": {}}
    with pytest.MonkeyPatch.context() as mp:
        session = api.root.init(f"pytest-etl-{side}", **SESSION)
        try:
            _queries(api, session, files, mp, out)
            if side == "port":
                out["executors"] = [h.call("spawn_info")["pid"]
                                    for h in session.executors]
                out["environ"] = [_proc_environ(pid)
                                  for pid in out["executors"]]
                out["maps"] = [Path(f"/proc/{pid}/maps").read_text()
                               for pid in out["executors"]]
        finally:
            api.root.stop()
    return out


def _queries(api, session, files, mp, out):
    """Every query, conversion and shuffle of the file, in one session."""
    base = session.createDataFrame(_frame(), num_partitions=4)
    dim = session.createDataFrame(_dim(), num_partitions=2)
    for mode in MODES:
        mp.setenv("RDT_ETL_OPTIMIZER", mode[0])
        mp.setenv("RDT_ETL_AQE", mode[1])
        for name, (build, _) in QUERIES.items():
            session.engine.reset_shuffle_stage_report()
            blocks = _blocks(api, build(api, session, base, dim))
            out["queries"][name, mode] = (
                blocks, _aqe_events(session.engine))
        out["nyc"][mode] = _blocks(api, api.nyc.nyc_taxi_preprocess(
            _read_nyc(session, files["nyc"])))
        df, sizes = api.criteo.pre_process(
            session, _read_criteo(api, session, files["criteo"]))
        out["criteo"][mode] = (_blocks(api, df), sizes)
    out["criteo_cats"] = list(api.criteo.CAT_COLS)
    mp.delenv("RDT_ETL_OPTIMIZER")
    mp.delenv("RDT_ETL_AQE")
    # the data plane, on the NYCTaxi features
    nyc = api.nyc.nyc_taxi_preprocess(_read_nyc(session, files["nyc"]))
    out["features"] = api.nyc.feature_columns(nyc)
    eager = api.data.from_frame(nyc)
    recoverable = api.data.from_frame_recoverable(nyc)
    out["from_frame"] = [b.combine_chunks() for b in eager.blocks()]
    out["from_frame_recoverable"] = [
        b.combine_chunks() for b in recoverable.blocks()]
    back = api.data.to_frame(eager, session).filter(
        api.col("passenger_count") >= 3)
    out["to_frame"] = _blocks(api, back)
    out["random_shuffle"] = [
        b.combine_chunks()
        for b in recoverable.random_shuffle(seed=7).blocks()]


def _proc_environ(pid: int) -> dict:
    raw = Path(f"/proc/{pid}/environ").read_bytes().split(b"\0")
    return dict(item.decode().split("=", 1) for item in raw if b"=" in item)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The seeded NYCTaxi CSV and Criteo TSV, written by the reference's
    generators."""
    tmp = tmp_path_factory.mktemp("etl")
    gen = _load(REPO / "examples" / "generate_nyctaxi.py", "ref_generate")
    criteo = _load(REPO / "examples" / "dlrm_criteo.py", "ref_dlrm_criteo")
    out = {"nyc": str(tmp / "nyctaxi.csv"), "criteo": str(tmp / "criteo.tsv")}
    gen.generate(NYC_ROWS, seed=SEED).to_csv(out["nyc"], index=False)
    criteo.generate_criteo(CRITEO_ROWS, out["criteo"], seed=SEED)
    return out


@pytest.fixture(scope="module")
def sides(files):
    """Both packages' results: the reference's session first, then the
    port's."""
    ref = _run_side("ref", files)
    return ref, _run_side("port", files)


def _sorted(tables):
    table = pa.concat_tables(tables).combine_chunks()
    if table.num_rows == 0:
        return table
    keys = [(name, "ascending") for name in table.column_names]
    return table.take(pc.sort_indices(table, sort_keys=keys))


def _assert_equal(got, want, blockwise: bool):
    """Exact equality: schema and values, block by block or sorted."""
    if blockwise:
        assert [b.num_rows for b in got] == [b.num_rows for b in want]
        for g, w in zip(got, want):
            assert g.schema.equals(w.schema), (g.schema, w.schema)
            assert g.equals(w)
    else:
        g, w = _sorted(got), _sorted(want)
        assert g.schema.equals(w.schema), (g.schema, w.schema)
        assert g.num_rows == w.num_rows and g.equals(w)
    assert sum(b.num_rows for b in got) > 0


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("query", list(QUERIES))
def test_operator_output_equals_the_reference(sides, query, mode):
    ref, port = sides
    got, got_events = port["queries"][query, mode]
    want, want_events = ref["queries"][query, mode]
    _assert_equal(got, want, QUERIES[query][1])
    assert got_events == want_events
    if query == "broadcast_join" and mode[1] == "1":
        # the small side replicates instead of shuffling
        assert any(e[1] for e in got_events), got_events


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_nyctaxi_preprocess_equals_the_reference(sides, mode):
    ref, port = sides
    _assert_equal(port["nyc"][mode], ref["nyc"][mode], blockwise=True)
    assert port["features"] == ref["features"] and len(port["features"]) == 25


def _assert_dense_ranks(ids: np.ndarray) -> np.ndarray:
    """``pre_process``'s dictionary: ids from 1 rank the kept categories by
    count, most frequent first (0 is rare or unseen). Returns the counts."""
    counts = np.bincount(ids)
    assert (counts[1:] > 0).all() and (np.diff(counts[1:]) <= 0).all()
    return counts


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_criteo_pre_process_equals_the_reference(sides, mode):
    """Equal exactly, except which id a category gets among categories of
    equal count: the reference orders those by the arrival order of its
    groupBy's partials and an unstable pandas sort, so two runs of the
    reference itself may swap them. Dense columns and labels are compared
    bit for bit; each categorical column must be the reference's under a
    one-to-one relabelling that keeps 0 and maps ids only to ids of the
    same count."""
    ref, port = sides
    got, got_sizes = port["criteo"][mode]
    want, want_sizes = ref["criteo"][mode]
    assert got_sizes == want_sizes and min(got_sizes) > 1
    assert [b.num_rows for b in got] == [b.num_rows for b in want]
    g, w = pa.concat_tables(got), pa.concat_tables(want)
    assert g.schema.equals(w.schema)
    cats = set(port["criteo_cats"])
    for name in g.column_names:
        if name not in cats:
            assert g[name].equals(w[name]), name
            continue
        gi = g[name].to_numpy()
        wi = w[name].to_numpy()
        gc, wc = _assert_dense_ranks(gi), _assert_dense_ranks(wi)
        pairs = set(zip(gi.tolist(), wi.tolist()))
        assert len(pairs) == len(set(gi.tolist())) == len(set(wi.tolist()))
        assert all((a == 0) == (b == 0) and gc[a] == wc[b] for a, b in pairs)


@pytest.mark.parametrize("conversion", ["from_frame", "from_frame_recoverable",
                                        "to_frame"])
def test_frame_conversions_equal_the_reference(sides, conversion):
    ref, port = sides
    _assert_equal(port[conversion], ref[conversion], blockwise=True)


def test_session_random_shuffle_is_byte_identical(sides):
    """The engine's shuffle (executor-side map and reduce with the same
    seeds) gives the reference's blocks, byte for byte, and is a
    permutation of the input rows."""
    ref, port = sides
    got, want = port["random_shuffle"], ref["random_shuffle"]
    _assert_equal(got, want, blockwise=True)
    for g, w in zip(got, want):
        assert _ipc(g) == _ipc(w)
    assert _sorted(got).equals(_sorted(port["from_frame_recoverable"]))
    assert not pa.concat_tables(got).equals(
        pa.concat_tables(port["from_frame_recoverable"]))


def _ipc(table) -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as writer:
        writer.write_table(table)
    return sink.getvalue().to_pybytes()


def test_executors_stay_off_the_card(sides):
    """Each ETL executor sees the driver's cards (a serving replica may
    load into it and serve on one) but loads no torch, and so no CUDA
    library: after a whole ETL, no executor holds a CUDA context."""
    _, port = sides
    assert len(port["executors"]) == SESSION["num_executors"]
    for environ, maps in zip(port["environ"], port["maps"]):
        assert environ.get("CUDA_VISIBLE_DEVICES") == \
            os.environ.get("CUDA_VISIBLE_DEVICES")
        assert "libtorch" not in maps and "libcuda" not in maps


def test_etl_modules_import_neither_torch_nor_jax():
    code = ("import sys, raydp_tpu_torch.etl, raydp_tpu_torch.context, "
            "raydp_tpu_torch.cluster, raydp_tpu_torch.examples."
            "nyctaxi_features, raydp_tpu_torch.examples.dlrm_criteo\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'raydp_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_generators_match_the_reference(tmp_path):
    """The port's copies of the example generators write the same rows."""
    from raydp_tpu_torch.examples import dlrm_criteo, generate_nyctaxi

    gen = _load(REPO / "examples" / "generate_nyctaxi.py", "ref_generate")
    criteo = _load(REPO / "examples" / "dlrm_criteo.py", "ref_dlrm_criteo")
    pd.testing.assert_frame_equal(generate_nyctaxi.generate(500, seed=4),
                                  gen.generate(500, seed=4))
    criteo.generate_criteo(300, str(tmp_path / "ref.tsv"), seed=4)
    dlrm_criteo.generate_criteo(300, str(tmp_path / "port.tsv"), seed=4)
    assert (tmp_path / "ref.tsv").read_bytes() == \
        (tmp_path / "port.tsv").read_bytes()
    for name in ("NUM_DENSE", "NUM_CAT", "LABEL", "DENSE_COLS", "CAT_COLS"):
        assert getattr(dlrm_criteo, name) == getattr(criteo, name)


def _port_frame(session, n=400, parts=4):
    from raydp_tpu_torch.etl.expressions import col

    return session.range(n, num_partitions=parts).withColumn(
        "x", col("id") * 2).withColumn("y", col("id") % 7)


def test_recoverable_block_survives_executor_crash():
    """As ``tests/test_data.py::test_recoverable_survives_executor_crash``:
    with the fetched refs dropped and every executor crashed, each block is
    fetched again, recomputed from its lineage recipe."""
    import raydp_tpu_torch
    from raydp_tpu_torch.data import from_frame_recoverable

    session = raydp_tpu_torch.init("pytest-lineage", **SESSION)
    try:
        ds = from_frame_recoverable(_port_frame(session))
        before = ds.to_arrow()
        for b in ds._blocks:
            b.ref = None
        for h in session.executors:
            try:
                h.call("crash")
            except Exception:  # noqa: BLE001 - the call dies with the process
                pass
        deadline = time.time() + 60
        after = None
        while time.time() < deadline:
            try:
                after = ds.to_arrow()
                break
            except Exception:  # noqa: BLE001 - executors still restarting
                time.sleep(0.5)
        assert before.num_rows == 400
        assert after is not None and after.equals(before)
    finally:
        raydp_tpu_torch.stop()


def test_dataset_blocks_survive_stop_without_cleanup():
    """As ``tests/test_data.py::test_dataset_ownership_survives_stop``:
    after ``transfer_to_master`` the blocks outlive the executors and
    ``stop(cleanup_data=False)``."""
    import raydp_tpu_torch
    from raydp_tpu_torch.data import from_frame_recoverable

    session = raydp_tpu_torch.init("pytest-own", num_executors=2,
                                   executor_cores=1, executor_memory="256MB")
    try:
        ds = from_frame_recoverable(_port_frame(session, n=200, parts=2))
        want = ds.to_arrow()
        ds.transfer_to_master()
        raydp_tpu_torch.stop(cleanup_data=False)
        assert raydp_tpu_torch.active_session() is not None
        assert ds.to_arrow().equals(want) and want.num_rows == 200
    finally:
        raydp_tpu_torch.stop(cleanup_data=True)
    assert raydp_tpu_torch.active_session() is None
