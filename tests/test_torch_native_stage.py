"""Native host-feed staging kernel: output parity with the numpy decode path
across dtypes, chunking, offsets, and the fallback conditions.

The kernel (csrc/feed/stage.cpp via raydp_tpu_torch/native/stage.py) replaces the
astype+np.stack double pass in ``feed._as_numpy``; these tests pin the two
paths byte-identical so the fast path can never silently change training
inputs.

The port's twin of ``tests/test_native_stage.py``: its cases, data, sizes
and assertions, run against ``raydp_tpu_torch``, whose copies of these
planes they guard against drift.
"""

import numpy as np
import pyarrow as pa
import pytest

from raydp_tpu_torch.native.stage import native_stage_available, stage_table


def _numpy_path(table, columns, dtype):
    return np.stack(
        [table.column(c).to_numpy(zero_copy_only=False).astype(dtype,
                                                               copy=False)
         for c in columns], axis=1)


needs_native = pytest.mark.skipif(not native_stage_available(),
                                  reason="native toolchain unavailable")


@needs_native
@pytest.mark.parametrize("dst", [np.float32, np.float64])
def test_stage_parity_mixed_source_dtypes(dst):
    rng = np.random.RandomState(0)
    table = pa.table({
        "f64": rng.randn(777),
        "f32": rng.randn(777).astype(np.float32),
        "i64": rng.randint(-1000, 1000, 777),
        "i32": rng.randint(-1000, 1000, 777).astype(np.int32),
        "u8": rng.randint(0, 255, 777).astype(np.uint8),
        "i16": rng.randint(-300, 300, 777).astype(np.int16),
    })
    cols = ["f64", "f32", "i64", "i32", "u8", "i16"]
    out = stage_table(table, cols, np.dtype(dst))
    assert out is not None and out.dtype == np.dtype(dst)
    np.testing.assert_array_equal(out, _numpy_path(table, cols, dst))


@needs_native
@pytest.mark.parametrize("dst", [np.int32, np.int64])
def test_stage_parity_int_sources_to_int(dst):
    """Integer→integer pairs stay on the kernel (float sources to an int dst
    are declined — see test_stage_declines_float_to_int_pairs)."""
    rng = np.random.RandomState(0)
    table = pa.table({
        "i64": rng.randint(-1000, 1000, 777),
        "i32": rng.randint(-1000, 1000, 777).astype(np.int32),
        "u8": rng.randint(0, 255, 777).astype(np.uint8),
        "i16": rng.randint(-300, 300, 777).astype(np.int16),
    })
    cols = ["i64", "i32", "u8", "i16"]
    out = stage_table(table, cols, np.dtype(dst))
    assert out is not None and out.dtype == np.dtype(dst)
    np.testing.assert_array_equal(out, _numpy_path(table, cols, dst))


@needs_native
def test_stage_parity_chunked_and_sliced():
    """Multi-chunk columns (uneven chunking per column) and non-zero array
    offsets (a sliced table) hit the per-chunk path."""
    a = np.arange(100, dtype=np.float64)
    b = np.arange(100, dtype=np.int64) * 3
    table = pa.table({
        "a": pa.chunked_array([a[:30], a[30:]]),
        "b": pa.chunked_array([b[:50], b[50:80], b[80:]]),
    })
    out = stage_table(table, ["a", "b"], np.dtype(np.float32))
    np.testing.assert_array_equal(
        out, _numpy_path(table, ["a", "b"], np.float32))

    sliced = table.slice(17, 41)   # chunks carry offsets now
    out = stage_table(sliced, ["a", "b"], np.dtype(np.float32))
    assert out is not None
    np.testing.assert_array_equal(
        out, _numpy_path(sliced, ["a", "b"], np.float32))


@needs_native
def test_stage_declines_ineligible_columns():
    withnull = pa.table({"a": pa.array([1.0, None, 3.0]),
                         "b": pa.array([1.0, 2.0, 3.0])})
    assert stage_table(withnull, ["a", "b"], np.dtype(np.float32)) is None

    strings = pa.table({"a": pa.array(["x", "y"]),
                        "b": pa.array([1.0, 2.0])})
    assert stage_table(strings, ["a", "b"], np.dtype(np.float32)) is None

    one = pa.table({"a": pa.array([1.0, 2.0])})
    assert stage_table(one, ["a"], np.dtype(np.float32)) is None  # numpy wins

    ints = pa.table({"a": pa.array([1, 2]), "b": pa.array([3, 4])})
    assert stage_table(ints, ["a", "b"], np.dtype(np.float16)) is None


@needs_native
def test_stage_declines_float_to_int_pairs():
    """float→int static_cast is UB in C++ for NaN/out-of-range
    values while numpy's astype is (different) platform-defined behavior —
    the byte-parity contract cannot hold, so the kernel declines the pair
    and the feed silently falls back to numpy."""
    rng = np.random.RandomState(3)
    table = pa.table({"a": rng.randn(64), "b": rng.randn(64)})
    assert stage_table(table, ["a", "b"], np.dtype(np.int32)) is None
    assert stage_table(table, ["a", "b"], np.dtype(np.int64)) is None

    # one float source among ints declines the whole table (the numpy path
    # redoes the full decode anyway)
    mixed = pa.table({"a": pa.array([1.0, 2.0]), "b": pa.array([3, 4])})
    assert stage_table(mixed, ["a", "b"], np.dtype(np.int64)) is None

    # int→int and float→float pairs stay on the kernel
    ints = pa.table({"a": pa.array([1, 2]), "b": pa.array([3, 4])})
    assert stage_table(ints, ["a", "b"], np.dtype(np.int32)) is not None
    assert stage_table(table, ["a", "b"], np.dtype(np.float32)) is not None

    # the feed-level contract: _as_numpy still produces the numpy answer
    from raydp_tpu_torch.data.feed import _as_numpy

    got = _as_numpy(table, ("a", "b"), np.int32)
    np.testing.assert_array_equal(
        got, _numpy_path(table, ["a", "b"], np.int32))


@needs_native
def test_stage_threads_parity(monkeypatch):
    monkeypatch.setenv("RDT_STAGE_THREADS", "3")
    rng = np.random.RandomState(1)
    table = pa.table({f"c{i}": rng.randn(501) for i in range(7)})
    cols = [f"c{i}" for i in range(7)]
    out = stage_table(table, cols, np.dtype(np.float32))
    np.testing.assert_array_equal(out, _numpy_path(table, cols, np.float32))


def test_as_numpy_uses_native_path_when_available():
    """feed._as_numpy output is identical whether or not the kernel engages
    (the integration contract: silent fallback, same bytes)."""
    from raydp_tpu_torch.data.feed import _as_numpy

    rng = np.random.RandomState(2)
    table = pa.table({"x": rng.randn(64), "y": rng.randn(64),
                      "z": rng.randint(0, 9, 64)})
    got = _as_numpy(table, ("x", "y", "z"), np.float32)
    np.testing.assert_array_equal(
        got, _numpy_path(table, ["x", "y", "z"], np.float32))
    # single column keeps the 1-D contract
    assert _as_numpy(table, ("x",), np.float32).shape == (64,)
