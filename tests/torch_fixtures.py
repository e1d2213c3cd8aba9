"""The port's counterparts of ``tests/conftest.py``'s ``runtime``,
``runtime_3nodes`` and ``session`` fixtures, with the same shapes: the
port's bare actor runtime, three virtual nodes (the third with an ``accel``
slot) and a 2-executor ETL session (1 core, 512MB each).

A twin of a reference test file imports the ones it takes by name, which
shadows conftest's for that file only::

    from tests.torch_fixtures import session  # noqa: F401

Each is torn down after its test, so a port runtime never runs at the same
time as one of the reference's in the same process.
"""

import pytest


@pytest.fixture
def runtime():
    """A bare actor runtime of the port (no ETL session)."""
    from raydp_tpu_torch.runtime import init_runtime, shutdown_runtime

    rt = init_runtime()
    yield rt
    shutdown_runtime()


@pytest.fixture
def runtime_3nodes():
    """Three virtual nodes of the port's runtime for placement and fault
    tests."""
    from raydp_tpu_torch.runtime import init_runtime, shutdown_runtime

    rt = init_runtime(virtual_nodes=[
        {"CPU": 4.0, "memory": float(2 << 30)},
        {"CPU": 4.0, "memory": float(2 << 30)},
        {"CPU": 4.0, "memory": float(2 << 30), "accel": 1.0},
    ])
    yield rt
    shutdown_runtime()


@pytest.fixture
def session():
    """A 2-executor ETL session of the port."""
    import raydp_tpu_torch

    s = raydp_tpu_torch.init("pytest", num_executors=2, executor_cores=1,
                             executor_memory="512MB")
    yield s
    raydp_tpu_torch.stop()
