"""CPU tests of the benchmark harness (``python -m pytest bench_port/tests``);
tests that need a card are marked ``cuda`` and skip without one."""
