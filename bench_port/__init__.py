"""The benchmark of ``raydp_tpu_torch``, the PyTorch and CUDA port.

``python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
its result as the last line of standard output. Everything a cell needs is
found by name: its configuration in ``configs/<config>.json``, its traffic
mix in ``traffic/<mix>.json`` and the rows' kind in ``traffic/<data>.py``,
the program's model builder and the step's counts in ``models/<model>.py``,
the plain reference in ``reference/<model>.py``, the optimizer in
``optimizers/<name>.py``, each metric's reader in ``metrics/<metric>.py``
and the cell's correctness limits in ``limits/<cell>.json``. Nothing here
imports JAX or the JAX package.
"""
