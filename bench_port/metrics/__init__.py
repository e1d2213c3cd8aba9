"""One reader a metric, ``<metric>.py``, found by the metric's name:
``read(rec)`` takes the run's :class:`~bench_port.record.Record` and
returns the number, or None where the run has nothing to read."""
