"""Metric readers, one file a metric, named as the metric is in
``BENCHMARK.json``: each defines ``read(record)`` (``harness.Record``)
and returns the value, or None where the run holds nothing to read."""
