"""Per-layer metric readers, one file each, found by the metric's name in
``BENCHMARK.json``: ``read(run)`` returns the metric's value, or None
where the run has nothing to read for it (the harness then leaves the
metric out of the line)."""
