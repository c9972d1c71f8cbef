"""Per-layer metric readers, one file each, named as the metric.  Each
exposes ``read(obs) -> float | None``: ``obs`` is what the driver recorded
in a ``--trace 1`` run, as the program and the profiler recorded it (see
``portbench/drivers/analyze_stream.py``); ``None`` when there is nothing to
read, and the harness then leaves the metric out of the line."""
