"""Metric readers, one file a metric: ``read(run) -> number | None`` (None:
nothing to read in this run, and the metric is left out of the line)."""
