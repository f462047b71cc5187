"""One reader a metric: ``read(record)`` returns the metric's value from
a run's record (``run.Record``), or None where it finds nothing to read."""
