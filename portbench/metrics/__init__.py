"""One reader per metric, found by the metric's name: ``read(run)`` gives
the metric's value from the run's host spans, counters and device trace,
or None where the run holds nothing to read."""
