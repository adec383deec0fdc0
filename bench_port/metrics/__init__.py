"""One reader a metric: ``metrics/<name>.py`` defines ``read(ctx)``,
which returns the metric's value from the run's context (``run.py``), or
None where the run left it nothing to read."""
