"""Kept for the tests of ``tests/``, which import ``trace_start_ns`` from
here; a traced run is ``python3 bench_port/run.py ... --trace 1``."""

from bench_port.harness import trace_start_ns  # noqa: F401
