"""Milliseconds of a global-BA round's host sparsity build: the mean
self time of the port's ``gba.sparsity`` spans (``global_edge_set`` and
``build_sparse_indices``) over the window's rounds, in frames and
terminates. Nothing where the window ran no round or recorded no
spans."""

from bench_port.program_trace import self_times_ns


def read(ctx):
    spans = ctx.get("program_spans")
    if not spans:
        return None
    own = self_times_ns(spans)
    builds = [own[s.id] for s in spans if s.name == "gba.sparsity"]
    return sum(builds) / len(builds) * 1e-6 if builds else None
