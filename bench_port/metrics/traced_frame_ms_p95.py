"""``frame_ms_p95`` as a traced run reads it: the 95th percentile of
every frame's latency in the window (host clock, from the call to the
end of its stream's sync), with the event pairs, the port's recorder and
the profiled seconds on."""

from bench_port.stats import percentile


def read(ctx):
    lat = ctx["latencies_ms"]
    return percentile(lat, 95) if lat else None
