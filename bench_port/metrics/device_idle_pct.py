"""The share of the profiled seconds in which no operation of any stream
ran on the device (the union of their intervals on the profiler's one
clock)."""


def read(ctx):
    prof = ctx["profile"]
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
