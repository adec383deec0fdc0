"""Milliseconds of a global-BA round (``DPVO._run_global_ba``), in a
frame or in a ``terminate()``: the host clock around the round, ending in
its stream's sync, so the host's sparsity build is in it; the mean over
the window's rounds. The rounds are inside the window's seconds, most of
them in the terminates, so a shorter round raises frames_per_s."""


def read(ctx):
    r = ctx["gba_round_ms"]
    return sum(r) / len(r) if r else None
