"""Frames tracked in the window over its seconds on the wall clock:
whole sequences, each tracker's construction and ``terminate()`` inside."""


def read(ctx):
    return ctx["frames"] / ctx["window_s"] if ctx["frames"] else None
