"""Milliseconds a frame in the tracker's ``window_ba`` step: CUDA event
pairs on the stream around each call in the window (frames and
terminates), summed, over the frames tracked in it."""


def read(ctx):
    spans = ctx["spans_ms"]["window_ba"]
    return sum(spans) / ctx["frames"] if spans and ctx["frames"] else None
