"""Milliseconds a frame in the tracker's ``edge_forward`` step: CUDA event
pairs on the stream around each call in the window (frames and
terminates), summed, over the frames tracked in it."""


def read(ctx):
    spans = ctx["spans_ms"]["edge_forward"]
    return sum(spans) / ctx["frames"] if spans and ctx["frames"] else None
