"""Milliseconds a frame that the host spends blocked on the card in
frame calls: the port's ``wait.*`` (fetches) and ``upload.*`` (copies
from pageable host memory) spans whose request is a frame, over the
frames tracked in the window. Nothing where the run recorded no spans."""

from bench_port.program_trace import span_ms


def read(ctx):
    spans = ctx.get("program_spans")
    if not spans or not ctx["frames"]:
        return None
    return span_ms(spans, ("wait.", "upload."), frames_only=True) / ctx["frames"]
