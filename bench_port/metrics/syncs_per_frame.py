"""Host-device synchronizations a frame call: the port's ``sync.*``
counts made inside spans of frame requests (each blocking fetch and each
blocking copy from pageable memory counts one), over the frames tracked
in the window. Nothing where the run recorded no spans."""

from bench_port.program_trace import counted


def read(ctx):
    spans = ctx.get("program_spans")
    if not spans or not ctx["frames"]:
        return None
    return counted(spans, "sync.", frames_only=True) / ctx["frames"]
