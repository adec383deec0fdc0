"""Milliseconds a frame of the tracker's host topology work: the self
time of the port's ``topology`` spans in the window (``add_frame``, the
new edges, the depth cap, append and retire with their compaction, each
round's edge-set build; frames and terminates), over the frames tracked
in it. Read from the recorder's spans (``program_spans``); nothing where
the run recorded none."""

from bench_port.program_trace import self_ms


def read(ctx):
    spans = ctx.get("program_spans")
    if not spans or not ctx["frames"]:
        return None
    return self_ms(spans, {"topology"}) / ctx["frames"]
