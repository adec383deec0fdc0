"""Milliseconds a frame of keyframing on the host: the self time of the
port's ``keyframe`` spans (the flow magnitudes and their fetch) and
``keyframe.decide`` spans (each decision applied: the cull, the buffer
shift, the retirement) in the window, over the frames tracked in it.
Nothing where the run recorded no spans."""

from bench_port.program_trace import self_ms


def read(ctx):
    spans = ctx.get("program_spans")
    if not spans or not ctx["frames"]:
        return None
    return self_ms(spans, {"keyframe", "keyframe.decide"}) / ctx["frames"]
