"""Milliseconds of a sequence's ``DPVO.terminate()``: the mean duration
of the port's ``terminate`` spans in the window (its pending decisions,
a last loop proposal, 12 update rounds and the pose fetch). Nothing where
the run recorded no spans."""


def read(ctx):
    spans = ctx.get("program_spans")
    if not spans:
        return None
    ends = [s.t1_ns - s.t0_ns for s in spans if s.name == "terminate"]
    return sum(ends) / len(ends) * 1e-6 if ends else None
