"""Kernels launched on the device a tracked frame: the kernels of the
profiled seconds (every kernel, copies and sets left out) over the frames
completed in them."""


def read(ctx):
    prof = ctx["profile"]
    if not prof or not prof["kernels"] or not ctx["profile_frames"]:
        return None
    return prof["kernels"] / ctx["profile_frames"]
