"""``frames_per_s`` as a traced run reads it: frames tracked in the
window over its seconds on the wall clock, with the event pairs, the
port's recorder and the profiled seconds on. Per layer where the host's
speed moves the untraced rate more than a bound can hold."""


def read(ctx):
    return ctx["frames"] / ctx["window_s"] if ctx["frames"] else None
