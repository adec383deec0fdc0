"""The process's peak of allocated device memory in the window, GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30 if ctx["peak_bytes"] else None
