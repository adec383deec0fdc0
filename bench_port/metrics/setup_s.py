"""Seconds from the process's start to the window's opening: the kernel
build (the first run in a checkout), the sequences, the weights, the
trackers' warm-up."""


def read(ctx):
    return ctx["setup_s"]
