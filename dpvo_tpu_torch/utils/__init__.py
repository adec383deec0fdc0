"""See the package docstring of dpvo_tpu_torch. ``Timer`` is exported here
as in the JAX package, imported on first use: the reader and viewer
processes import this package's numpy modules and no torch."""


def __getattr__(name):
    if name == "Timer":
        from dpvo_tpu_torch.utils.timer import Timer
        return Timer
    raise AttributeError(f"module 'dpvo_tpu_torch.utils' has no attribute {name!r}")
