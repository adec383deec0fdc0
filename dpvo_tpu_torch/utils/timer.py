"""Timing utilities: port of ``dpvo_tpu/utils/timer.py`` (the reference's
``dpvo/utils.py`` Timer).

The JAX package blocks on its ``sync`` arrays at the end of the timed
region; here ``sync`` is a CUDA tensor or device, whose queued work the
timer waits for (``torch.cuda.synchronize``) before it reads the clock.
Anything else (None, a CPU tensor) needs no wait: CPU work is done when
the region ends.

A timer is a front for the port's recorder (``utils/trace.py``): while it
is on (``trace.enable()``), the region is also a span of the timer's name,
with the wait a ``wait.timer`` span inside it.
"""

from __future__ import annotations

import time
from contextlib import ContextDecorator

import torch

from dpvo_tpu_torch.utils import trace

all_times = {}


def _cuda_device(sync):
    if isinstance(sync, torch.Tensor):
        return sync.device if sync.is_cuda else None
    if isinstance(sync, (str, torch.device)):
        dev = torch.device(sync)
        return dev if dev.type == "cuda" else None
    return None


class Timer(ContextDecorator):
    """Context decorator: ``with Timer("BA", enabled=True, sync=x): ...``
    appends the region's wall milliseconds to ``all_times[name]`` and
    prints ``"{name} {ms:.03f}"``."""

    def __init__(self, name: str, enabled: bool = True, sync=None):
        self.name = name
        self.enabled = enabled
        self.sync = sync  # a tensor or device whose CUDA work the region waits for

    def __enter__(self):
        self._span = trace.span(self.name)
        self._span.__enter__()
        if self.enabled:
            self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            dev = _cuda_device(self.sync)
            if dev is not None:
                with trace.blocked("wait", "timer", dev):
                    torch.cuda.synchronize(dev)
            elapsed = (time.perf_counter() - self.start) * 1000.0
            all_times.setdefault(self.name, []).append(elapsed)
            print(f"{self.name} {elapsed:.03f}")
        self._span.__exit__(*exc)
        return False
