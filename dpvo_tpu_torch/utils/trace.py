"""Spans and counters of the port, on the profiler's clock.

``span(name, **attrs)`` is a context manager. While the recorder is on
(``enable()``), each span is kept in memory as a ``Span``: its id, the id
of the span open around it on its thread (``parent``, 0 at the top), its
name, its start and end as ``time.time_ns()`` (the clock ``torch.profiler``
stamps its events on: ``trace_start_ns()`` of a profile plus an event's
microseconds), its ``request`` and its attributes, host ints only. A span
given ``request=`` (the tracker's frame, or its terminate) passes it on to
the spans inside it, so the spans of one frame share it. ``drain()``
returns the spans ended since the last drain and the counts made since,
and forgets the spans; ``disable()`` stops recording. While the recorder
is off, ``span`` returns one shared context that does nothing: no clock
read, no span object.

``count(name, n=1)`` adds n to the counter ``name`` in ``COUNTS``, on or
off (``kernels.LAUNCHES`` reads its ``launch.*`` counters). While the
recorder is on, the count is also added to the innermost open span's
``counts``. ``blocked(kind, site, device, n)`` is where the host waits
for the card: it counts n blocking operations as ``sync.<site>`` (none
where ``device`` is the CPU) and opens the span ``<kind>.<site>``
(``wait`` a fetch, ``upload`` a copy from pageable host memory) with that
count.

Nothing here reads a device value or waits for the card.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple

COUNTS: Dict[str, int] = {}

_on = False
_spans: List["Span"] = []
_ids = itertools.count(1)
_local = threading.local()   # .stack: the thread's open spans
_count_lock = threading.Lock()
_counts_at_drain: Dict[str, int] = {}


class Span(NamedTuple):
    id: int
    parent: int
    name: str
    t0_ns: int
    t1_ns: int
    request: object
    attrs: dict
    counts: dict


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "attrs", "counts", "id", "parent", "request", "t0")

    def __init__(self, name, attrs, counts=None):
        self.name = name
        self.request = attrs.pop("request", None)
        self.attrs = attrs
        self.counts = counts or {}

    def set(self, **attrs):
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].id if stack else 0
        if self.request is None and stack:
            self.request = stack[-1].request
        self.id = next(_ids)
        stack.append(self)
        for k, n in self.counts.items():
            _add(k, n)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _local.stack.pop()
        _spans.append(Span(self.id, self.parent, self.name, self.t0, t1, self.request,
                           self.attrs, self.counts))
        return False


class _Off:
    """The shared context of every span while the recorder is off."""

    __slots__ = ()

    def set(self, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, **attrs):
    if not _on:
        return _OFF
    return _Open(name, attrs)


def _add(name: str, n: int):
    with _count_lock:
        COUNTS[name] = COUNTS.get(name, 0) + n


def count(name: str, n: int = 1):
    """n more of ``name`` (thread-safe)."""
    if _on:
        stack = getattr(_local, "stack", None)
        if stack:
            c = stack[-1].counts
            c[name] = c.get(name, 0) + n
    _add(name, n)


def put(name: str, n: int):
    """Set the counter ``name`` to n."""
    with _count_lock:
        COUNTS[name] = n


def blocked(kind: str, site: str, device, n: int = 1):
    """The span ``<kind>.<site>`` around n operations that block the host
    on the card, counted as ``sync.<site>`` (while off too) where
    ``device``, the card's side of them, is a CUDA device: on the CPU
    nothing blocks."""
    if device.type != "cuda":
        n = 0
    if not _on:
        if n:
            _add("sync." + site, n)
        return _OFF
    return _Open(kind + "." + site, {}, {"sync." + site: n} if n else None)


def enable():
    """Record spans from now on."""
    global _on
    _counts_at_drain.clear()
    _counts_at_drain.update(COUNTS)
    _on = True


def disable():
    global _on
    _on = False


def drain():
    """(spans ended since the last drain or enable, in the order they
    ended; counts made since, by name); forgets the spans."""
    spans = _spans[:]
    del _spans[:len(spans)]
    with _count_lock:
        now = dict(COUNTS)
    counts = {k: v - _counts_at_drain.get(k, 0) for k, v in now.items()
              if v != _counts_at_drain.get(k, 0)}
    _counts_at_drain.clear()
    _counts_at_drain.update(now)
    return spans, counts
