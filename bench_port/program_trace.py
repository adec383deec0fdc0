"""The port's own spans and counters in a run of a cell
(``dpvo_tpu_torch/utils/trace.py``): self times, sums over the frames,
and the device's idle time attributed to the host work behind it.

A span is any object with the recorder's fields: ``id``, ``parent`` (0 at
the top), ``name``, ``t0_ns``, ``t1_ns`` (``time.time_ns()``, the clock of
``torch.profiler``), ``request`` ((tracker, frame counter) in a frame
call, (tracker, "terminate") in a terminate, None elsewhere), ``attrs``
and ``counts``. A profiled segment is ``profile_window.summarize``'s dict
with ``trace_start_ns``, the profile's start on that clock: a device
operation of it ran from ``trace_start_ns + 1000 * start_us`` to
``trace_start_ns + 1000 * end_us``.

Self time: a span's duration less what its children cover. Idle
attribution: each idle interval of a segment (between the union of its
device operations, from the first start to the last end) is split over
the innermost span open over each part of it; a part in no span goes to
``OUTSIDE``.
"""

from __future__ import annotations

import heapq
from collections import defaultdict

OUTSIDE = "outside spans"


def in_frame(span) -> bool:
    """Whether the span belongs to a frame call (not a terminate)."""
    r = span.request
    return r is not None and r[1] != "terminate"


def self_times_ns(spans) -> dict:
    """Each span's id -> its duration less the union of its children's
    intervals within it."""
    kids = defaultdict(list)
    for s in spans:
        if s.parent:
            kids[s.parent].append((s.t0_ns, s.t1_ns))
    out = {}
    for s in spans:
        covered, end = 0, s.t0_ns
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, end), min(b, s.t1_ns)
            if b > a:
                covered += b - a
                end = b
        out[s.id] = (s.t1_ns - s.t0_ns) - covered
    return out


def self_ms(spans, names, frames_only: bool = False) -> float:
    """Milliseconds of self time of the spans named ``names``."""
    own = self_times_ns(spans)
    return sum(own[s.id] for s in spans
               if s.name in names and (in_frame(s) or not frames_only)) * 1e-6


def span_ms(spans, prefixes, frames_only: bool = False) -> float:
    """Milliseconds in the spans whose name starts with one of prefixes."""
    return sum(s.t1_ns - s.t0_ns for s in spans if s.name.startswith(tuple(prefixes))
               and (in_frame(s) or not frames_only)) * 1e-6


def counted(spans, prefix: str, frames_only: bool = False) -> int:
    """The counts named ``prefix``* made inside the spans."""
    return sum(n for s in spans if in_frame(s) or not frames_only
               for k, n in s.counts.items() if k.startswith(prefix))


def syncs_by_site(spans) -> dict:
    """The sync.* counts of frame calls by site, a frame call."""
    frames = sum(1 for s in spans if s.name == "frame")
    by = defaultdict(int)
    for s in spans:
        if in_frame(s):
            for k, n in s.counts.items():
                if k.startswith("sync."):
                    by[k] += n
    return {k: v / frames for k, v in sorted(by.items())} if frames else {}


def idle_intervals(segment) -> list:
    """The segment's device-idle intervals [(a_ns, b_ns)] on the host's clock."""
    ops = sorted(segment["ops"], key=lambda o: o[1])
    t = segment["trace_start_ns"]
    out = []
    if not ops:
        return out
    end = ops[0][2]
    for _, s, e in ops[1:]:
        if s > end:
            out.append((t + round(end * 1000), t + round(s * 1000)))
        end = max(end, e)
    return out


def innermost(spans) -> list:
    """[(a_ns, b_ns, name)]: the timeline of the innermost open span, in
    order (the open span that started last; a child starts after its
    parent, and its id is higher)."""
    events = sorted([(s.t0_ns, 1, s) for s in spans] + [(s.t1_ns, 0, s) for s in spans],
                    key=lambda e: (e[0], e[1], e[2].id))
    heap, closed, out = [], set(), []
    prev = None
    for t, is_open, s in events:
        while heap and heap[0][2] in closed:
            heapq.heappop(heap)
        if heap and prev is not None and t > prev:
            out.append((prev, t, heap[0][3]))
        prev = t
        if is_open:
            heapq.heappush(heap, (-s.t0_ns, -s.id, s.id, s.name))
        else:
            closed.add(s.id)
    return out


def attribute_idle(spans, segments) -> dict:
    """Seconds of device idle by the innermost span open over it
    (``OUTSIDE`` where none was)."""
    timeline = innermost(spans)
    out = defaultdict(float)
    for seg in segments:
        i = 0
        for a, b in idle_intervals(seg):
            left = b - a
            while i < len(timeline) and timeline[i][1] <= a:
                i += 1
            j = i
            while j < len(timeline) and timeline[j][0] < b:
                lo, hi = max(a, timeline[j][0]), min(b, timeline[j][1])
                if hi > lo:
                    out[timeline[j][2]] += (hi - lo) * 1e-9
                    left -= hi - lo
                j += 1
            out[OUTSIDE] += left * 1e-9
    return dict(out)


def idle_by_span(spans, segments, top: int = 10) -> list:
    """The ``top`` span names by the device-idle seconds in their self
    time, then ``OUTSIDE``: [[name, seconds], ...]."""
    idle = attribute_idle(spans, segments)
    outside = idle.pop(OUTSIDE, 0.0)
    return [[n, v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]] + [
        [OUTSIDE, outside]]


def named_share(spans, segments) -> float:
    """The share of the idle seconds that fell in spans other than a
    frame's own self time (None without idle time)."""
    idle = attribute_idle(spans, segments)
    total = sum(idle.values())
    if not total:
        return None
    return (total - idle.get(OUTSIDE, 0.0) - idle.get("frame", 0.0)) / total


def round_means(spans) -> dict:
    """The mean of each attribute of the global-BA rounds."""
    rounds = [s.attrs for s in spans if s.name == "gba.round"]
    if not rounds:
        return {}
    return {k: sum(r[k] for r in rounds) / len(rounds) for k in rounds[0]}
