"""The traced run's device profile: ``torch.profiler`` with CUDA activity
alone (no CPU events: recording them slows the host that paces the
frames) over a few seconds of the window's frames from near its end, a
segment a sequence, summarized in memory.

The summary holds every device operation (kernel, copy, set) as (name,
start us, end us) on the profiler's one clock, which all streams of the
process share; ``busy_s`` is the length of the union of their intervals
and ``window_s`` the span from the first start to the last end;
``trace_start_ns`` is the profile's start on the host's clock
(``time.time_ns()``), where the port's spans lie
(``program_trace.py``).
"""

from __future__ import annotations

import torch

_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def start():
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def _device_events(prof):
    """(name, start us, end us) of each device operation of the profile."""
    out = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out.append((ev.name, float(ev.time_range.start), float(ev.time_range.end)))
    return out


def summarize(prof) -> dict:
    from bench_port.harness import trace_start_ns

    ops = sorted(_device_events(prof), key=lambda o: o[1])
    t0 = trace_start_ns(prof)
    if not ops:
        return dict(ops=[], kernels=0, busy_s=0.0, window_s=0.0, gaps=[], trace_start_ns=t0)
    busy, gaps = 0.0, []
    cur_s, cur_e, cur_name = ops[0][1], ops[0][2], ops[0][0]
    for name, s, e in ops[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, cur_name))
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
        if e >= cur_e:
            cur_name = name
    busy += cur_e - cur_s
    window = max(e for _, _, e in ops) - ops[0][1]
    return dict(ops=ops, kernels=sum(1 for o in ops if not o[0].startswith(_NOT_KERNELS)),
                busy_s=busy * 1e-6, window_s=window * 1e-6, gaps=gaps, trace_start_ns=t0)


def device_time_s(summary: dict, substrings) -> float:
    """Seconds of the operations whose name holds one of substrings."""
    return sum(e - s for n, s, e in summary["ops"] if any(x in n for x in substrings)) * 1e-6


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the operation that ran last before it."""
    by_name = {}
    for n, s, e in summary["ops"]:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["gaps"], key=lambda g: -g[0])[:top]
    return {"device_ops": [[n[:120], v] for n, v in ops],
            "idle_gaps": [[f"after {n[:110]}", g * 1e-6] for g, n in gaps]}


def combine(summaries) -> dict:
    """One summary of several profiled segments (a segment a sequence)."""
    return dict(ops=[o for s in summaries for o in s["ops"]],
                kernels=sum(s["kernels"] for s in summaries),
                busy_s=sum(s["busy_s"] for s in summaries),
                window_s=sum(s["window_s"] for s in summaries),
                gaps=[g for s in summaries for g in s["gaps"]])
