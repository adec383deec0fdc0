"""One run of a cell with the port's recorder (``dpvo_tpu_torch/utils/trace.py``)
on over the window, and the metrics read from its spans and counters.

    python3 bench_port/trace_run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1> [--recorder 0|1]

Runs ``run.run_cell`` as ``run.py`` does. Around ``StreamRun.run`` (the
window) it turns the recorder on and drains it; with ``--trace 1`` each
profiled segment also keeps its profile's start on the host's clock
(``trace_start_ns``), so the device's idle time can be laid on the spans.
The last line of standard output is an object: the run's result, the
window's ``frames_per_s``, the program metrics (``host_topology_ms``,
``keyframe_ms``, ``host_wait_ms``, ``syncs_per_frame``,
``gba_sparsity_ms``, ``terminate_ms``: ``metrics/<name>.py``),
``idle_by_span`` and the share of idle time in named spans
(``program_trace.py``), and the global-BA rounds' mean attributes. With
``--recorder 0`` the recorder stays off (its cost: the frames/s of the
two). ``--dump PATH`` writes the spans and the profiled idle intervals
there as JSON. A port without the recorder exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench_port":
    sys.path[0] = str(ROOT)

PROGRAM_METRICS = ("host_topology_ms", "keyframe_ms", "host_wait_ms", "syncs_per_frame",
                   "gba_sparsity_ms", "terminate_ms")


def trace_start_ns(prof) -> int:
    """A stopped profile's start on the host's clock."""
    res = prof.profiler.kineto_results
    if hasattr(res, "trace_start_ns"):
        return int(res.trace_start_ns())
    return int(res.trace_start_us()) * 1000


def traced_cell(workload: str, seed: int, seconds: float, trace: bool, recorder: bool = True,
                device=None, root: Path = ROOT, log=print, tracker=None, dump=None) -> dict:
    from bench_port import profile_window, program_trace, run, window
    from dpvo_tpu_torch.utils import trace as recorder_mod

    got = dict(spans=None, counts=None, segments=[], frames=0, window_s=0.0)
    real_run, real_summarize = window.StreamRun.run, profile_window.summarize

    def run_window(stream, secs):
        if recorder:
            recorder_mod.enable()
        try:
            real_run(stream, secs)
        finally:
            if recorder:
                got["spans"], got["counts"] = recorder_mod.drain()
                recorder_mod.disable()
        got["frames"], got["window_s"] = len(stream.latencies), stream.window_s

    def summarize(prof):
        out = real_summarize(prof)
        out["trace_start_ns"] = trace_start_ns(prof)
        got["segments"].append(out)
        return out

    window.StreamRun.run, profile_window.summarize = run_window, summarize
    try:
        result = run.run_cell(workload, seed, seconds, trace, device=device, root=root,
                              log=log, tracker=tracker)
    finally:
        window.StreamRun.run, profile_window.summarize = real_run, real_summarize
    spans = got["spans"]
    ctx = dict(frames=got["frames"], program_spans=spans, program_counts=got["counts"])
    program = {}
    for name in PROGRAM_METRICS:
        v = run.read_metric(root, name, ctx)
        if v is not None:
            program[name] = v
    out = dict(result=result, recorder=recorder, trace=trace,
               frames_per_s=got["frames"] / got["window_s"] if got["window_s"] else None,
               frames=got["frames"], window_s=got["window_s"], program=program)
    if spans:
        out["spans"] = len(spans)
        out["gba_round_means"] = program_trace.round_means(spans)
        out["syncs_by_site"] = program_trace.syncs_by_site(spans)
        if got["segments"]:
            out["idle_by_span"] = program_trace.idle_by_span(spans, got["segments"])
            out["idle_named_share"] = program_trace.named_share(spans, got["segments"])
            log(f"device idle in named spans: {out['idle_named_share']}; idle by span "
                f"{out['idle_by_span']}")
        log(f"global-BA round means {out['gba_round_means']}")
        if dump:
            Path(dump).write_text(json.dumps(dict(
                spans=[list(s) for s in spans],
                idle=[program_trace.idle_intervals(g) for g in got["segments"]])))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "runs" / "cache" / "cuda"))
    from bench_port.run import NoCard

    err = lambda s: print(s, file=sys.stderr, flush=True)
    try:
        import dpvo_tpu_torch.utils.trace  # noqa: F401
    except ImportError:
        err("no result: the port has no recorder (dpvo_tpu_torch/utils/trace.py)")
        return 5
    try:
        out = traced_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          bool(args.recorder), log=err, dump=args.dump)
    except NoCard as e:
        err(f"no result: {e}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
