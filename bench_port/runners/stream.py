"""The runner of the camera-stream cells (a configuration without a
``runner`` key): ``window.StreamRun`` tracks the traffic's sequences with
the port's ``DPVO``, and ``judge.py`` decides ``correct``.

Set-up builds the port's kernels once (``dpvo_tpu_torch/_build/``), makes
the cell's sequences from the seed, loads the weights and warms the
stream up; the stream then tracks whole sequences, each tracker's
construction, frames and ``terminate()``, until ``seconds`` of the wall
clock have passed (``window.py``). Once the window has closed and the peak
memory is read, the trackers are freed and the plain reference makes each
checked call again (``judge.py``).

With ``trace`` the port's recorder (``dpvo_tpu_torch/utils/trace.py``)
is on over the window: its spans and counts go to the readers as
``program_spans`` and ``program_counts``, and the device's idle seconds of the profiled frames, laid on
the spans (``program_trace.idle_by_span``), go into the breakdown. An
untraced run leaves the recorder off (both None).

``calibrate`` gives the readings that the limits of ``correct`` are set
from (``calibrate.py``): the sequences are tracked without the window's
clock, since a tracker's calls and their results do not depend on the
timing, so a check reads there what it reads in a run with the same seed.
"""

from __future__ import annotations

import contextlib
import math
import time


def run(cell, config, traffic, seed, seconds, trace, device, root, log, started,
        tracker=None) -> dict:
    """``tracker(config, weights, device, seq)``: what tracks in the port's
    place (the tests' control and faults); the port's ``DPVO`` by default."""
    import numpy as np
    import torch

    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.runtime.dpvo import DPVO
    from dpvo_tpu_torch.runtime.weights import load_npz

    from bench_port import harness, judge, profile_window, program_trace, window
    from bench_port.run import load_module
    from bench_port.stats import sub_seed

    cuda = device.type == "cuda"
    phases = {"imports": time.perf_counter() - started}
    if cuda:
        kernels.build()
    phases["kernel build"] = time.perf_counter() - started
    cfg = Config(**config["config"])
    ht, wd = config["ht"], config["wd"]
    weights = load_npz(str(root / config["weights"])) if config.get("weights") else None
    gen = load_module(root, "traffic", traffic["kind"])
    K = cfg.PATCHES_PER_FRAME * (3 if cfg.CENTROID_SEL_STRAT == "GRADIENT_BIAS" else 1)
    seqs = gen.make_sequences(traffic, seed, ht, wd, cfg.RES, K, cfg.PATCHES_PER_FRAME, device)
    phases["weights, sequences"] = time.perf_counter() - started

    probe = harness.Probe()
    probes = harness.probed(probe) if trace and cuda else contextlib.nullcontext()
    recorder = None
    if trace:
        from dpvo_tpu_torch.utils import trace as recorder
    with probes:
        if tracker is None:
            make = lambda seq: DPVO(cfg, weights, ht, wd, device=device, draws=seq.draws)
        else:
            make = lambda seq: tracker(config, weights, device, seq)
        smi = lambda: log(f"nvidia-smi utilization.gpu before the profiled seconds: "
                          f"{harness.smi_utilization()} %")
        stream = window.StreamRun(seqs, make, device, trace, probe,
                                  window.plan_checks(traffic.get("checks", []),
                                                     sub_seed(seed, 0xC4EC), traffic["frames"]),
                                  traffic["warm_frames"],
                                  traffic["profile_seconds"] if trace else 0.0, smi)
        stream.warm()
        phases["warm-up"] = time.perf_counter() - started
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - started
        log("set-up, seconds from the start to the end of each phase: "
            + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
        spans = counts = None
        if recorder is not None:
            recorder.enable()
        try:
            stream.run(seconds)
        finally:
            if recorder is not None:
                spans, counts = recorder.drain()
                recorder.disable()
        if cuda:
            torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    summary = profile_window.combine(stream.profiles) if stream.profiles else None

    lat = stream.latencies
    frames = len(lat)
    spans_ms = {k: [a.elapsed_time(b) for a, b in stream.spans[k]] for k in window.LAYERS}
    ctx = dict(frames=frames, window_s=stream.window_s, latencies_ms=[x * 1e3 for x in lat],
               setup_s=setup_s, peak_bytes=peak, spans_ms=spans_ms,
               gba_round_ms=[x * 1e3 for x in stream.gba_host_s], profile=summary,
               profile_frames=stream.profiled_frames, corr_calls=list(probe.corr),
               segsum_calls=list(probe.segsum), edge_rounds=list(stream.edge_rounds),
               patchifies=stream.patchifies, config=config["config"], ht=ht, wd=wd,
               program_spans=spans, program_counts=counts)
    checks = stream.checks
    expected = len(checks)
    q = np.percentile(np.asarray(lat) * 1e3, [50, 90, 95, 99, 100]) if lat else [np.nan] * 5
    log(f"frames {frames} in a window of {stream.window_s:.3f} s; latency ms median {q[0]:.3f} "
        f"p90 {q[1]:.3f} p95 {q[2]:.3f} p99 {q[3]:.3f} max {q[4]:.3f}, samples {len(lat)}; "
        f"sequences terminated {stream.sequences}; setup {setup_s:.3f} s; "
        f"peak {peak} bytes")
    breakdown = {}
    if trace:
        log(f"global-BA rounds in the window {len(ctx['gba_round_ms'])}; profiled frames "
            f"{ctx['profile_frames']}")
        if spans:
            log(f"the port's spans {len(spans)}; syncs a frame call by site "
                f"{program_trace.syncs_by_site(spans)}; global-BA round means "
                f"{program_trace.round_means(spans)}")
            if stream.profiles:
                breakdown["idle_by_span"] = program_trace.idle_by_span(spans, stream.profiles,
                                                                       top=9)
                log(f"device idle by span {breakdown['idle_by_span']}; share in named spans "
                    f"{program_trace.named_share(spans, stream.profiles)}")
    del stream, make
    if cuda:
        torch.cuda.empty_cache()
    rows = judge.judge(checks, seqs, config["config"], weights, ht, wd, device)
    for r in rows:
        log("check " + " ".join(f"{k}={v}" for k, v in r.items()))
    correct, numbers = judge.verdict(rows, config.get("limits", {}), expected)
    return dict(ctx=ctx, attempted=frames, failed=0, correct=correct, checks=numbers,
                profile=summary, breakdown=breakdown)


def stream_checks(config: dict, traffic: dict, seed: int, device, root):
    """(weights, sequences, checks): the sequences up to the last one the
    checks take, tracked by the program with the checks taken, as in a
    run."""
    import torch

    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.runtime.dpvo import DPVO
    from dpvo_tpu_torch.runtime.weights import load_npz

    from bench_port import window
    from bench_port.harness import Probe
    from bench_port.run import load_module
    from bench_port.stats import sub_seed

    cfg = Config(**config["config"])
    ht, wd = config["ht"], config["wd"]
    weights = load_npz(str(root / config["weights"])) if config.get("weights") else None
    gen = load_module(root, "traffic", traffic["kind"])
    K = cfg.PATCHES_PER_FRAME * (3 if cfg.CENTROID_SEL_STRAT == "GRADIENT_BIAS" else 1)
    seqs = gen.make_sequences(traffic, seed, ht, wd, cfg.RES, K, cfg.PATCHES_PER_FRAME, device)
    plan = window.plan_checks(traffic.get("checks", []), sub_seed(seed, 0xC4EC),
                              traffic["frames"])
    run = window.StreamRun(seqs, None, device, False, Probe(), plan, 0)
    for q in range(max((c.seq for c in plan), default=-1) + 1):
        slam = DPVO(cfg, weights, ht, wd, device=device, draws=seqs[q].draws)
        run.instrument(slam)
        with run._ctx():
            run._track(slam, seqs[q], q, 0, 0.0, math.inf)
            run._sync()
        run.release(slam)
        del slam
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return weights, seqs, plan


def control_rows(checks, seqs, config, weights, device):
    """The control's numbers: for each done check, the fp8 reference's
    call against the f32 reference's."""
    import torch

    from bench_port import judge, window
    from bench_port.reference.config import Config as RefConfig
    from bench_port.reference.runtime.dpvo import DPVO as RefDPVO

    rows = []
    ht, wd = config["ht"], config["wd"]
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for c in checks:
            if not c.done:
                continue
            seq = seqs[c.seq]
            with torch.no_grad():
                low = RefDPVO(RefConfig(**config["config"]), weights, ht, wd, device,
                              draws=seq.draws, precision="fp8")
                low.load_state(c.before, lambda f: seq.frames[f])
                low(c.frame, seq.frames[c.frame], seq.intrinsics)
                ctl = window.Check(c.kind, c.seq, c.t, c.frame, c.before, window.snapshot(low),
                                   tuple(low.mid[k].cpu() for k in ("fmap", "gmap", "imap")),
                                   True, list(low.kf_mags))
                del low
                rows.append(dict(seq=c.seq, kind=c.kind, frame=c.frame, **judge.run_reference(
                    ctl, seq, config["config"], weights, ht, wd, device)))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return rows


def calibrate(config: dict, traffic: dict, seeds, control_seeds, fault_seeds, device, root,
              emit) -> dict:
    """For each seed, the program's checks (``judge.judge``) and, on
    ``control_seeds``, the control's (``control_rows``), each against the
    f32 reference; ``emit`` takes one dict a (seed, side, check). A run's
    number is its largest over the checks; returns the program's largest
    run and the control's smallest. The stream's faults are the CPU
    tests' (``fault_seeds`` is not used)."""
    from bench_port import judge

    runs = {"program": [], "control": []}
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        weights, seqs, checks = stream_checks(config, traffic, seed, device, root)
        sides = []
        if seed in seeds:
            sides.append(("program", judge.judge(checks, seqs, config["config"], weights,
                                                 config["ht"], config["wd"], device)))
        if seed in control_seeds:
            sides.append(("control", control_rows(checks, seqs, config, weights, device)))
        for side, rows in sides:
            for r in rows:
                emit(dict(seed=seed, side=side, **r))
            runs[side].append({k: max((r[k] for r in rows), default=math.nan)
                               for k in judge.NUMBERS})
        emit(dict(seed=seed, seconds=time.perf_counter() - t0))
    return {"program": {k: max((r[k] for r in runs["program"]), default=None)
                        for k in judge.NUMBERS},
            "control": {k: min((r[k] for r in runs["control"]), default=None)
                        for k in judge.NUMBERS}}
