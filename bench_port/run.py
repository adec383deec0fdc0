"""One run of one cell of ``BENCHMARK.json`` on one card.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the port's kernels once (``dpvo_tpu_torch/_build/``), makes
the cell's sequences from the seed, loads the weights and warms the
stream up; the stream then tracks whole sequences, each tracker's
construction, frames and ``terminate()``, until ``--seconds`` of the wall
clock have passed (``window.py``). Once the window has closed and the peak memory is read,
the trackers are freed and the plain reference makes each checked call
again (``judge.py``). The last line of standard output is the result: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each read by ``metrics/<name>.py``. Without a card,
with fewer cards than the cell asks for, or with JAX or the JAX package
loaded at the end, the run exits nonzero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench_port":
    sys.path[0] = str(ROOT)  # the harness's modules by their package names only
FORBIDDEN = {"jax", "jaxlib", "flax", "dpvo_tpu"}


class NoCard(RuntimeError):
    pass


def load_cell(bench: dict, name: str, root: Path = ROOT):
    """(cell, configuration file, traffic file) of cell ``name``."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((root / "bench_port" / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def load_module(root: Path, sub: str, name: str):
    """Module ``bench_port/<sub>/<name>.py`` under root, by its file."""
    path = root / "bench_port" / sub / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port.{sub}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool):
    """The metric entries the cell reports in this mode."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def read_metric(root: Path, name: str, ctx: dict):
    return load_module(root, "metrics", name).read(ctx)


def smi_utilization() -> str:
    """``nvidia-smi``'s utilization.gpu now (a cross-check of the device's
    idle share; the tool samples over its own period)."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=utilization.gpu",
                               "--format=csv,noheader,nounits"], capture_output=True,
                              text=True, timeout=10).stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None,
             root: Path = ROOT, log=print, tracker=None) -> dict:
    """Run the cell and return the result's object. ``device`` None takes
    the card (``NoCard`` without one); tests pass ``"cpu"``. ``root``: the
    checkout whose ``BENCHMARK.json`` and ``bench_port/`` data and readers
    are read (the harness's own modules and the port are this one's).
    ``tracker(config, weights, device, seq)``: what tracks in the port's
    place (the tests' control and faults); the port's ``DPVO`` by default."""
    import numpy as np
    import torch

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell, config, traffic = load_cell(bench, workload, root)
    if device is None:
        if not torch.cuda.is_available():
            raise NoCard("no CUDA device is available")
        if torch.cuda.device_count() < cell["chips"]:
            raise NoCard(f"the cell asks for {cell['chips']} cards, "
                         f"{torch.cuda.device_count()} available")
        device = "cuda:0"
    device = torch.device(device)
    cuda = device.type == "cuda"
    torch.set_num_threads(1)

    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.runtime.dpvo import DPVO
    from dpvo_tpu_torch.runtime.weights import load_npz

    from bench_port import judge, profile_window, window
    from bench_port.stats import sub_seed

    phases = {"imports": time.perf_counter() - T_START}
    if cuda:
        kernels.build()
    phases["kernel build"] = time.perf_counter() - T_START
    cfg = Config(**config["config"])
    ht, wd = config["ht"], config["wd"]
    weights = load_npz(str(root / config["weights"])) if config.get("weights") else None
    gen = load_module(root, "traffic", traffic["kind"])
    K = cfg.PATCHES_PER_FRAME * (3 if cfg.CENTROID_SEL_STRAT == "GRADIENT_BIAS" else 1)
    seqs = gen.make_sequences(traffic, seed, ht, wd, cfg.RES, K, cfg.PATCHES_PER_FRAME, device)
    phases["weights, sequences"] = time.perf_counter() - T_START

    probe = window.Probe()
    if trace and cuda:
        from dpvo_tpu_torch.ba import segsum as segsum_mod

        real_kernel = segsum_mod._segment_sum_kernel

        def counted_kernel(payload, kd, order, Md):
            probe.add("segsum", (int(payload.shape[0]), int(payload.shape[1]), int(Md),
                                 payload.element_size()))
            return real_kernel(payload, kd, order, Md)

        segsum_mod._segment_sum_kernel = counted_kernel

    if tracker is None:
        make = lambda seq: DPVO(cfg, weights, ht, wd, device=device, draws=seq.draws)
    else:
        make = lambda seq: tracker(config, weights, device, seq)
    smi = lambda: log(f"nvidia-smi utilization.gpu before the profiled seconds: "
                      f"{smi_utilization()} %")
    stream = window.StreamRun(seqs, make, device, trace, probe,
                              window.plan_checks(traffic.get("checks", []),
                                                 sub_seed(seed, 0xC4EC), traffic["frames"]),
                              traffic["warm_frames"],
                              traffic["profile_seconds"] if trace else 0.0, smi)
    stream.warm()
    phases["warm-up"] = time.perf_counter() - T_START
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T_START
    log("set-up, seconds from the start to the end of each phase: "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    stream.run(seconds)
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    summary = profile_window.combine(stream.profiles) if stream.profiles else None

    lat = stream.latencies
    frames = len(lat)
    spans = {k: [a.elapsed_time(b) for a, b in stream.spans[k]] for k in window.LAYERS}
    ctx = dict(frames=frames, window_s=stream.window_s, latencies_ms=[x * 1e3 for x in lat],
               setup_s=setup_s, peak_bytes=peak, spans_ms=spans,
               gba_round_ms=[x * 1e3 for x in stream.gba_host_s], profile=summary,
               profile_frames=stream.profiled_frames, corr_calls=list(probe.corr),
               segsum_calls=list(probe.segsum), edge_rounds=list(stream.edge_rounds),
               patchifies=stream.patchifies, config=config["config"], ht=ht, wd=wd)
    checks = stream.checks
    expected = len(checks)
    terminated = stream.sequences
    q = np.percentile(np.asarray(lat) * 1e3, [50, 90, 95, 99, 100]) if lat else [np.nan] * 5
    log(f"frames {frames} in a window of {stream.window_s:.3f} s; latency ms median {q[0]:.3f} "
        f"p90 {q[1]:.3f} p95 {q[2]:.3f} p99 {q[3]:.3f} max {q[4]:.3f}, samples {len(lat)}; "
        f"sequences terminated {terminated}; setup {setup_s:.3f} s; "
        f"peak {peak} bytes")
    if trace:
        log(f"global-BA rounds in the window {len(ctx['gba_round_ms'])}; profiled frames "
            f"{ctx['profile_frames']}")
    del stream, make
    if cuda:
        torch.cuda.empty_cache()
    rows = judge.judge(checks, seqs, config["config"], weights, ht, wd, device)
    for r in rows:
        log("check " + " ".join(f"{k}={v}" for k, v in r.items()))
    correct, numbers = judge.verdict(rows, config.get("limits", {}), expected)

    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        v = read_metric(root, m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": frames, "failed": 0, "metrics": metrics,
              "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = profile_window.breakdown(summary)
    result["checks"] = numbers
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "runs" / "cache" / "cuda"))
    err = lambda s: print(s, file=sys.stderr, flush=True)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), log=err)
    except NoCard as e:
        err(f"no result: {e}")
        return 3
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if loaded:
        err(f"no result: the process loaded {loaded}")
        return 4
    for k, v in result["checks"].items():
        err(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
