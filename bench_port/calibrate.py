"""The readings that the limits of ``correct`` are set from, in one
process: for each seed, the run's checks, the
program's numbers and the control's (the reference in fp8 put in the
program's place), each against the f32 reference.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1 2 3 ... [--control-seeds 1 2 3]

The sequences are tracked without the window's clock: a tracker's calls
and their results do not depend on the timing, so a check reads here
what it reads in a run of the cell with the same seed.
Prints one JSON line a (seed, check) and, last, each number's largest
program reading and smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench_port":
    sys.path[0] = str(ROOT)


def stream_checks(workload: str, seed: int, device, root: Path = ROOT):
    """(config file, weights, sequences, checks): the sequences up to the
    last one the checks take, tracked by the program with the checks
    taken, as in a run."""
    import torch

    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.runtime.dpvo import DPVO
    from dpvo_tpu_torch.runtime.weights import load_npz

    from bench_port import window
    from bench_port.run import load_cell, load_module
    from bench_port.stats import sub_seed

    bench = json.loads((root / "BENCHMARK.json").read_text())
    _, config, traffic = load_cell(bench, workload, root)
    cfg = Config(**config["config"])
    ht, wd = config["ht"], config["wd"]
    weights = load_npz(str(root / config["weights"])) if config.get("weights") else None
    gen = load_module(root, "traffic", traffic["kind"])
    K = cfg.PATCHES_PER_FRAME * (3 if cfg.CENTROID_SEL_STRAT == "GRADIENT_BIAS" else 1)
    seqs = gen.make_sequences(traffic, seed, ht, wd, cfg.RES, K, cfg.PATCHES_PER_FRAME, device)
    plan = window.plan_checks(traffic.get("checks", []), sub_seed(seed, 0xC4EC),
                              traffic["frames"])
    run = window.StreamRun(seqs, None, device, False, window.Probe(), plan, 0)
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
    return config, weights, seqs, plan


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


def main(argv=None) -> int:
    import torch

    from bench_port import judge

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--root", default=str(ROOT), help="the checkout whose cell files are read")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    torch.set_num_threads(1)
    if dev.type == "cuda":
        from dpvo_tpu_torch import kernels

        kernels.build()
    # a run's number is its largest over the checks; the lower reading is
    # the largest of the program's runs, the upper the smallest of the control's
    runs = {"program": [], "control": []}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        config, weights, seqs, checks = stream_checks(args.workload, seed, dev, Path(args.root))
        sides = []
        if seed in args.seeds:
            sides.append(("program", judge.judge(checks, seqs, config["config"], weights,
                                                 config["ht"], config["wd"], dev)))
        if seed in args.control_seeds:
            sides.append(("control", control_rows(checks, seqs, config, weights, dev)))
        for side, rows in sides:
            for r in rows:
                print(json.dumps(dict(seed=seed, side=side, **r)), flush=True)
            runs[side].append({k: max((r[k] for r in rows), default=math.nan)
                               for k in judge.NUMBERS})
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    summary = {"program_max": {k: max((r[k] for r in runs["program"]), default=None)
                               for k in judge.NUMBERS},
               "control_min": {k: min((r[k] for r in runs["control"]), default=None)
                               for k in judge.NUMBERS}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
