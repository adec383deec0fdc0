#!/usr/bin/env python3
"""corr_backward's time on a real training step's inputs, this checkout's
against another checkout's, in turns on one card.

    python3 scripts/corr_bwd_step.py --other DIR

DIR is another checkout of the repo (for example an earlier commit,
``git archive`` unpacked into the git-ignored ``_archive/``).

1. Capture, in this checkout: one full training step at chip_smoke.py
   phase 8's shape (Config(), weights/vonet_synth.npz, a 15-frame 480x640
   synthetic clip, 18 unroll steps, make_train_step) records the arguments
   of every corr_backward call its backward makes, and saves them under
   runs/ (git-ignored; deleted at the end).
2. Times, each in a process of its own, DIR's package, this one's, this
   one's, DIR's: the captured calls back to back (event pair, median of 5
   runs), the device time of the corr_bwd kernels and of every kernel the
   calls launch (profiler), and the same for one call on chip_smoke.py's
   synthetic case (train_corr_case, bf16: 5% of the patches spread 3-6 px).

Each checkout's corr_backward gets the arguments its own training step
gives it: a jj1_order built on the host only where it takes one.
"""

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAMES = ("g", "gmap", "fmap1", "fmap2", "coords", "ii1", "jj1", "valid", "ii1_order",
         "jj1_order")


def capture(path):
    """Save the arguments of each corr_backward call of one full training step."""
    sys.path.insert(0, ROOT)
    import torch

    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.data.factory import SyntheticClipDataset
    from dpvo_tpu_torch.ops import corr_cuda
    from dpvo_tpu_torch.runtime.weights import init_networks, load_npz, params_from_jax
    from dpvo_tpu_torch.train import make_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False  # as apps/train.py on the card
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config()
    nets = init_networks(cfg, torch.Generator().manual_seed(0))
    nets.load_state_dict(params_from_jax(load_npz(os.path.join(ROOT, "weights",
                                                               "vonet_synth.npz"))), strict=True)
    nets = nets.to("cuda")
    tx, _ = make_optimizer(lr=8e-5, total_steps=240000)
    opt_state = tx.init({k: p.detach() for k, p in nets.named_parameters()})
    step = make_train_step(cfg, tx, STEPS=18)
    clip = SyntheticClipDataset(n_frames=15, ht=480, wd=640, seed=5).sample()
    batch = {k: v[None] for k, v in zip(("images", "poses", "disps", "intrinsics"), clip)}

    calls, real = [], corr_cuda.corr_backward
    sig = inspect.signature(real)

    def record(*args, **kw):
        bound = sig.bind(*args, **kw).arguments
        calls.append({k: bound.get(k) for k in NAMES})
        return real(*args, **kw)

    corr_cuda.corr_backward = record
    try:
        step(nets, opt_state, batch, torch.Generator().manual_seed(3))
        torch.cuda.synchronize()
    finally:
        corr_cuda.corr_backward = real
    torch.save(calls, path)
    E = sorted({c["g"].shape[0] for c in calls})
    print(f"captured {len(calls)} corr_backward calls of one training step (E {E})")


def _events_ms(torch, fn, runs=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return sorted(out)[len(out) // 2]


def _device_ms(torch, kernels, fn, attempts=8):
    """(ms of the corr_bwd kernels by name, ms of every kernel) of one fn()
    from a profile that kept an event for each corr_bwd launch; a ~1 ms spin
    kernel starts each profile, as chip_smoke.device_ms does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        before = kernels.LAUNCHES["corr_bwd"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(2_000_000)
            fn()
            torch.cuda.synchronize()
        want = kernels.LAUNCHES["corr_bwd"] - before
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]
        ours = {e.key[:60]: e.self_device_time_total / 1e3 for e in evs if "corr_bwd" in e.key}
        if sum(e.count for e in evs if "corr_bwd" in e.key) == want:
            return ours, sum(e.self_device_time_total for e in evs) / 1e3
        time.sleep(0.5)
    raise RuntimeError(f"no complete profile in {attempts} attempts")


def time_root(path, root):
    """The timings of root's corr_backward on the captured calls and on the
    synthetic case, as one JSON line."""
    sys.path.insert(0, root)
    import torch

    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.ops.corr_cuda import corr_backward

    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    takes = set(inspect.signature(corr_backward).parameters)
    calls = [{k: v for k, v in c.items() if k in takes}
             for c in torch.load(path, map_location="cuda")]
    synth = dict(zip(NAMES, here.train_corr_case(torch, torch.Generator(device="cuda")
                                                  .manual_seed(0), torch.bfloat16)))
    synth = {k: v for k, v in synth.items() if k in takes}
    res = {"root": root, "calls": len(calls)}
    for name, fn in (("step", lambda: [corr_backward(**c) for c in calls]),
                     ("synthetic", lambda: corr_backward(**synth))):
        ms = _events_ms(torch, fn)
        by_kernel, all_ms = _device_ms(torch, kernels, fn)
        res[name] = {"ms": ms, "device_ms_corr_bwd": sum(by_kernel.values()),
                     "device_ms_all": all_ms, "by_kernel": by_kernel}
    print(json.dumps(res))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--capture", metavar="FILE", help=argparse.SUPPRESS)
    ap.add_argument("--time", metavar="FILE", help=argparse.SUPPRESS)
    ap.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("corr_bwd_step: no CUDA device is available", file=sys.stderr)
        return 2
    if args.capture:
        capture(args.capture)
        return 0
    if args.time:
        time_root(args.time, os.path.abspath(args.root))
        return 0
    if not args.other:
        ap.error("--other DIR is required")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    os.makedirs(os.path.join(ROOT, "runs"), exist_ok=True)
    path = os.path.join(ROOT, "runs", "corr_bwd_step_calls.pt")
    me = [sys.executable, os.path.abspath(__file__)]
    try:
        subprocess.run(me + ["--capture", path], check=True)
        other, this = os.path.abspath(args.other), ROOT
        runs = {other: [], this: []}
        for root in (other, this, this, other):
            out = subprocess.run(me + ["--time", path, "--root", root], check=True,
                                 capture_output=True, text=True).stdout
            res = json.loads(out.strip().splitlines()[-1])
            print(json.dumps(res))
            runs[root].append(res)
    finally:
        if os.path.exists(path):
            os.remove(path)
    summary = {}
    for case in ("step", "synthetic"):
        for key in ("ms", "device_ms_corr_bwd", "device_ms_all"):
            o = sum(r[case][key] for r in runs[other]) / 2
            t = sum(r[case][key] for r in runs[this]) / 2
            summary[f"{case} {key}"] = {"other": o, "this": t, "this/other": t / o}
    for k, v in summary.items():
        print(f"{k}: other {v['other']:.4f}, this {v['this']:.4f} ms ({v['this/other']:.4f}x)")
    print(json.dumps({"calls": runs[this][0]["calls"], "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
