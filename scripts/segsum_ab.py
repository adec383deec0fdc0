#!/usr/bin/env python3
"""The segment-sum kernel of this checkout against another checkout's, on
one card: times at chip_smoke.py phase 2's rows, the bits of the paths
that run it, and whether phase 8's fixed-clip overfit repeats.

    python3 scripts/segsum_ab.py times --other DIR
    python3 scripts/segsum_ab.py bits --other DIR
    python3 scripts/segsum_ab.py overfit --other DIR

DIR is another checkout of the repo (for example an earlier commit,
``git archive`` unpacked into the git-ignored ``_archive/``). Each run
imports one checkout's ``dpvo_tpu_torch`` in a process of its own and
drives it with this checkout's chip_smoke.py functions. Each mode runs
DIR's package, this one's, this one's, DIR's, in turns, so that each
checkout is seen twice and a drift of the card or the host falls on both.

``times``: phase 2's segment-sum rows drawn from one seed: BA's f32
[49152, 98] (segsum), SoftAgg's two bf16 sums (segsum_bf16), the global
BA's seven reductions (segsum_gba, each one's device time), training's BA
forward and backward (segsum_train), the PGO's and the triplet BA's
(segsum_pgo, segsum_triplet). A first pass calls every row once, without
its timing loops, and hashes the output of each segment-sum call (SHA-256
of its bytes), keyed by the call's place in its row; a second pass times
the rows. Prints each row's event pair (median over the row's
repetitions, the host's launch included), device time (profiler) and host
time per call (the row's first input, 500 calls issued back to back
before one synchronize), per run; and, per row, whether every call's
output has the same bits in every run.

``bits``: chip_smoke.py phases 3, 4, 5 (the tiny tracker's card runs), 8
and 9 per run; prints, for each trajectory (every ATE's input, the free
runs, the exported tracker's poses) and each training step (its loss,
gradients and parameters), a SHA-256 per run, and whether each
checkout's two runs agree and the two checkouts agree.

``overfit``: phase 8's fixed-clip overfit, twice in each run under each
of three settings: as chip_smoke.py runs it; with
``torch.backends.cudnn.deterministic``; with
``torch.use_deterministic_algorithms(True, warn_only=True)``, whose
warnings name the ops that have no deterministic implementation. Prints
whether the two overfits of a setting repeat, the first step where they
part, the gradient leaves that part there, and the warnings.

Outputs go to runs/segsum_ab/ (git-ignored).
"""

import argparse
import contextlib
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import warnings
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT = os.path.join(ROOT, "runs", "segsum_ab")
HOST_CALLS = 500


def _chip_smoke(root):
    """This checkout's chip_smoke.py, driving root's package."""
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT,
                                                                             "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def _sha(*arrays):
    """SHA-256 (16 hex digits) of the bytes of numpy arrays and tensors."""
    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        if hasattr(a, "detach"):  # any dtype, bf16 included, as its bytes
            a = a.detach().cpu().contiguous().reshape(-1).view(__import__("torch").uint8).numpy()
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _note_steps(note):
    """Wraps make_train_step so that each step's loss, gradients and
    parameters go to note(loss, named gradients, named parameters)."""
    import torch

    from dpvo_tpu_torch import train

    real_make = train.make_train_step

    class Step:
        def __init__(self, step):
            object.__setattr__(self, "_step", step)

        def __getattr__(self, k):
            return getattr(self._step, k)

        def __setattr__(self, k, v):
            setattr(self._step, k, v)

        def __call__(self, *args, **kw):
            res = self._step(*args, **kw)
            named = sorted(res[0].named_parameters())
            note(torch.as_tensor(float(res[2]["loss"])),
                 [(k, p.grad) for k, p in named if p.grad is not None], named)
            return res

    train.make_train_step = lambda *a, **kw: Step(real_make(*a, **kw))


ROWS = ("segsum", "segsum_gba", "segsum_train", "segsum_lc")


def _rows(cs, torch):
    """Phase 2's segment-sum rows, each under its name: label[0] is the row
    being run."""
    g = torch.Generator(device="cuda").manual_seed(0)
    fns = {"segsum": lambda: cs.segsum_kernels(torch, g),
           "segsum_gba": lambda: cs.segsum_gba_kernels(torch, g),
           "segsum_train": lambda: cs.segsum_train_row(
               torch, g, cs.train_corr_case(torch, g, torch.bfloat16)[5]),
           "segsum_lc": lambda: cs.classic_lc_kernels(torch, g)}
    for name in ROWS:
        yield name, fns[name]


def run_times(root, out):
    cs = _chip_smoke(root)
    import torch

    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.ba import segsum

    kernels.build()
    real = segsum._segment_sum_kernel
    timers = cs.cuda_ms, cs.device_ms
    # pass 1: each row once, its timings stubbed (fn called once, 1.0 ms
    # returned), every segment-sum output hashed under (row, its place among
    # the row's calls)
    digests, firsts, counts, label = {}, {}, {}, [None]

    def hashed(payload, kd, order, Md):
        y = real(payload, kd, order, Md)
        n = counts[label[0]] = counts.get(label[0], -1) + 1
        digests[(label[0], n)] = [list(payload.shape), Md, _sha(y)]
        firsts.setdefault(label[0], (payload, kd, order, Md))
        return y

    segsum._segment_sum_kernel = hashed
    cs.cuda_ms = cs.device_ms = lambda fn, reps, warmup=2, **kw: (fn(), 1.0)[1]
    for name, fn in _rows(cs, torch):
        label[0] = name
        fn()
    segsum._segment_sum_kernel = real
    cs.cuda_ms, cs.device_ms = timers
    # pass 2: the rows timed
    rows = {}
    for _, fn in _rows(cs, torch):
        rows.update(fn())
    # host time of one segment_sum call at each row's first input
    host_us = {}
    for name, args in firsts.items():
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                segsum.segment_sum(*args)
            ts.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
        host_us[name] = sorted(ts)[2]
    keep = ("ms", "device_ms", "library_ms", "reductions")
    res = dict(root=os.path.abspath(root), card=torch.cuda.get_device_name(0), host_us=host_us,
               rows={k: {f: v[f] for f in keep if f in v} for k, v in rows.items()
                     if k.startswith("segsum")},
               digests=[[row, n, *v] for (row, n), v in digests.items()])
    with open(out, "w") as f:
        json.dump(res, f)


def run_bits(root, out):
    cs = _chip_smoke(root)
    import numpy as np
    import torch

    from dpvo_tpu_torch import kernels

    kernels.build()
    seen = []

    def note(what, *arrays):
        seen.append([what, _sha(*arrays)])

    real_ate, real_free, real_diff = cs.ate_rmse, cs.check_free_runs, cs._pose_diff

    def ate(est, gt):
        note("trajectory (ATE input)", est)
        return real_ate(est, gt)

    def free(ref, alt, who="card"):
        (i, k, p) = alt
        note("tiny tracker free run", i[1], i[2], np.asarray(k), p)
        return real_free(ref, alt, who)

    def diff(a, b):
        note("exported against eager poses", a, b)
        return real_diff(a, b)

    cs.ate_rmse, cs.check_free_runs, cs._pose_diff = ate, free, diff
    # outputs only: the runs' gate reads ba/segsum.CHUNK, which an earlier
    # checkout may lack
    cs.segsum_runs = lambda torch, label: contextlib.nullcontext()
    _note_steps(lambda loss, grads, params: note(
        "training step (loss, gradients, parameters)", loss, *[g for _, g in grads],
        *[p for _, p in params]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    cs.phase_main_path(torch, kernels)
    cs.phase_corr_impls(torch, kernels)
    cs.phase_small_parity(torch)
    cs.phase_training(torch, kernels)
    cs.phase_export_apps(torch, kernels, smi)
    with open(out, "w") as f:
        json.dump(dict(root=os.path.abspath(root), card=torch.cuda.get_device_name(0), smi=smi,
                       sec=time.perf_counter() - t0, seen=seen), f)


def run_overfit(root, out):
    cs = _chip_smoke(root)
    import torch

    from dpvo_tpu_torch import kernels

    kernels.build()
    # as phase 8 leaves them: the train entry point turns TF32 off
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    steps = []
    _note_steps(lambda loss, grads, params: steps.append(dict(
        loss=_sha(loss), grads={k: _sha(g) for k, g in grads},
        params=_sha(*[p for _, p in params]))))

    @contextlib.contextmanager
    def setting(name):
        if name == "cudnn.deterministic":
            torch.backends.cudnn.deterministic = True
        elif name == "use_deterministic_algorithms":
            torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.backends.cudnn.deterministic = False
            torch.use_deterministic_algorithms(False)

    res = {}
    for name in ("as chip_smoke.py", "cudnn.deterministic", "use_deterministic_algorithms"):
        runs, said = [], set()
        for _ in range(2):
            steps.clear()
            with setting(name), warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                losses = cs.fixed_clip_overfit(torch)
            said |= {str(w.message).split("\n")[0][:240] for w in caught
                     if "deterministic" in str(w.message)}
            runs.append(dict(losses=losses, steps=list(steps)))
        res[name] = dict(runs=runs, warnings=sorted(said))
    with open(out, "w") as f:
        json.dump(dict(root=os.path.abspath(root), card=torch.cuda.get_device_name(0),
                       settings=res), f)


def child(args, out):
    """Run one checkout in a process of its own; its log beside its result."""
    cmd = [sys.executable, os.path.abspath(__file__), *args, "--out", out]
    t0 = time.perf_counter()
    with open(out + ".log", "w") as log:
        rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT).returncode
    print(f"{' '.join(args)}: exit {rc} in {time.perf_counter() - t0:.1f} s (log {out}.log)",
          flush=True)
    if rc:
        with open(out + ".log") as f:
            print(f.read()[-4000:])
        raise SystemExit(f"{' '.join(args)} failed")
    with open(out) as f:
        return json.load(f)


def in_turns(mode, other):
    """mode's child run on the other checkout, this one, this one, the other."""
    plan = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)]
    return [(who, child([f"_{mode}", "--root", root], os.path.join(OUT, f"{mode}_{i}.json")))
            for i, (who, root) in enumerate(plan)]


def times(other):
    runs = in_turns("times", other)
    print(f"card: {runs[0][1]['card']}")
    for name in runs[0][1]["rows"]:
        for who, r in runs:
            row = r["rows"][name]
            print(f"{name} ({who}): event pair ms {row['ms']:.5f}, device ms "
                  f"{row['device_ms']:.5f}, library ms {row.get('library_ms')}")
    for name in runs[0][1]["host_us"]:
        print(f"host us per call at {name}'s first input: " + ", ".join(
            f"{who} {r['host_us'][name]:.2f}" for who, r in runs))
    for name in runs[0][1]["rows"]["segsum_gba"]["reductions"]:
        print(f"segsum_gba {name}: device ms " + ", ".join(
            f"{who} {r['rows']['segsum_gba']['reductions'][name]:.5f}" for who, r in runs))
    # each call's output, by its place in its row, in every run
    calls, whose = {}, [who for who, _ in runs]
    for who, r in runs:
        for row, n, shape, Md, d in r["digests"]:
            calls.setdefault((row, n), [shape, Md, []])[2].append(d)
    by = lambda ds, who: {d for w, d in zip(whose, ds) if w == who}
    for row in ROWS:
        mine = [v for (r, _), v in sorted(calls.items()) if r == row]
        repeat = all(len(ds) == len(runs) and len(by(ds, "other")) == len(by(ds, "this")) == 1
                     for _, _, ds in mine)
        apart = Counter(f"{shape} into {Md}" for shape, Md, ds in mine
                        if by(ds, "other") != by(ds, "this"))
        print(f"bits {row}: {len(mine)} calls, each with the same bits in a checkout's two runs: "
              f"{repeat}; the same in both checkouts: {len(mine) - sum(apart.values())}"
              + (f"; apart (calls): {dict(apart)}" if apart else ""))


def bits(other):
    runs = in_turns("bits", other)
    print(f"card: {runs[0][1]['smi']}; " + ", ".join(f"{who} {r['sec']:.1f} s" for who, r in runs))
    if len({len(r["seen"]) for _, r in runs}) != 1:
        raise SystemExit("the runs noted different numbers of outputs")
    both = 0
    for outs in zip(*[r["seen"] for _, r in runs]):
        o1, t1, t2, o2 = [d for _, d in outs]
        both += o1 == o2 == t1 == t2
        print(f"{outs[0][0]}: other {o1} {o2}, this {t1} {t2}: other repeats {o1 == o2}, this "
              f"repeats {t1 == t2}, the same in both {len({o1, o2, t1, t2}) == 1}")
    print(f"bits: {len(runs[0][1]['seen'])} outputs, {both} the same in all four runs")


def overfit(other):
    runs = in_turns("overfit", other)
    print(f"card: {runs[0][1]['card']}")
    for name in runs[0][1]["settings"]:
        for who, r in runs:
            s = r["settings"][name]
            a, b = s["runs"]
            part = next((i for i, (x, y) in enumerate(zip(a["steps"], b["steps"])) if x != y),
                        None)
            where = "repeat bit for bit" if part is None else (
                f"part at step {part + 1} (loss {a['steps'][part]['loss'] != b['steps'][part]['loss']}"
                f" apart); gradient leaves apart there: "
                f"{[k for k, d in a['steps'][part]['grads'].items() if b['steps'][part]['grads'][k] != d]}")
            print(f"overfit, {name} ({who}): its two runs {where}; losses {a['losses'][:4]} and "
                  f"{b['losses'][:4]} ...")
        first = [json.dumps(s["runs"][k]["steps"][0], sort_keys=True)
                 for _, r in runs for s in [r["settings"][name]] for k in (0, 1)]
        print(f"overfit, {name}: the first step (loss, gradients, parameters) the same in all "
              f"{len(first)} overfits: {len(set(first)) == 1}")
        for w in runs[-1][1]["settings"][name]["warnings"]:
            print(f"overfit, {name}: warned: {w}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("times", "bits", "overfit", "_times", "_bits", "_overfit"))
    ap.add_argument("--other", help="the other checkout")
    ap.add_argument("--root", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mode.startswith("_"):
        return {"_times": run_times, "_bits": run_bits, "_overfit": run_overfit}[args.mode](
            args.root, args.out)
    os.makedirs(OUT, exist_ok=True)
    {"times": times, "bits": bits, "overfit": overfit}[args.mode](args.other)


if __name__ == "__main__":
    main()
