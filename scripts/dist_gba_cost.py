#!/usr/bin/env python3
"""What a one-rank mesh adds to a global-BA round, part by part.

    python3 scripts/dist_gba_cost.py [--frames 90] [--patches 96] [--reach 9] [--reps 20]

On a world-size-1 NCCL group (a FileStore in a temporary directory) and a
(1, 1) mesh, it builds a global-BA problem shaped like the last round of
chip_smoke.py's loop-closure stream: ``frames`` keyframes (all but the
first free), ``patches`` depth variables each, every patch seen from the
frames within ``reach`` of its own, random targets. Then it times, in
turn ``reps`` times each (median event pair, two iterations each):

- gba on the whole sparsity;
- gba with the mesh's all_sum (the four ``all_reduce`` calls alone);
- gba on ``shard_indices`` of the sparsity for rank 0 of 1 (the shard
  alone);
- dist_gba (both);
- gba again (the spread of two runs of the same call);
- one ``all_reduce`` over the one rank of a [W*W, 36] f32 tensor (the
  camera system's partial), beside one in-place copy of it.

Prints the card's name and power limit first. Needs a CUDA device.
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def problem(torch, frames, patches, reach, seed=0):
    """gba's positional arguments (on the card) and its W, Md, and the
    host sparsity's row and kpair counts."""
    from dpvo_tpu_torch.ba import gba_sparse

    rng = np.random.default_rng(seed)
    Md = frames * patches
    src = np.arange(Md) // patches
    ii, jj, kd = [], [], []
    for d in range(-reach, reach + 1):
        tgt = src + d
        ok = (tgt >= 0) & (tgt < frames) & (d != 0)
        ii.append(src[ok])
        jj.append(tgt[ok])
        kd.append(np.nonzero(ok)[0])
    ii, jj, kd = (np.concatenate(a).astype(np.int32) for a in (ii, jj, kd))
    order = np.argsort(kd, kind="stable")
    ii, jj, kd = ii[order], jj[order], kd[order]
    E, t0, nfree = len(ii), 1, frames - 1
    idx = gba_sparse.build_sparse_indices(ii, jj, kd, t0, nfree, W=nfree, R_MAX=1 << 24,
                                          KP_MAX=1 << 26)
    dev = torch.device("cuda")
    poses = np.tile([0, 0, 0, 0, 0, 0, 1.0], (frames, 1)).astype(np.float32)
    poses[:, 0] = 0.05 * np.arange(frames)
    ctr = np.stack([rng.uniform(10, 150, Md), rng.uniform(10, 110, Md),
                    rng.uniform(0.2, 1.0, Md)], -1).astype(np.float32)
    intr = np.tile([120.0, 120.0, 80.0, 60.0], (frames, 1)).astype(np.float32)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    args = (t(poses), t(ctr), t(intr), t(rng.uniform(0, 160, (E, 2))),
            t(rng.uniform(0.2, 1.0, (E, 2))), torch.ones(E, dtype=torch.bool, device=dev),
            t(ii, torch.int64), t(jj, torch.int64), t(kd, torch.int32), t0, nfree,
            t([-64.0, -64.0, 224.0, 184.0]), 1e-4, gba_sparse.index_tensors(idx, dev))
    return args, dict(W=nfree, Md=Md, iterations=2), len(idx["re"]), len(idx["pair_order"])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=90)
    p.add_argument("--patches", type=int, default=96)
    p.add_argument("--reach", type=int, default=9)
    p.add_argument("--reps", type=int, default=20)
    a = p.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    import chip_smoke
    from dpvo_tpu_torch.ba import gba_sparse
    from dpvo_tpu_torch.parallel import all_sum, make_mesh
    from dpvo_tpu_torch.parallel.multihost import init_distributed

    if not torch.cuda.is_available():
        raise SystemExit("dist_gba_cost.py needs a CUDA device")
    args, kw, R, KP = problem(torch, a.frames, a.patches, a.reach)
    with tempfile.TemporaryDirectory() as store:
        init_distributed(f"file://{os.path.join(store, 'store')}", 1, 0, backend="nccl")
        try:
            mesh = make_mesh(1, 1)
            idx = args[-1]
            runs = {
                "gba": lambda: gba_sparse.gba(*args, **kw),
                "gba + all_sum": lambda: gba_sparse.gba(*args, **kw,
                                                        allsum=all_sum(mesh, "edge")),
                "gba on shard_indices": lambda: gba_sparse.gba(
                    *args[:-1], gba_sparse.shard_indices(idx, 0, 1), **kw),
                "dist_gba": lambda: gba_sparse.dist_gba(mesh, *args, **kw),
                "gba again": lambda: gba_sparse.gba(*args, **kw),
            }
            x = torch.zeros((kw["W"] ** 2, 36), device="cuda")
            allsum = all_sum(mesh, "edge")
            runs.update({"one all_reduce": lambda: allsum(x),
                         "one copy": lambda: x.copy_(x)})
            ms = chip_smoke.alternating_ms(list(runs.values()), a.reps)
        finally:
            dist.destroy_process_group()
    print(f"global BA: {a.frames} frames ({kw['W']} free), {kw['Md']} depth variables, "
          f"{args[3].shape[0]} edges, {R} rows, {KP} kpairs; {a.reps} runs of each in turn, "
          f"median event pair (ms):")
    for name, m in zip(runs, ms):
        print(f"  {name:22s} {m:.4f}" + (f"  ({m - ms[0]:+.4f})" if "one" not in name else ""))


if __name__ == "__main__":
    main()
