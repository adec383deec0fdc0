"""Network-driven tracking evaluation on held-out synthetic scenes — the
port of ``apps/eval_synthetic.py``.

Renders held-out procedural scenes with known trajectories, runs the
tracker's real path (motion-probe gate included, no oracle) and reports
the Sim(3)-aligned ATE per scene, relative to its path length, and a last
JSON line with the median.

  python -m dpvo_tpu_torch.apps.eval_synthetic --network weights.npz \\
      --trials 2 --n_frames 60 [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from dpvo_tpu_torch.apps.common import add_common_args, config_from_args


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--trials", type=int, default=1)
    p.add_argument("--scenes", type=int, default=4)
    p.add_argument("--n_frames", type=int, default=60)
    p.add_argument("--ht", type=int, default=240)
    p.add_argument("--wd", type=int, default=320)
    p.add_argument("--tstep", type=float, default=0.05,
                   help="per-frame translation scale; the motion-probe init gate needs ~2 "
                        "quarter-res px of per-frame flow, i.e. tstep >~ 10*depth/(0.8*wd)")
    p.add_argument("--rstep", type=float, default=0.004)
    p.add_argument("--depth", type=float, default=6.0)
    return p.parse_args(argv)


def main(argv=None):
    """Returns dict(scenes={name: dict(ate, path, rel, initialized, trials)},
    summary=the JSON line's object)."""
    from dpvo_tpu_torch.eval.ate import ate_rmse
    from dpvo_tpu_torch.lie import se3
    from dpvo_tpu_torch.runtime.dpvo import DPVO, resolve_device
    from dpvo_tpu_torch.utils.synthetic import MultiPlaneScene, PlaneScene

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_from_args(args)

    results = {}
    # held-out seeds: the training stream's clips draw their seeds elsewhere
    for s in range(args.scenes):
        seed = 5000 + 17 * s
        cls = MultiPlaneScene if s % 2 else PlaneScene
        scene = cls(ht=args.ht, wd=args.wd, n_frames=args.n_frames, depth=args.depth,
                    seed=seed, tstep=args.tstep, rstep=args.rstep)
        gt_c2w = se3.inv(torch.as_tensor(scene.poses, dtype=torch.float32)).numpy()
        motion = float(np.linalg.norm(np.diff(gt_c2w[:, :3], axis=0), axis=1).sum())

        errs, inits = [], []
        for trial in range(args.trials):
            slam = DPVO(cfg, args.network or None, ht=args.ht, wd=args.wd, seed=trial,
                        device=device)
            for t in range(args.n_frames):
                slam(t, scene.render(t), scene.intrinsics.copy())
            poses, _ = slam.terminate()
            err = ate_rmse(poses[:, :3], gt_c2w[:, :3], align_scale=True)
            errs.append(float(err))
            inits.append(bool(slam.is_initialized))
            print(f"scene {s} ({cls.__name__}, seed {seed}) trial {trial}: ATE {err:.4f} "
                  f"(path {motion:.2f} m, initialized={slam.is_initialized})", flush=True)
        results[f"scene{s}"] = dict(ate=float(np.median(errs)), path=motion,
                                    rel=float(np.median(errs)) / max(motion, 1e-9),
                                    initialized=all(inits), trials=errs)

    rels = [v["rel"] for v in results.values()]
    print("\n=== held-out synthetic ATE (Sim3-aligned, m) ===")
    for k, v in results.items():
        print(f"{k:10s} ATE {v['ate']:.4f}  path {v['path']:.2f}  rel {100 * v['rel']:.1f}%  "
              f"init {v['initialized']}")
    summary = {"metric": "synthetic_ate_rel", "value": round(float(np.median(rels)), 4),
               "unit": "ATE/path-length",
               "all_initialized": all(v["initialized"] for v in results.values())}
    print(json.dumps(summary))
    return dict(scenes=results, summary=summary)


if __name__ == "__main__":
    main()
