"""The evaluation protocol: N-trial median ATE per sequence, AVG and AUC —
port of ``dpvo_tpu/eval/protocol.py``.

Run the full tracker ``trials`` times per sequence, score each run's
ATE-RMSE after a Sim(3) alignment on timestamps associated within
``max_dt``, and report the per-sequence median, their mean over sequences
("AVG") and TartanAir's AUC, the mean over every trial of max(1 - ATE, 0)
(the reference's evaluate_tartan.py).

Every trial's tracker is built with seed 0, as the JAX protocol builds it,
so the port's scores follow the reference's protocol on the same data.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np

from dpvo_tpu_torch.eval.ate import associate, ate_rmse


def run_stream(cfg, network, frames: Iterable[Tuple[float, np.ndarray, np.ndarray]],
               viz: bool = False, device=None):
    """Track a (t, image, intrinsics) iterable with a tracker on ``device``
    (None: the card); returns (poses [T,7], tstamps [T])."""
    from dpvo_tpu_torch.runtime.dpvo import DPVO

    slam = None
    for t, image, intrinsics in frames:
        if slam is None:
            slam = DPVO(cfg, network, ht=image.shape[0], wd=image.shape[1], viz=viz,
                        device=device)
        slam(t, image, intrinsics)
    if slam is None:
        raise RuntimeError("empty stream")
    return slam.terminate()


def summarize(trials: Dict[str, List[float]]) -> Tuple[Dict[str, float], float, float]:
    """(per-sequence median ATE, AVG of the medians, AUC over every trial)
    of the trial ATEs of each sequence."""
    medians = {seq: float(np.median(errs)) for seq, errs in trials.items()}
    avg = float(np.array(list(medians.values())).mean())
    every = [e for errs in trials.values() for e in errs]
    auc = float(np.maximum(1.0 - np.array(every), 0.0).mean())
    return medians, avg, auc


def evaluate_sequences(
    cfg,
    network,
    sequences: Dict[str, Callable[[], Iterable]],
    gt: Dict[str, Tuple[np.ndarray, np.ndarray]],
    trials: int = 5,
    max_dt: float = 0.1,
    title: str = "results",
    device=None,
) -> Dict:
    """sequences: name -> frame-iterable factory; gt: name -> (t, xyz).
    Prints each trial, the medians, AVG and AUC as the JAX function does,
    and returns dict(median={seq: ATE}, trials={seq: [ATE, ...]}, avg,
    auc); avg and auc are None when no sequence had ground truth."""
    errs_by_seq: Dict[str, List[float]] = {}
    for seq, factory in sequences.items():
        if seq not in gt:
            print(f"skip {seq}: no groundtruth")
            continue
        t_gt, xyz_gt = gt[seq]
        errs = []
        for trial in range(trials):
            poses, tstamps = run_stream(cfg, network, factory(), device=device)
            ie, ig = associate(tstamps, t_gt, max_dt=max_dt)
            err = ate_rmse(poses[ie, :3], xyz_gt[ig], align_scale=True)
            errs.append(float(err))
            print(f"{seq} trial {trial}: ATE {err:.6f}", flush=True)
        errs_by_seq[seq] = errs
        print(f"{seq}: median ATE {float(np.median(errs)):.6f}  (trials: {sorted(errs)})")

    out = dict(median={}, trials=errs_by_seq, avg=None, auc=None)
    if errs_by_seq:
        out["median"], out["avg"], out["auc"] = summarize(errs_by_seq)
        print(f"\n=== {title} (ATE-RMSE, m; Sim3-aligned) ===")
        for k, v in out["median"].items():
            print(f"{k:24s} {v:.6f}")
        print(f"{'AVG':24s} {out['avg']:.6f}")
        print(f"{'AUC':24s} {out['auc']:.6f}")
    return out
