"""EuRoC MAV evaluation — the port of ``apps/evaluate_euroc.py``: cam0
with its radtan undistortion, nanosecond timestamps from the file names,
ground truth from ``--gtdir``/<seq>.txt (or the dataset's
state_groundtruth CSV), associated within 20 ms, the N-trial median ATE
and AVG.

  python -m dpvo_tpu_torch.apps.evaluate_euroc --datadir datasets/EuRoC --trials 5 \\
      [--loop_closure]
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from dpvo_tpu_torch.apps.common import evaluate, evaluate_parser
from dpvo_tpu_torch.utils import optional

SEQUENCES = [
    "MH_01_easy", "MH_02_easy", "MH_03_medium", "MH_04_difficult", "MH_05_difficult",
    "V1_01_easy", "V1_02_medium", "V1_03_difficult",
    "V2_01_easy", "V2_02_medium", "V2_03_difficult",
]

# EuRoC cam0 intrinsics + radtan distortion (sensor.yaml; the values of the
# reference's calib/euroc.txt)
EUROC_CALIB = np.array([458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907,
                        0.00019359, 1.76187114e-05])


def frame_iter(imagedir, stride=2, skip=0):
    """(t in s, undistorted RGB image cropped to multiples of 16, intrinsics)."""
    cv2 = optional.cv2("evaluate_euroc")
    K = np.eye(3)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = EUROC_CALIB[:4]
    dist = EUROC_CALIB[4:]
    intr = np.array(EUROC_CALIB[:4], np.float32)
    for f in sorted(Path(imagedir).glob("*.png"))[skip::stride]:
        img = cv2.imread(str(f), cv2.IMREAD_GRAYSCALE)
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2RGB)
        img = cv2.undistort(img, K, dist)
        h, w = img.shape[:2]
        yield float(f.stem) / 1e9, img[: h - h % 16, : w - w % 16], intr.copy()


def run_sequence(cfg, network, imagedir, stride=2, skip=0, device=None):
    """Track one sequence; returns (poses [T,7] camera-to-world, tstamps [T])."""
    from dpvo_tpu_torch.eval.protocol import run_stream

    return run_stream(cfg, network, frame_iter(imagedir, stride, skip), device=device)


def load_euroc_gt(path):
    """state_groundtruth CSV or the whitespace txt: t x y z qw qx qy qz."""
    data = (np.loadtxt(path, delimiter=",", skiprows=1) if str(path).endswith(".csv")
            else np.loadtxt(path))
    t = data[:, 0]
    if t[0] > 1e12:  # ns
        t = t / 1e9
    return t, data[:, 1:4]


def main(argv=None):
    p = evaluate_parser("datasets/EuRoC", stride=False)
    p.add_argument("--gtdir", default=str(Path(__file__).parents[2] / "datasets/euroc_groundtruth"))
    p.add_argument("--stride", type=int, default=2)
    args = p.parse_args(argv)
    sequences, gt = {}, {}
    for seq in SEQUENCES:
        imagedir = os.path.join(args.datadir, seq, "mav0", "cam0", "data")
        if not os.path.isdir(imagedir):
            print(f"skip {seq}: no images at {imagedir}")
            continue
        gt_path = os.path.join(args.gtdir, f"{seq}.txt")
        if os.path.exists(gt_path):
            gt[seq] = load_euroc_gt(gt_path)
        sequences[seq] = (lambda d=imagedir: frame_iter(d, args.stride))
    return evaluate(args, sequences, gt, max_dt=0.02, title="EuRoC")


if __name__ == "__main__":
    main()
