"""TUM-RGBD freiburg1 evaluation (9 sequences) — the port of
``apps/evaluate_tum.py``: the fr1 intrinsics and radtan distortion, the
rgb.txt timestamped stream, groundtruth.txt (t x y z qx qy qz qw), the
N-trial median ATE and AVG.

  python -m dpvo_tpu_torch.apps.evaluate_tum --datadir datasets/TUM-RGBD --trials 5
"""

from __future__ import annotations

import os

import numpy as np

from dpvo_tpu_torch.apps.common import evaluate, evaluate_parser
from dpvo_tpu_torch.utils import optional

# fr1 (Freiburg 1) calibration as hardcoded by the reference
TUM_K = np.array([517.3, 516.5, 318.6, 255.3], np.float32)
TUM_DIST = np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])

SEQS = [
    "rgbd_dataset_freiburg1_360", "rgbd_dataset_freiburg1_desk",
    "rgbd_dataset_freiburg1_desk2", "rgbd_dataset_freiburg1_floor",
    "rgbd_dataset_freiburg1_plant", "rgbd_dataset_freiburg1_room",
    "rgbd_dataset_freiburg1_rpy", "rgbd_dataset_freiburg1_teddy",
    "rgbd_dataset_freiburg1_xyz",
]


def frame_iter(seqdir, stride=1):
    cv2 = optional.cv2("evaluate_tum")
    K = np.eye(3)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = TUM_K
    with open(os.path.join(seqdir, "rgb.txt")) as f:
        rows = [line.split() for line in f if not line.startswith("#")]
    for ts, rel in rows[::stride]:
        img = cv2.imread(os.path.join(seqdir, rel))[..., ::-1]
        img = cv2.undistort(np.ascontiguousarray(img), K, TUM_DIST)
        h, w = img.shape[:2]
        img = img[: h - h % 16, : w - w % 16]
        yield float(ts), img, TUM_K.copy()


def main(argv=None):
    args = evaluate_parser("datasets/TUM-RGBD").parse_args(argv)
    sequences, gt = {}, {}
    for seq in SEQS:
        seqdir = os.path.join(args.datadir, seq)
        if not os.path.isdir(seqdir):
            continue
        gt_file = os.path.join(seqdir, "groundtruth.txt")
        if os.path.exists(gt_file):
            data = np.loadtxt(gt_file)
            gt[seq] = (data[:, 0], data[:, 1:4])
        sequences[seq] = (lambda d=seqdir: frame_iter(d, args.stride))
    return evaluate(args, sequences, gt, max_dt=0.05, title="TUM-RGBD fr1")


if __name__ == "__main__":
    main()
