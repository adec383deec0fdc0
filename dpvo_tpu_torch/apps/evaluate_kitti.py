"""KITTI odometry evaluation — the port of ``apps/evaluate_kitti.py``: the
left grayscale stream (image_0), each sequence's calib.txt P0,
groundtruth poses/<seq>.txt (3x4 row-major), the N-trial median ATE.

  python -m dpvo_tpu_torch.apps.evaluate_kitti --datadir datasets/kitti/sequences \\
      --gtdir datasets/kitti/poses --trials 5
"""

from __future__ import annotations

import glob
import os

import numpy as np

from dpvo_tpu_torch.apps.common import evaluate, evaluate_parser
from dpvo_tpu_torch.utils import optional

SEQS = [f"{i:02d}" for i in range(11)]


def load_calib(seqdir):
    with open(os.path.join(seqdir, "calib.txt")) as f:
        for line in f:
            if line.startswith("P0:"):
                P = np.array(line[3:].split(), np.float64).reshape(3, 4)
                return np.array([P[0, 0], P[1, 1], P[0, 2], P[1, 2]], np.float32)
    raise RuntimeError("no P0 in calib.txt")


def frame_iter(seqdir, intr, stride=1):
    cv2 = optional.cv2("evaluate_kitti")
    files = sorted(glob.glob(os.path.join(seqdir, "image_0", "*.png")))[::stride]
    for t, f in enumerate(files):
        img = cv2.imread(f, cv2.IMREAD_GRAYSCALE)
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2RGB)
        h, w = img.shape[:2]
        img = img[: h - h % 16, : w - w % 16]
        yield float(t * stride), img, intr.copy()


def main(argv=None):
    p = evaluate_parser("datasets/kitti/sequences")
    p.add_argument("--gtdir", default="datasets/kitti/poses")
    args = p.parse_args(argv)
    sequences, gt = {}, {}
    for seq in SEQS:
        seqdir = os.path.join(args.datadir, seq)
        if not os.path.isdir(seqdir):
            continue
        intr = load_calib(seqdir)
        gt_file = os.path.join(args.gtdir, f"{seq}.txt")
        if os.path.exists(gt_file):
            P = np.loadtxt(gt_file).reshape(-1, 3, 4)
            gt[seq] = (np.arange(len(P), dtype=np.float64), P[:, :, 3])
        sequences[seq] = (lambda d=seqdir, k=intr: frame_iter(d, k, args.stride))
    return evaluate(args, sequences, gt, max_dt=0.5, title="KITTI odometry")


if __name__ == "__main__":
    main()
