"""TartanAir test-split evaluation (MH000-007, ME000-007) — the port of
``apps/evaluate_tartan.py``: the mono image_left stream at TartanAir's
pinhole (320, 320, 320, 240), pose_left.txt in NED converted with
``data/tartan.ned_to_xyz``, the N-trial median ATE, AVG and AUC.

  python -m dpvo_tpu_torch.apps.evaluate_tartan --datadir datasets/mono --trials 5
"""

from __future__ import annotations

import glob
import os

import numpy as np

from dpvo_tpu_torch.apps.common import evaluate, evaluate_parser
from dpvo_tpu_torch.data.tartan import ned_to_xyz
from dpvo_tpu_torch.utils import optional

TARTAN_INTR = np.array([320.0, 320.0, 320.0, 240.0], np.float32)

TEST_SEQS = [f"MH{i:03d}" for i in range(8)] + [f"ME{i:03d}" for i in range(8)]


def frame_iter(seqdir):
    cv2 = optional.cv2("evaluate_tartan")
    files = sorted(glob.glob(os.path.join(seqdir, "image_left", "*.png")))
    if not files:
        files = sorted(glob.glob(os.path.join(seqdir, "*.png")))
    for t, f in enumerate(files):
        img = cv2.imread(f)[..., ::-1]  # BGR -> RGB
        h, w = img.shape[:2]
        img = img[: h - h % 16, : w - w % 16]
        yield float(t), np.ascontiguousarray(img), TARTAN_INTR.copy()


def main(argv=None):
    args = evaluate_parser("datasets/mono", stride=False).parse_args(argv)
    sequences, gt = {}, {}
    for seq in TEST_SEQS:
        seqdir = os.path.join(args.datadir, seq)
        if not os.path.isdir(seqdir):
            continue
        gt_file = os.path.join(seqdir, "pose_left.txt")
        if os.path.exists(gt_file):
            poses = ned_to_xyz(np.loadtxt(gt_file))
            gt[seq] = (np.arange(len(poses), dtype=np.float64), poses[:, :3])
        sequences[seq] = (lambda d=seqdir: frame_iter(d))
    return evaluate(args, sequences, gt, max_dt=0.5, title="TartanAir test")


if __name__ == "__main__":
    main()
