"""ICL-NUIM evaluation (8 sequences, living room and office) — the port of
``apps/evaluate_icl_nuim.py``: the ICL pinhole (481.20, 480.0, 319.5,
239.5), TUM-format groundtruth, the N-trial median ATE and AVG.

  python -m dpvo_tpu_torch.apps.evaluate_icl_nuim --datadir datasets/ICL-NUIM --trials 5
"""

from __future__ import annotations

import glob
import os

import numpy as np

from dpvo_tpu_torch.apps.common import evaluate, evaluate_parser
from dpvo_tpu_torch.utils import optional

ICL_INTR = np.array([481.20, 480.0, 319.5, 239.5], np.float32)

SEQS = [
    "living_room_traj0_frei_png", "living_room_traj1_frei_png",
    "living_room_traj2_frei_png", "living_room_traj3_frei_png",
    "traj0_frei_png", "traj1_frei_png", "traj2_frei_png", "traj3_frei_png",
]


def frame_iter(seqdir, stride=1):
    cv2 = optional.cv2("evaluate_icl_nuim")
    stamp = lambda f: int(os.path.splitext(os.path.basename(f))[0])
    files = sorted(glob.glob(os.path.join(seqdir, "rgb", "*.png")), key=stamp)[::stride]
    for f in files:
        img = cv2.imread(f)[..., ::-1]
        h, w = img.shape[:2]
        img = np.ascontiguousarray(img[: h - h % 16, : w - w % 16])
        yield float(stamp(f)), img, ICL_INTR.copy()


def main(argv=None):
    args = evaluate_parser("datasets/ICL-NUIM").parse_args(argv)
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
    return evaluate(args, sequences, gt, max_dt=0.5, title="ICL-NUIM")


if __name__ == "__main__":
    main()
