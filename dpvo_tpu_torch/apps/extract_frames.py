"""Extract (and resize) frames from a video into an image directory, the
input of the demo — the port of ``apps/extract_frames.py`` (needs OpenCV).

  python -m dpvo_tpu_torch.apps.extract_frames --video clip.mp4 --out frames/ \\
      [--height 480 --width 640 --stride 1]
"""

from __future__ import annotations

import argparse
import os

from dpvo_tpu_torch.utils import optional


def extract_frames(video_path: str, output_dir: str, height: int = 0, width: int = 0,
                   stride: int = 1, ext: str = "jpg") -> int:
    """Write every stride-th frame as output_dir/NNNNNN.ext (an existing
    file is kept, so a cut run resumes); returns the frames kept."""
    cv2 = optional.cv2("extract_frames")
    os.makedirs(output_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {video_path}")
    n_read = n_kept = 0
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        if n_read % stride == 0:
            if height and width:
                frame = cv2.resize(frame, (width, height))
            out = os.path.join(output_dir, f"{n_kept:06d}.{ext}")
            if not os.path.exists(out):
                cv2.imwrite(out, frame)
            n_kept += 1
        n_read += 1
    cap.release()
    return n_kept


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--stride", type=int, default=1)
    args = p.parse_args(argv)
    n = extract_frames(args.video, args.out, args.height, args.width, args.stride)
    print(f"saved {n} frames to {args.out}")
    return n


if __name__ == "__main__":
    main()
