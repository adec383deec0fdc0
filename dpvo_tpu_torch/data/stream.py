"""Frame streams: image-directory and video readers — port of
``dpvo_tpu/data/stream.py``.

Decode, undistort and crop run off the tracking loop in a separate
process (``spawn_reader``), which pushes (t, image, intrinsics) tuples
onto a queue and ends with t = -1; the in-process generators serve tests
and the evaluation scripts. Calibration files hold 4+ whitespace-separated
values (fx fy cx cy [k1 k2 p1 p2 ...]). Decoding needs OpenCV, imported
where it runs. The reader process is started with the spawn context: a
forked child of a process with threads (torch's pools) or a CUDA context
can deadlock or fail.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from itertools import chain
from pathlib import Path

import numpy as np

from dpvo_tpu_torch.utils import optional

IMAGE_EXTS = ("*.png", "*.jpeg", "*.jpg", "*.JPG", "*.PNG")


def load_calib(calib_path: str):
    calib = np.loadtxt(calib_path, delimiter=" ")
    fx, fy, cx, cy = calib[:4]
    K = np.eye(3)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    dist = calib[4:] if len(calib) > 4 else None
    return K, dist


def _prep(cv2, image, K, dist):
    if dist is not None and len(dist) > 0:
        image = cv2.undistort(image, K, dist)
    h, w = image.shape[:2]
    return image[: h - h % 16, : w - w % 16]


def iter_images(imagedir: str, calib: str, stride: int = 1, skip: int = 0):
    """In-process generator of (t, image [H,W,3] RGB uint8, intrinsics [4])."""
    cv2 = optional.cv2("the image reader")
    K, dist = load_calib(calib)
    files = sorted(chain.from_iterable(Path(imagedir).glob(e) for e in IMAGE_EXTS))
    files = files[skip::stride]
    intr = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32)
    for t, f in enumerate(files):
        img = _prep(cv2, cv2.imread(str(f)), K, dist)
        yield t, cv2.cvtColor(img, cv2.COLOR_BGR2RGB), intr.copy()


def iter_video(videopath: str, calib: str, stride: int = 1, skip: int = 0):
    """In-process generator over a video's frames, as ``iter_images``."""
    cv2 = optional.cv2("the video reader")
    K, dist = load_calib(calib)
    intr = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32)
    cap = cv2.VideoCapture(videopath)
    t = 0
    idx = 0
    while True:
        ok, img = cap.read()
        if not ok:
            break
        if idx < skip or (idx - skip) % stride != 0:
            idx += 1
            continue
        idx += 1
        img = _prep(cv2, img, K, dist)
        yield t, cv2.cvtColor(img, cv2.COLOR_BGR2RGB), intr.copy()
        t += 1
    cap.release()


def _reader_proc(queue, it_factory):
    try:
        for item in it_factory():
            queue.put(item)
    finally:  # a reader that fails still ends the stream
        queue.put((-1, None, None))


def image_stream(queue, imagedir: str, calib: str, stride: int = 1, skip: int = 0):
    """Reader-process target: Process(target=image_stream, args=(queue, ...))."""
    _reader_proc(queue, lambda: iter_images(imagedir, calib, stride, skip))


def video_stream(queue, videopath: str, calib: str, stride: int = 1, skip: int = 0):
    _reader_proc(queue, lambda: iter_video(videopath, calib, stride, skip))


def spawn_reader(imagedir_or_video: str, calib: str, stride: int = 1, skip: int = 0):
    """Start the reader process; returns (queue, process). The queue
    yields (t, image, intrinsics) ending with t = -1. Without OpenCV this
    raises here, before a process starts."""
    optional.cv2("the image reader")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue(maxsize=8)
    if os.path.isdir(imagedir_or_video):
        target, src = image_stream, imagedir_or_video
    else:
        target, src = video_stream, imagedir_or_video
    proc = ctx.Process(target=target, args=(queue, src, calib, stride, skip), daemon=True)
    proc.start()
    return queue, proc
