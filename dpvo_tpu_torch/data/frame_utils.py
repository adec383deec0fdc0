"""Image / flow / depth file readers for training datasets — a copy of
``dpvo_tpu/data/frame_utils.py``: Middlebury .flo, PFM (Freeman/Sintel),
KITTI 16-bit flow PNG, Sintel .dpt depth and .cam camera files, plus the
extension-dispatching read_gen. The KITTI flow and image readers need
OpenCV, imported where they run.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np

from dpvo_tpu_torch.utils import optional

_FLO_MAGIC = 202021.25  # Middlebury sanity-check tag ("PIEH" as float)


def readFlow(fn: str) -> np.ndarray:
    """Middlebury .flo optical flow -> [H, W, 2] float32."""
    with open(fn, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != _FLO_MAGIC:
            raise ValueError(f"{fn}: invalid .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def writeFlow(filename: str, uv: np.ndarray, v: Optional[np.ndarray] = None):
    """Write Middlebury .flo; accepts [H,W,2] or separate u, v."""
    if v is None:
        assert uv.ndim == 3 and uv.shape[2] == 2
        u, v = uv[:, :, 0], uv[:, :, 1]
    else:
        u = uv
    assert u.shape == v.shape
    h, w = u.shape
    with open(filename, "wb") as f:
        np.array([_FLO_MAGIC], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        tmp = np.zeros((h, w * 2), np.float32)
        tmp[:, 0::2] = u
        tmp[:, 1::2] = v
        tmp.tofile(f)


def readFlowKITTI(filename: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit flow PNG -> (flow [H,W,2] f32, valid [H,W])."""
    cv2 = optional.cv2("readFlowKITTI")
    raw = cv2.imread(filename, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    raw = raw[:, :, ::-1].astype(np.float32)  # BGR -> RGB channel order
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    flow = (flow - 2**15) / 64.0
    return flow, valid


def readPFM(file: str) -> np.ndarray:
    """PFM image -> [H, W] or [H, W, 3] float32 (top-down)."""
    with open(file, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{file}: not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError(f"{file}: malformed PFM header")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    data = data.reshape((h, w, 3) if color else (h, w))
    return np.flipud(data).copy()  # PFM stores bottom-up


def readDPT(filename: str) -> np.ndarray:
    """Sintel .dpt depth -> [H, W] float32 (same container as .flo,
    one channel)."""
    with open(filename, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != _FLO_MAGIC:
            raise ValueError(f"{filename}: invalid .dpt magic")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        depth = np.fromfile(f, np.float32, count=w * h)
    return depth.reshape(h, w)


def cam_read(filename: str) -> Tuple[np.ndarray, np.ndarray]:
    """Sintel .cam file -> (M [3,3] intrinsics, N [3,4] extrinsics)."""
    with open(filename, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != _FLO_MAGIC:
            raise ValueError(f"{filename}: invalid .cam magic")
        M = np.fromfile(f, np.float64, count=9).reshape(3, 3)
        N = np.fromfile(f, np.float64, count=12).reshape(3, 4)
    return M, N


def read_gen(file_name: str, pil: bool = False):
    """Extension-dispatched reader (images, .flo, .pfm, .dpt, .bin)."""
    ext = os.path.splitext(file_name)[-1].lower()
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        cv2 = optional.cv2("read_gen of an image")
        img = cv2.imread(file_name, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(file_name)
        if img.ndim == 3:
            img = img[:, :, ::-1]  # BGR -> RGB
        return img
    if ext in (".bin", ".raw"):
        return np.load(file_name)
    if ext == ".flo":
        return readFlow(file_name).astype(np.float32)
    if ext == ".pfm":
        flow = readPFM(file_name).astype(np.float32)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    if ext == ".dpt":
        return readDPT(file_name)
    raise ValueError(f"read_gen: unsupported extension {ext}")
