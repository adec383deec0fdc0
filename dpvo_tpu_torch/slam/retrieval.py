"""ORB place recognition for classic loop closure — port of
``dpvo_tpu/slam/retrieval.py``.

  - keypoints and 32-byte binary descriptors per image from a detector:
    OpenCV's ORB by default (``cv2`` is imported at the first image, not
    before), or any ``detect(image) -> (pts [n,2] f32, desc [n,32] u8)``
    the caller gives;
  - the scoring and matching core ``native/retrieval.cpp`` (exact best-match
    hamming similarity), compiled with ``g++`` at first use into
    ``dpvo_tpu_torch/_build/`` (the file named by a hash of the source and
    the flags) and bound with ``ctypes``; a failed build raises, there is
    no fallback. ``score_plain`` and ``match_plain`` are the same
    functions in numpy, for the tests;
  - the retrieval discipline: only frames >= RADIUS older are candidates,
    a hit needs ``window`` consecutive consistent matches, and hits are
    suppressed near earlier closures.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np

RADIUS = 50          # min frame separation query <-> result
MAX_DESC = 512       # descriptors kept per frame

SOURCE = Path(__file__).resolve().parents[2] / "native" / "retrieval.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

Detect = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]

_lock = threading.Lock()
_LIB = None


def build() -> Path:
    """Compile native/retrieval.cpp into a shared library under _build/
    (a no-op when the library of this source and these flags exists);
    raises when g++ fails."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libretrieval_{h}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / lib_path.name
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stdout}")
        os.replace(out, lib_path)
    return lib_path


def _lib():
    """The loaded native core (built at first use)."""
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.retrieval_create.restype = ctypes.c_void_p
            lib.retrieval_destroy.argtypes = [ctypes.c_void_p]
            lib.retrieval_insert.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            lib.retrieval_query.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.retrieval_match.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            _LIB = lib
    return _LIB


def opencv_available() -> bool:
    if "cv2" in sys.modules:
        return sys.modules["cv2"] is not None
    return importlib.util.find_spec("cv2") is not None


def _hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[na, nb] hamming distances of two descriptor sets (numpy)."""
    table = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)
    return table[np.bitwise_xor(a[:, None, :], b[None, :, :])].sum(-1)


def score_plain(q: np.ndarray, descs: List[np.ndarray], max_index: int) -> np.ndarray:
    """The native query in numpy: frame j <= max_index (non-empty) scores the
    mean over q's descriptors of 1 - (best hamming distance into j) / 256;
    the other frames -1."""
    scores = np.full(len(descs), -1.0, np.float32)
    for j, d in enumerate(descs[:max_index + 1]):
        if len(d) and len(q):
            scores[j] = np.float32(np.mean(1.0 - _hamming(q, d).min(1) / 256.0))
    return scores


def match_plain(a: np.ndarray, b: np.ndarray):
    """The native k=2 hamming search of a's descriptors in b's, in numpy:
    (best index, best distance, second distance) per row of a."""
    dist = _hamming(a, b)
    best = dist.argmin(1)
    d1 = dist[np.arange(len(a)), best]
    dist[np.arange(len(a)), best] = 257
    d2 = dist.min(1)
    return best.astype(np.int32), d1.astype(np.int32), d2.astype(np.int32)


def orb_detector(n_features: int = MAX_DESC) -> Detect:
    """OpenCV's ORB (cv2 imported here)."""
    import cv2

    orb = cv2.ORB_create(nfeatures=n_features)

    def detect(image):
        gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY) if image.ndim == 3 else image
        kps, desc = orb.detectAndCompute(gray, None)
        if desc is None:
            return np.zeros((0, 2), np.float32), np.zeros((0, 32), np.uint8)
        return np.array([k.pt for k in kps], np.float32).reshape(-1, 2), desc

    return detect


class OrbRetrieval:
    """Per-frame keypoints + loop-candidate retrieval. ``detect``: the
    detector; None is OpenCV's ORB, created at the first ``insert_image``
    (building without OpenCV and without a detector raises)."""

    def __init__(self, n_features: int = MAX_DESC, thresh: float = 0.04, window: int = 3,
                 detect: Optional[Detect] = None):
        if detect is None and not opencv_available():
            raise RuntimeError("classic loop closure needs OpenCV (cv2) for its ORB detector, "
                               "or a detect(image) -> (pts, desc) function")
        self.n_features = n_features
        self.detect = detect
        self.lib = _lib()
        self.db = self.lib.retrieval_create()
        self.descs: List[np.ndarray] = []   # kept for matching and rebuilds
        self.kps: List[np.ndarray] = []     # [n,2] pixel coords per frame
        self.thresh = thresh
        self.window = window
        self.hits: List[Tuple[int, int]] = []   # consecutive (query, result)
        self.closures: List[Tuple[int, int]] = []

    # ---- indexing ----

    def insert_image(self, image: np.ndarray):
        """Detect and add to the database."""
        if self.detect is None:
            self.detect = orb_detector(self.n_features)
        pts, desc = self.detect(image)
        desc = np.ascontiguousarray(np.asarray(desc, np.uint8).reshape(-1, 32)[:MAX_DESC])
        pts = np.asarray(pts, np.float32).reshape(-1, 2)[:MAX_DESC]
        self.descs.append(desc)
        self.kps.append(pts)
        self.lib.retrieval_insert(self.db, desc.tobytes(), len(desc))

    def remove(self, k: int):
        """Drop frame k and renumber the later frames and the closures."""
        if k >= len(self.descs):
            return
        del self.descs[k]
        del self.kps[k]
        # rebuild the native database without k (the descriptors are kept here)
        self.lib.retrieval_destroy(self.db)
        self.db = self.lib.retrieval_create()
        for d in self.descs:
            self.lib.retrieval_insert(self.db, d.tobytes(), len(d))
        self.closures = [(a - (a > k), b - (b > k)) for a, b in self.closures]

    def n_frames(self) -> int:
        return len(self.descs)

    # ---- retrieval ----

    def query(self, i: int) -> Tuple[int, float]:
        """Best matching frame at least RADIUS older than i; (-1, 0) if none."""
        max_index = i - RADIUS
        if max_index < 0 or len(self.descs[i]) == 0:
            return -1, 0.0
        n = len(self.descs)
        scores = (ctypes.c_float * n)()
        self.lib.retrieval_query(self.db, self.descs[i].tobytes(), len(self.descs[i]), max_index,
                                 scores)
        scores = np.frombuffer(scores, np.float32, n).copy()
        best = int(np.argmax(scores))
        return (best, float(scores[best])) if scores[best] > 0 else (-1, 0.0)

    def detect_loop(self, i: int) -> Optional[Tuple[int, int]]:
        """Require `window` consecutive consistent hits, and none near an
        accepted closure."""
        j, score = self.query(i)
        if j < 0 or score < self.thresh:
            self.hits.clear()
            return None
        if self.hits and abs(self.hits[-1][1] - j) > 10:
            self.hits.clear()
        self.hits.append((i, j))
        if len(self.hits) < self.window:
            return None
        cand = self.hits[-1]
        self.hits.clear()
        for (qi, _) in self.closures:
            if abs(cand[0] - qi) < RADIUS:
                return None
        self.closures.append(cand)
        return cand

    # ---- matching ----

    def match(self, i: int, j: int, ratio: float = 0.8):
        """Ratio-test hamming matches i -> j: (pts_i, pts_j, idx_i, idx_j)."""
        a, b = self.descs[i], self.descs[j]
        if len(a) == 0 or len(b) == 0:
            z = np.zeros((0, 2), np.float32)
            return z, z, np.zeros(0, np.int32), np.zeros(0, np.int32)
        na, nb = len(a), len(b)
        bi, b1, b2 = ((ctypes.c_int32 * na)() for _ in range(3))
        self.lib.retrieval_match(a.tobytes(), na, b.tobytes(), nb, bi, b1, b2)
        bi, b1, b2 = (np.frombuffer(x, np.int32, na) for x in (bi, b1, b2))
        ok = (b1 < ratio * np.maximum(b2, 1)) & (bi >= 0)
        ia = np.nonzero(ok)[0].astype(np.int32)
        ib = bi[ok].astype(np.int32)
        return self.kps[i][ia], self.kps[j][ib], ia, ib
