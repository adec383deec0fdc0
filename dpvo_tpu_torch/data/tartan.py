"""TartanAir dataset reader — port of ``dpvo_tpu/data/tartan.py`` (numpy;
the same clips as the JAX package's for the same seed: its walk draws
from ``np.random.default_rng(seed)`` in the same order).

Re-design of dpvo/data_readers/tartan.py + base.py: scans scene
directories (image_left/*.png, depth_left/*.npy, pose_left.txt),
converts NED poses to the camera xyz convention (tartan.py:82), builds a
covisibility frame graph from pairwise optical-flow distance
(base.py:64-82, rgbd_utils.py:103-141), and samples n_frames clips by
walking the graph with flow bounds fmin=10 < d < fmax=75 (base.py:84-169)
with depth normalization s = 0.7 * quantile98 (base.py:165-167).
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Dict, List

import numpy as np

from dpvo_tpu_torch.utils import npse3, optional

DEPTH_SCALE = 5.0  # ref tartan.py:56
FX = FY = 320.0    # TartanAir pinhole
CX, CY = 320.0, 240.0

# The published 32-sequence TartanAir validation split (benchmark data,
# ref tartan.py:16-50)
VAL_SPLIT_PREFIXES = tuple(
    f"{env}/{env}/{diff}/{seq}"
    for env, diff, seq in [
        ("abandonedfactory", "Easy", "P011"),
        ("abandonedfactory", "Hard", "P011"),
        ("abandonedfactory_night", "Easy", "P013"),
        ("abandonedfactory_night", "Hard", "P014"),
        ("amusement", "Easy", "P008"),
        ("amusement", "Hard", "P007"),
        ("carwelding", "Easy", "P007"),
        ("endofworld", "Easy", "P009"),
        ("gascola", "Easy", "P008"),
        ("gascola", "Hard", "P009"),
        ("hospital", "Easy", "P036"),
        ("hospital", "Hard", "P049"),
        ("japanesealley", "Easy", "P007"),
        ("japanesealley", "Hard", "P005"),
        ("neighborhood", "Easy", "P021"),
        ("neighborhood", "Hard", "P017"),
        ("ocean", "Easy", "P013"),
        ("ocean", "Hard", "P009"),
        ("office2", "Easy", "P011"),
        ("office2", "Hard", "P010"),
        ("office", "Hard", "P007"),
        ("oldtown", "Easy", "P007"),
        ("oldtown", "Hard", "P008"),
        ("seasidetown", "Easy", "P009"),
        ("seasonsforest", "Easy", "P011"),
        ("seasonsforest", "Hard", "P006"),
        ("seasonsforest_winter", "Easy", "P009"),
        ("seasonsforest_winter", "Hard", "P018"),
        ("soulcity", "Easy", "P012"),
        ("soulcity", "Hard", "P009"),
        ("westerndesert", "Easy", "P013"),
        ("westerndesert", "Hard", "P007"),
    ]
)


def ned_to_xyz(poses_ned: np.ndarray) -> np.ndarray:
    """TartanAir NED (x-fwd, y-right, z-down) -> camera convention
    (ref tartan.py:82: permutation [1, 2, 0, 4, 5, 3, 6])."""
    return poses_ned[:, [1, 2, 0, 4, 5, 3, 6]]


def scan_scene(scene_dir: str) -> Dict:
    scene = Path(scene_dir)
    images = sorted((scene / "image_left").glob("*.png"))
    depths = sorted((scene / "depth_left").glob("*.npy"))
    poses = np.loadtxt(scene / "pose_left.txt", delimiter=" ")
    assert len(images) == len(depths) == len(poses)
    return {
        "images": [str(p) for p in images],
        "depths": [str(p) for p in depths],
        "poses": ned_to_xyz(poses.astype(np.float32)),
        "intrinsics": np.array([FX, FY, CX, CY], np.float32),
    }


def _induced_flow(poses_w2c, xn, yn, disps_flat, intr, ii, jj):
    """Flow magnitude of grid points carried from frame ii to frame jj.

    Vectorized NumPy equivalent of the reference's chunked GPU loop
    (rgbd_utils.compute_distance_matrix_flow:103-141). xn/yn [m] are
    normalized image coordinates of the coarse grid (shared across
    frames); disps_flat [n, m] the matching inverse depths.
    Returns (flow [k, m], valid [k, m])."""
    fx, fy, cx, cy = intr
    G = npse3.mul(poses_w2c[jj], npse3.inv(poses_w2c[ii]))  # [k,7]
    R = npse3.quat_rotmat(G[:, 3:7])                        # [k,3,3]
    t = G[:, :3]                                            # [k,3]
    d = disps_flat[ii]                                      # [k,m]

    X0 = np.stack([xn, yn, np.ones_like(xn)], axis=-1)      # [m,3]
    X1 = np.einsum("kab,mb->kma", R, X0) + d[..., None] * t[:, None, :]
    Z = X1[..., 2]
    valid = Z > 0.2
    iz = 1.0 / np.where(valid, Z, 1.0)
    px = fx * X1[..., 0] * iz + cx
    py = fy * X1[..., 1] * iz + cy
    x0 = fx * xn + cx
    y0 = fy * yn + cy
    flow = np.hypot(px - x0[None], py - y0[None])
    return flow, valid


def flow_distance_matrix(poses_w2c: np.ndarray, disps: np.ndarray, intrinsics,
                         stride: int = 8, chunk: int = 2048, max_flow: float = 100.0):
    """Mean bidirectional optical-flow magnitude between all frame pairs
    on a coarse grid (ref rgbd_utils.compute_distance_matrix_flow):
    flow clamped at ``max_flow``, entries with <70% covisibility set to
    inf. Pure NumPy, chunked over pairs — a 500-frame scene takes
    seconds, not hours."""
    n, h, w = disps.shape
    ys, xs = np.mgrid[stride // 2 : h : stride, stride // 2 : w : stride]
    m = xs.size
    fx, fy, cx, cy = np.asarray(intrinsics, np.float64)
    xn = ((xs.reshape(-1) - cx) / fx).astype(np.float64)
    yn = ((ys.reshape(-1) - cy) / fy).astype(np.float64)
    disps_flat = disps[:, ys.reshape(-1), xs.reshape(-1)].astype(np.float64)
    poses64 = poses_w2c.astype(np.float64)

    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    D = np.zeros((n, n), np.float32)
    for s in range(0, len(ii), chunk):
        i1, j1 = ii[s : s + chunk], jj[s : s + chunk]
        f12, v12 = _induced_flow(poses64, xn, yn, disps_flat, intrinsics, i1, j1)
        f21, v21 = _induced_flow(poses64, xn, yn, disps_flat, intrinsics, j1, i1)
        mag = np.concatenate([np.minimum(f12, max_flow), np.minimum(f21, max_flow)], axis=1)
        val = np.concatenate([v12, v21], axis=1).astype(np.float64)
        cover = val.mean(-1)
        mean_mag = (mag * val).sum(-1) / np.maximum(val.sum(-1), 1.0)
        mean_mag[cover < 0.7] = np.inf
        D[i1, j1] = mean_mag
    return D


def build_frame_graph(poses_w2c, depth_paths, intrinsics, f: int = 16,
                      max_flow: float = 256.0, depth_read=None):
    """Covisibility graph {frame: (neighbor_ids, flow_dists)} from the
    flow-distance matrix at 1/f resolution (ref base.py:64-82)."""
    def _read(fn):
        d = np.load(fn) if depth_read is None else depth_read(fn)
        d = d[f // 2 :: f, f // 2 :: f].astype(np.float64)
        d[d < 0.01] = np.mean(d)
        return 1.0 / d

    disps = np.stack([_read(p) for p in depth_paths])
    intr = np.asarray(intrinsics, np.float64) / f
    # disps are already at 1/f resolution, so stride 1 over the coarse grid
    d = f * flow_distance_matrix(poses_w2c, disps, intr, stride=1)
    graph = {}
    for i in range(d.shape[0]):
        (j,) = np.where(d[i] < max_flow)
        graph[i] = (j, d[i, j])
    return graph


class TartanAirDataset:
    """Clip sampler over TartanAir scenes (ref base.py RGBDDataset)."""

    def __init__(self, root: str, n_frames: int = 15, fmin: float = 10.0, fmax: float = 75.0,
                 index_path: str = None, seed: int = 0, mode: str = "training"):
        self.root = root
        self.n_frames = n_frames
        self.fmin, self.fmax = fmin, fmax
        self.mode = mode
        self.rng = np.random.default_rng(seed)

        self.index_path = index_path or os.path.join(root, f"tartan_index_{mode}.pickle")
        if os.path.exists(self.index_path):
            with open(self.index_path, "rb") as f:
                self.scenes = pickle.load(f)
        else:
            self.scenes = self._build_index()
            if self.scenes:
                with open(self.index_path, "wb") as f:
                    pickle.dump(self.scenes, f)
            else:
                self.index_path = None

    def _build_index(self) -> List[Dict]:
        scenes = []
        for pose_file in sorted(Path(self.root).rglob("pose_left.txt")):
            scene_dir = pose_file.parent
            rel = os.path.relpath(str(scene_dir), self.root)
            in_val = any(rel.endswith(p) or p in rel for p in VAL_SPLIT_PREFIXES)
            # training excludes the 32 validation sequences (ref tartan.py:61-74)
            if (self.mode == "training") == in_val:
                continue
            try:
                info = scan_scene(str(scene_dir))
            except (AssertionError, OSError):
                continue
            # covisibility graph from pose/depth flow distance is built
            # lazily per scene on first sample (expensive)
            info["graph"] = None
            info["dir"] = str(scene_dir)
            scenes.append(info)
        return scenes

    def __len__(self):
        return max(len(self.scenes), 1) * 1000

    def _load_depth(self, path):
        d = np.load(path) / DEPTH_SCALE
        return np.where((d > 0.01) & np.isfinite(d), 1.0 / d, 0.0).astype(np.float32)

    def _scene_graph(self, scene) -> Dict:
        """Covisibility graph, built lazily on first use and cached in
        the on-disk index (ref base.py:40-62 pickle'd scene_info)."""
        if scene.get("graph") is None:
            scene["graph"] = build_frame_graph(
                npse3.inv(scene["poses"].astype(np.float64)),
                scene["depths"], scene["intrinsics"],
                depth_read=lambda p: np.load(p) / DEPTH_SCALE,
            )
            if self.index_path:
                with open(self.index_path, "wb") as f:
                    pickle.dump(self.scenes, f)
        return scene["graph"]

    def sample(self):
        """Returns (images [F,H,W,3] float, poses_w2c [F,7], disps [F,H,W],
        intrinsics [4]) — a covisibility-graph walk with flow bounds
        fmin < d < fmax (ref base.py:84-140)."""
        cv2 = optional.cv2("TartanAirDataset.sample")
        scene = self.scenes[self.rng.integers(len(self.scenes))]
        graph = self._scene_graph(scene)
        n_total = len(scene["images"])

        ix = int(self.rng.integers(0, n_total))
        idx = [ix]
        while len(idx) < self.n_frames:
            js, ds = graph[ix]
            k = (ds > self.fmin) & (ds < self.fmax)
            frames = js[k]
            fwd = frames[frames > ix]
            if len(fwd) > 0:
                ix = int(self.rng.choice(fwd))       # prefer forward in time
            elif ix + 1 < n_total:
                ix = ix + 1
            elif len(frames) > 0:
                ix = int(self.rng.choice(frames))
            idx.append(ix)

        images = np.stack([cv2.cvtColor(cv2.imread(scene["images"][i]), cv2.COLOR_BGR2RGB) for i in idx])
        disps = np.stack([self._load_depth(scene["depths"][i]) for i in idx])
        poses_c2w = scene["poses"][idx]
        poses_w2c = npse3.inv(poses_c2w.astype(np.float64)).astype(np.float32)

        # depth normalization (ref base.py:165-167): s = 0.7 * q98(disps)
        s = 0.7 * np.quantile(disps[disps > 0], 0.98) if (disps > 0).any() else 1.0
        disps = disps / s
        poses_w2c[:, :3] *= s
        return images.astype(np.float32), poses_w2c.astype(np.float32), disps, scene["intrinsics"].copy()
