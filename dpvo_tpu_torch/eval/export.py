"""Trajectory / point-cloud export — a copy of ``dpvo_tpu/eval/export.py``
(the same bytes for the same inputs): TUM-format trajectories, PLY point
clouds, COLMAP text models, and trajectory plots, which need matplotlib
(imported where they are drawn).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from dpvo_tpu_torch.utils import optional


def save_trajectory_tum(path: str, poses: np.ndarray, tstamps: np.ndarray):
    """poses [N,7] camera-to-world (x y z qx qy qz qw), TUM format."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for t, p in zip(tstamps, poses):
            f.write(f"{t} " + " ".join(f"{v:.9f}" for v in p) + "\n")


def save_ply(path: str, points: np.ndarray, colors: np.ndarray):
    """ASCII PLY export (ref plot_utils.py:59-64)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    ok = np.isfinite(points).all(1) & (np.abs(points) < 1e6).all(1)
    pts, clr = points[ok], colors[ok]
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, c in zip(pts, clr):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {int(c[0])} {int(c[1])} {int(c[2])}\n")


def save_colmap(outdir: str, poses_w2c: np.ndarray, intrinsics: np.ndarray,
                points: np.ndarray, colors: np.ndarray, ht: int, wd: int):
    """COLMAP text-model export (ref plot_utils.py:34-57): cameras.txt,
    images.txt (world-to-camera qw qx qy qz tx ty tz), points3D.txt."""
    os.makedirs(outdir, exist_ok=True)
    fx, fy, cx, cy = intrinsics[:4]
    with open(os.path.join(outdir, "cameras.txt"), "w") as f:
        f.write(f"1 PINHOLE {wd} {ht} {fx} {fy} {cx} {cy}\n")
    with open(os.path.join(outdir, "images.txt"), "w") as f:
        for i, p in enumerate(poses_w2c):
            tx, ty, tz, qx, qy, qz, qw = p
            f.write(f"{i+1} {qw} {qx} {qy} {qz} {tx} {ty} {tz} 1 frame_{i:06d}\n\n")
    ok = np.isfinite(points).all(1) & (np.abs(points) < 1e6).all(1)
    with open(os.path.join(outdir, "points3D.txt"), "w") as f:
        for i, (p, c) in enumerate(zip(points[ok], colors[ok])):
            f.write(f"{i+1} {p[0]} {p[1]} {p[2]} {int(c[0])} {int(c[1])} {int(c[2])} 0\n")


def plot_trajectory(path: str, poses: np.ndarray, gt: np.ndarray = None, title: str = ""):
    """Top-down trajectory plot (ref plot_utils.py:11-32)."""
    plt = optional.pyplot("plot_trajectory")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(poses[:, 0], poses[:, 2], "b-", lw=1, label="estimate")
    if gt is not None:
        ax.plot(gt[:, 0], gt[:, 2], "k--", lw=1, label="ground truth")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.savefig(path, dpi=120)
    plt.close(fig)
