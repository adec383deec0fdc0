"""RGB-D dataset helpers: TUM-format loading + pose distance matrices — a
copy of ``dpvo_tpu/data/rgbd_utils.py`` (the flow distance matrix lives
in ``data/tartan.py``). The SE(3) math is ``utils/npse3``: numpy, safe in
data-loader processes.
"""

from __future__ import annotations

import os.path as osp
from typing import List, Optional, Tuple

import numpy as np

from dpvo_tpu_torch.utils import npse3


def parse_list(filepath: str, skiprows: int = 0) -> np.ndarray:
    """Whitespace table with '#' comments -> object array."""
    return np.loadtxt(filepath, delimiter=" ", dtype=str,
                      skiprows=skiprows, comments="#")


def associate_frames(tstamp_image, tstamp_depth, tstamp_pose, max_dt: float = 1.0):
    """Nearest-timestamp association image->(depth, pose)
    (ref rgbd_utils.py:14-31)."""
    associations = []
    for i, t in enumerate(tstamp_image):
        j = int(np.argmin(np.abs(tstamp_depth - t)))
        k = int(np.argmin(np.abs(tstamp_pose - t)))
        if abs(tstamp_depth[j] - t) < max_dt and abs(tstamp_pose[k] - t) < max_dt:
            associations.append((i, j, k))
    return associations


def loadtum(datapath: str, frame_rate: int = -1):
    """Read a TUM-RGBD sequence directory; returns (image paths, depth
    paths, poses [t, q], intrinsics, tstamps) subsampled 1-in-5
    (ref rgbd_utils.py:33-87)."""
    if osp.isfile(osp.join(datapath, "groundtruth.txt")):
        pose_list = osp.join(datapath, "groundtruth.txt")
    elif osp.isfile(osp.join(datapath, "pose.txt")):
        pose_list = osp.join(datapath, "pose.txt")
    else:
        return None, None, None, None, None

    image_data = parse_list(osp.join(datapath, "rgb.txt"))
    depth_data = parse_list(osp.join(datapath, "depth.txt"))
    pose_data = parse_list(pose_list, skiprows=1)
    pose_vecs = pose_data[:, 1:].astype(np.float64)

    calib_path = osp.join(datapath, "calibration.txt")
    intrinsic = None
    if osp.isfile(calib_path):
        intrinsic = np.loadtxt(calib_path, delimiter=" ").astype(np.float64)

    t_img = image_data[:, 0].astype(np.float64)
    t_dep = depth_data[:, 0].astype(np.float64)
    t_pos = pose_data[:, 0].astype(np.float64)
    assoc = associate_frames(t_img, t_dep, t_pos)

    images, depths, poses, intrinsics, tstamps = [], [], [], [], []
    for ix in range(len(assoc))[::5]:
        i, j, k = assoc[ix]
        images.append(osp.join(datapath, image_data[i, 1]))
        depths.append(osp.join(datapath, depth_data[j, 1]))
        poses.append(pose_vecs[k])
        tstamps.append(t_img[i])
        if intrinsic is not None:
            intrinsics.append(intrinsic)
    return images, depths, poses, intrinsics, tstamps


def all_pairs_distance_matrix(poses: np.ndarray, beta: float = 2.5) -> np.ndarray:
    """||Log(P_i^-1 P_j)|| over all pose pairs, translations scaled by
    beta to balance rotation vs translation (ref rgbd_utils.py:89-96)."""
    poses = np.asarray(poses, np.float64).copy()
    poses[:, :3] *= beta
    n = len(poses)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    rel = npse3.mul(npse3.inv(poses[ii.reshape(-1)]), poses[jj.reshape(-1)])
    r = npse3.log(rel)
    return np.linalg.norm(r, axis=-1).reshape(n, n).astype(np.float32)


def pose_matrix_to_quaternion(pose: np.ndarray) -> np.ndarray:
    """[4,4] pose matrix -> (t, qx qy qz qw) [7]."""
    q = npse3.rotmat_to_quat(pose[:3, :3])
    return np.concatenate([pose[:3, 3], q])
