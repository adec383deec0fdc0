"""Batched NumPy SE(3) helpers for host-side data pipelines — a copy of
``dpvo_tpu/utils/npse3.py``, kept here so the port imports nothing of the
JAX package.

The data readers (covisibility graph, clip sampling), the viewer and
``data/rgbd_utils`` run on the host, in loader threads or processes that
must not touch the card. Conventions match ``lie/se3``: pose = (tx,ty,tz,
qx,qy,qz,qw).
"""

from __future__ import annotations

import numpy as np


def quat_rotmat(q: np.ndarray) -> np.ndarray:
    """[..., 4] (x,y,z,w) -> [..., 3, 3]."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), q.dtype)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def inv(g: np.ndarray) -> np.ndarray:
    """[..., 7] -> [..., 7]."""
    q = g[..., 3:7]
    qi = q * np.array([-1.0, -1.0, -1.0, 1.0], g.dtype)
    Ri = quat_rotmat(qi)
    ti = -np.einsum("...ij,...j->...i", Ri, g[..., :3])
    return np.concatenate([ti, qi], axis=-1)


def mul(g1: np.ndarray, g2: np.ndarray) -> np.ndarray:
    """[..., 7] x [..., 7] -> [..., 7]."""
    R1 = quat_rotmat(g1[..., 3:7])
    t = g1[..., :3] + np.einsum("...ij,...j->...i", R1, g2[..., :3])
    q = quat_mul(g1[..., 3:7], g2[..., 3:7])
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([t, q], axis=-1)


def quat_log(q: np.ndarray) -> np.ndarray:
    """[..., 4] unit quaternion -> [..., 3] rotation vector (atan2-
    based, f64-stable near identity)."""
    u = q[..., :3]
    w = q[..., 3]
    un = np.linalg.norm(u, axis=-1)
    theta = 2.0 * np.arctan2(un, np.abs(w))
    sign = np.where(w < 0, -1.0, 1.0)
    small = un < 1e-9
    scale = np.where(small, 2.0 * sign, sign * theta / np.where(small, 1.0, un))
    return u * scale[..., None]


def log(g: np.ndarray) -> np.ndarray:
    """SE(3) log: [..., 7] -> [..., 6] (tau, phi); series-switched V^-1
    like lie/se3.log."""
    phi = quat_log(g[..., 3:7])
    t = g[..., :3]
    theta_sq = np.sum(phi * phi, axis=-1)
    theta = np.sqrt(theta_sq)
    small = theta < 1e-4  # f64: cancellation starts ~1e-8
    safe_sq = np.where(small, 1.0, theta_sq)
    A = np.sin(theta) / np.where(theta > 0, theta, 1.0)
    B = (1.0 - np.cos(theta)) / safe_sq
    coef = np.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                    (1.0 - A / np.where(small, 1.0, 2.0 * B)) / safe_sq)
    p1 = np.cross(phi, t)
    p2 = np.cross(phi, p1)
    tau = t - 0.5 * p1 + coef[..., None] * p2
    return np.concatenate([tau, phi], axis=-1)


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """[3, 3] rotation matrix -> (qx, qy, qz, qw), Shepperd-stable."""
    t = np.trace(R)
    if t > 0:
        w = np.sqrt(1.0 + t) / 2
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        xyz = np.empty(3)
        xyz[i] = s / 4
        xyz[j] = (R[j, i] + R[i, j]) / s
        xyz[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = xyz
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)
