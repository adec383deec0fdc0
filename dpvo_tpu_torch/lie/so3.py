"""SO(3) as unit quaternions (x, y, z, w) — plain tensor functions.

Port of ``dpvo_tpu/lie/so3.py``; same storage convention and the same
small-angle branches (selected with ``torch.where`` on both sides so
gradients stay finite at theta == 0).
"""

from __future__ import annotations

import torch

from dpvo_tpu_torch.utils import trace

_EPS = 1e-8


def quat_mul(q1, q2):
    """Hamilton product, (x,y,z,w) convention."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_inv(q):
    """Conjugate (assumes unit quaternion). The sign vector is a blocking
    copy from host memory where q is on a card."""
    with trace.blocked("upload", "quat_inv", q.device):
        sign = q.new_tensor([-1.0, -1.0, -1.0, 1.0])
    return q * sign


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v [...,3] by unit quaternions q [...,4]."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def exp(phi):
    """so(3) -> SO(3): rotation vector [...,3] to quaternion [...,4]."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta_sq < _EPS
    safe_th = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(0.5 * safe_th) / safe_th)
    real = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(0.5 * safe_th))
    return torch.cat([k * phi, real], dim=-1)


def log(q):
    """SO(3) -> so(3): quaternion to rotation vector [...,3]."""
    u = q[..., :3]
    w = q[..., 3:4]
    norm_sq = torch.sum(u * u, dim=-1, keepdim=True)
    small = norm_sq < _EPS * _EPS
    safe_norm = torch.sqrt(torch.where(small, torch.ones_like(norm_sq), norm_sq))
    theta = 2.0 * torch.atan2(safe_norm, torch.abs(w))
    sign = torch.where(w < 0, -torch.ones_like(w), torch.ones_like(w))
    scale = torch.where(small, 2.0 * sign, sign * theta / safe_norm)
    return u * scale


def to_matrix(q):
    """Unit quaternion [...,4] -> rotation matrix [...,3,3]."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def hat(phi):
    """[...,3] -> skew-symmetric [...,3,3]."""
    x, y, z = phi.unbind(-1)
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(phi.shape[:-1] + (3, 3))
