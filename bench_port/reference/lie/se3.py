"""SE(3) rigid transforms as (t, q) 7-vectors — plain tensor functions.

Port of ``dpvo_tpu/lie/se3.py``: storage ``(tx, ty, tz, qx, qy, qz, qw)``,
``poses[i]`` maps world into camera i, relative motion
``G_ij = poses[j] * inv(poses[i])``.
"""

from __future__ import annotations

import torch

from bench_port.reference.lie import so3


def identity(shape=(), dtype=torch.float32, device=None):
    g = torch.zeros(shape + (7,), dtype=dtype, device=device)
    g[..., 6] = 1.0
    return g


def t_of(g):
    return g[..., :3]


def q_of(g):
    return g[..., 3:7]


def make(t, q):
    return torch.cat([t, q], dim=-1)


def mul(g1, g2):
    """Compose: (t1,q1) * (t2,q2) = (t1 + R1 t2, q1 q2)."""
    t = t_of(g1) + so3.quat_rotate(q_of(g1), t_of(g2))
    q = so3.quat_mul(q_of(g1), q_of(g2))
    return make(t, q)


def inv(g):
    qi = so3.quat_inv(q_of(g))
    return make(-so3.quat_rotate(qi, t_of(g)), qi)


def act(g, p):
    """Apply to 3-D points [...,3]."""
    return so3.quat_rotate(q_of(g), p) + t_of(g)


def act4(g, X):
    """Apply to homogeneous points [...,4]: X' = (R x + w t, w)."""
    xyz = so3.quat_rotate(q_of(g), X[..., :3]) + X[..., 3:4] * t_of(g)
    return torch.cat([xyz, X[..., 3:4]], dim=-1)


def _coeffs(theta_sq):
    """Taylor-safe (A, B, C) = (sin th/th, (1-cos th)/th^2, (th - sin th)/th^3).

    Below 0.05 rad the closed forms lose everything to f32 cancellation,
    while the series are already ~theta^4 accurate (as in the reference
    package)."""
    theta = torch.sqrt(torch.clamp(theta_sq, min=0.0))
    small = theta < 0.05
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    safe_th = torch.sqrt(safe_sq)
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe_th) / safe_th)
    B = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe_th)) / safe_sq)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (safe_th - torch.sin(safe_th)) / (safe_sq * safe_th))
    return A, B, C


def exp(xi):
    """se(3) -> SE(3). xi = (tau, phi) [...,6] -> (t, q) [...,7]."""
    tau, phi = xi[..., :3], xi[..., 3:6]
    q = so3.exp(phi)
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    _, B, C = _coeffs(theta_sq)
    p1 = so3.cross(phi, tau)
    p2 = so3.cross(phi, p1)
    t = tau + B * p1 + C * p2
    return make(t, q)


def log(g):
    """SE(3) -> se(3): (t,q) -> (tau, phi) with tau = V^{-1} t."""
    phi = so3.log(q_of(g))
    t = t_of(g)
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=0.0))
    A, B, _ = _coeffs(theta_sq)
    small = theta < 0.05
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    coef = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0, (1.0 - A / (2.0 * B)) / safe_sq)
    p1 = so3.cross(phi, t)
    p2 = so3.cross(phi, p1)
    tau = t - 0.5 * p1 + coef * p2
    return torch.cat([tau, phi], dim=-1)


def retr(g, xi):
    """Manifold retraction: Exp(xi) * g."""
    return mul(exp(xi), g)


def scale(g, s):
    """Scale the translation by s, which broadcasts over the leading axes."""
    return make(t_of(g) * torch.as_tensor(s, dtype=g.dtype, device=g.device)[..., None], q_of(g))


def adjT(g, a):
    """Apply Adj(g)^T to a cotangent row-vector a [...,6]."""
    R = so3.to_matrix(q_of(g))
    tx = so3.hat(t_of(g))
    a1, a2 = a[..., :3], a[..., 3:6]
    Rt = R.transpose(-1, -2)
    b1 = (Rt @ a1[..., None])[..., 0]
    b2 = (Rt @ (tx.transpose(-1, -2) @ a1[..., None]))[..., 0] + (Rt @ a2[..., None])[..., 0]
    return torch.cat([b1, b2], dim=-1)


def to_matrix(g):
    """(t,q) -> homogeneous [...,4,4]."""
    R = so3.to_matrix(q_of(g))
    t = t_of(g)[..., None]
    top = torch.cat([R, t], dim=-1)
    bot = torch.zeros_like(top[..., :1, :])
    bot[..., 0, 3] = 1.0
    return torch.cat([top, bot], dim=-2)
