"""Sim(3) similarity transforms as (t, q, s) 8-vectors — plain tensor
functions.

Port of ``dpvo_tpu/lie/sim3.py``: storage ``(tx, ty, tz, qx, qy, qz, qw, s)``,
manifold dimension 7 with tangent layout ``(tau, phi, sigma)``, group
action x' = s R x + t. Used by the Sim(3) branch of the projective
transform and by the pose-graph optimizer (``slam/pgo.py``), which
differentiates ``exp``, ``log`` and ``mul`` in forward mode: every
function here is free of in-place writes and host reads, and every
closed-form denominator is selected away from zero (``torch.where`` on
a safe value), so no branch that is not taken makes a tangent NaN. The
scale is carried with a trailing axis of 1 inside (``_s``): under
``vmap`` a per-element scale would be a 0-d tensor, and torch's forward
mode gives a 0-d tensor combined with a Python float a float64 tangent.
"""

from __future__ import annotations

import torch

from bench_port.reference.lie import so3

# small-angle/-scale switch of _calc_W: the closed forms divide
# cancellation-prone differences (1 - cos theta, e^sigma - 1) by theta^2 or
# sigma; in f32 those lose all precision below ~0.03, where the series are
# already ~1e-5 accurate
_EPS = 0.03


def identity(shape=(), dtype=torch.float32, device=None):
    g = torch.zeros(shape + (8,), dtype=dtype, device=device)
    g[..., 6] = 1.0
    g[..., 7] = 1.0
    return g


def t_of(g):
    return g[..., :3]


def q_of(g):
    return g[..., 3:7]


def s_of(g):
    return g[..., 7]


def _s(g):
    return g[..., 7:8]


def make(t, q, s):
    return torch.cat([t, q, s[..., None]], dim=-1)


def from_se3(g7, s=None):
    """Embed an SE(3) 7-vector with unit (or given) scale."""
    if s is None:
        s = torch.ones(g7.shape[:-1], dtype=g7.dtype, device=g7.device)
    return torch.cat([g7, s[..., None]], dim=-1)


def to_se3(g):
    """Drop the scale."""
    return g[..., :7]


def mul(g1, g2):
    t = t_of(g1) + _s(g1) * so3.quat_rotate(q_of(g1), t_of(g2))
    q = so3.quat_mul(q_of(g1), q_of(g2))
    return torch.cat([t, q, _s(g1) * _s(g2)], dim=-1)


def inv(g):
    qi = so3.quat_inv(q_of(g))
    si = 1.0 / _s(g)
    return torch.cat([-si * so3.quat_rotate(qi, t_of(g)), qi, si], dim=-1)


def act(g, p):
    return _s(g) * so3.quat_rotate(q_of(g), p) + t_of(g)


def act4(g, X):
    """Homogeneous action on (x, y, z, w = inverse depth): (sRx + w t, w)."""
    xyz = _s(g) * so3.quat_rotate(q_of(g), X[..., :3]) + X[..., 3:4] * t_of(g)
    return torch.cat([xyz, X[..., 3:4]], dim=-1)


def _calc_W(phi, sigma):
    """W of the Sim(3) exponential, t = W tau: A [phi]x + B [phi]x^2 + C I,
    with the closed forms and their series near theta = 0 and/or sigma = 0.
    phi [..., 3], sigma [..., 1]."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=0.0))
    scale = torch.exp(sigma)

    small_t = theta < _EPS
    small_s = torch.abs(sigma) < _EPS
    one = torch.ones_like(theta)
    th = torch.where(small_t, one, theta)
    th_sq = th * th
    sg = torch.where(small_s, one, sigma)
    sg_sq = sg * sg

    # C = (e^sigma - 1) / sigma
    C = torch.where(small_s, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (scale - 1.0) / sg)

    a = scale * torch.sin(th)
    b = scale * torch.cos(th)
    c = th_sq + sg_sq

    A_gen = (a * sg + (1.0 - b) * th) / (th * c)
    B_gen = (C - ((b - 1.0) * sg + a * th) / c) / th_sq
    A_ssmall = (1.0 - torch.cos(th)) / th_sq
    B_ssmall = (th - torch.sin(th)) / (th_sq * th)
    A_tsmall = ((sg - 1.0) * scale + 1.0) / sg_sq
    B_tsmall = ((0.5 * sg_sq - sg + 1.0) * scale - 1.0 - 0.5 * sg_sq) / (sg_sq * sg)
    A_both = 0.5 + sigma / 6.0
    B_both = 1.0 / 6.0 + sigma / 24.0

    A = torch.where(small_s, torch.where(small_t, A_both, A_ssmall),
                    torch.where(small_t, A_tsmall, A_gen))
    B = torch.where(small_s, torch.where(small_t, B_both, B_ssmall),
                    torch.where(small_t, B_tsmall, B_gen))

    Px = so3.hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(Px.shape)
    return A[..., None] * Px + B[..., None] * (Px @ Px) + C[..., None] * eye


def exp(xi):
    """sim(3) -> Sim(3): xi = (tau, phi, sigma) [..., 7]."""
    tau, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    W = _calc_W(phi, sigma)
    t = (W @ tau[..., None])[..., 0]
    return torch.cat([t, so3.exp(phi), torch.exp(sigma)], dim=-1)


def log(g):
    """Sim(3) -> sim(3): the inverse of exp, tau = W^-1 t. W^-1 comes from
    ``torch.linalg.inv``: under ``vmap(jacfwd)`` (the PGO's Jacobians)
    torch 2.13's ``linalg.solve`` (and ``solve_ex``, ``lu_solve``) gives
    every row but the first a wrong tangent, while ``inv`` is right
    (``tests/test_torch_sim3.py`` holds the batched Jacobian of ``log``
    to the per-row one)."""
    phi = so3.log(q_of(g))
    sigma = torch.log(_s(g))
    W = _calc_W(phi, sigma)
    tau = (torch.linalg.inv(W) @ t_of(g)[..., None])[..., 0]
    return torch.cat([tau, phi, sigma], dim=-1)


def retr(g, xi):
    return mul(exp(xi), g)


def to_matrix(g):
    """(t, q, s) -> homogeneous [..., 4, 4] with the scaled rotation."""
    R = so3.to_matrix(q_of(g)) * _s(g)[..., None]
    top = torch.cat([R, t_of(g)[..., None]], dim=-1)
    bot = torch.zeros_like(top[..., :1, :])
    bot = torch.cat([bot[..., :3], torch.ones_like(bot[..., 3:])], dim=-1)
    return torch.cat([top, bot], dim=-2)


def adjT(g, a):
    """Adj(g)^T applied to a cotangent row-vector a [..., 7] (tau, phi,
    sigma); Adj = [[s R, [t]x R, -t], [0, R, 0], [0, 0, 1]]."""
    Rt = so3.to_matrix(q_of(g)).transpose(-1, -2)
    txT = so3.hat(t_of(g)).transpose(-1, -2)
    s = _s(g)
    a1, a2, a3 = a[..., :3], a[..., 3:6], a[..., 6:7]
    b1 = s * (Rt @ a1[..., None])[..., 0]
    b2 = (Rt @ (txT @ a1[..., None]))[..., 0] + (Rt @ a2[..., None])[..., 0]
    b3 = -torch.sum(t_of(g) * a1, dim=-1, keepdim=True) + a3
    return torch.cat([b1, b2, b3], dim=-1)
