"""Projective geometry for patch-based VO — plain tensor functions.

Port of ``dpvo_tpu/geom/projective.py``. Shapes are edge-major:

  poses       [N, 7] SE(3), or [N, 8] Sim(3) (t, q, s)
  patches     [Mtot, 3, P, P]    (x, y, inverse-depth planes)
  intrinsics  [N, 4]             (fx, fy, cx, cy)
  ii, jj, kk  [E] int            source frame / target frame / patch
"""

from __future__ import annotations

import torch

from bench_port.reference.lie import se3, sim3

MIN_DEPTH_Z = 0.2


def iproj(patches, intrinsics):
    """patches [E,3,P,P], intrinsics [E,4] -> homogeneous [E,P,P,4]."""
    x, y, d = patches[:, 0], patches[:, 1], patches[:, 2]
    fx, fy, cx, cy = [intrinsics[:, k, None, None] for k in range(4)]
    xn = (x - cx) / fx
    yn = (y - cy) / fy
    return torch.stack([xn, yn, torch.ones_like(d), d], dim=-1)


def proj(X, intrinsics, depth: bool = False):
    """X [E,P,P,4], intrinsics [E,4] -> [E,P,P,2 or 3]."""
    Z = X[..., 2]
    fx, fy, cx, cy = [intrinsics[:, k, None, None] for k in range(4)]
    d = 1.0 / torch.clamp(Z, min=0.1)
    x = fx * (d * X[..., 0]) + cx
    y = fy * (d * X[..., 1]) + cy
    if depth:
        return torch.stack([x, y, d], dim=-1)
    return torch.stack([x, y], dim=-1)


def transform(poses, patches, intrinsics, ii, jj, kk, jacobian: bool = False,
              valid: bool = False, tonly: bool = False, depth=None):
    """Reproject patch kk from frame ii into frame jj.

    Returns coords [E,P,P,2]; with ``valid`` also an [E] float mask
    (Z > 0.2 at the patch centre); with ``jacobian`` also the analytic
    (Ji [E,2,6], Jj [E,2,6], Jz [E,2,1]) at the patch centre. ``depth``
    [Mtot] overrides the depth plane with the live inverse depth. Sim(3)
    poses [N, 8] give Ji / Jj of [E,2,7], the 7th column the scale's.
    """
    is_sim3 = poses.shape[-1] == 8
    grp = sim3 if is_sim3 else se3
    pk = patches[kk]
    if depth is not None:
        pk = torch.cat([pk[:, :2], depth[kk][:, None, None, None].expand_as(pk[:, 2:])], dim=1)
    X0 = iproj(pk, intrinsics[ii])

    Gij = grp.mul(poses[jj], grp.inv(poses[ii]))
    if tonly:
        unit_q = torch.zeros_like(se3.q_of(Gij))
        unit_q[:, 3] = 1.0
        if is_sim3:
            Gij = sim3.make(sim3.t_of(Gij), unit_q, torch.ones_like(sim3.s_of(Gij)))
        else:
            Gij = se3.make(se3.t_of(Gij), unit_q)

    X1 = grp.act4(Gij[:, None, None, :], X0)
    x1 = proj(X1, intrinsics[jj])

    P = patches.shape[-1]
    c = P // 2
    Xc, Yc, Zc, Hc = [X1[:, c, c, k] for k in range(4)]
    val = (Zc > MIN_DEPTH_Z).to(x1.dtype)

    if not jacobian:
        if valid:
            return x1, val
        return x1

    fx, fy = intrinsics[jj, 0], intrinsics[jj, 1]
    o = torch.zeros_like(Hc)
    big = torch.abs(Zc) > MIN_DEPTH_Z
    d = torch.where(big, 1.0 / torch.where(big, Zc, torch.ones_like(Zc)), o)

    # d X1 / d xi_j of the 4 homogeneous coordinates; Sim(3) adds the
    # scale's column (X, Y, Z, 0)
    if is_sim3:
        Ja = torch.stack(
            [
                Hc, o, o, o, Zc, -Yc, Xc,
                o, Hc, o, -Zc, o, Xc, Yc,
                o, o, Hc, Yc, -Xc, o, Zc,
                o, o, o, o, o, o, o,
            ],
            dim=-1,
        ).reshape(-1, 4, 7)
    else:
        Ja = torch.stack(
            [
                Hc, o, o, o, Zc, -Yc,
                o, Hc, o, -Zc, o, Xc,
                o, o, Hc, Yc, -Xc, o,
                o, o, o, o, o, o,
            ],
            dim=-1,
        ).reshape(-1, 4, 6)
    Jp = torch.stack(
        [
            fx * d, o, -fx * Xc * d * d, o,
            o, fy * d, -fy * Yc * d * d, o,
        ],
        dim=-1,
    ).reshape(-1, 2, 4)

    Jj = Jp @ Ja
    Ji = -grp.adjT(Gij[:, None, :], Jj)
    Tcol = grp.to_matrix(Gij)[..., :, 3]
    Jz = Jp @ Tcol[..., None]
    return x1, val, (Ji, Jj, Jz)


def flow_mag(poses, patches, intrinsics, ii, jj, kk, beta: float = 0.3, depth=None):
    """Blended full/translation-only flow magnitude.

    Returns ([E,P,P], [E] bool)."""
    coords0 = transform(poses, patches, intrinsics, ii, ii, kk, depth=depth)
    coords1, val = transform(poses, patches, intrinsics, ii, jj, kk, valid=True, depth=depth)
    coords2 = transform(poses, patches, intrinsics, ii, jj, kk, tonly=True, depth=depth)
    flow1 = torch.linalg.norm(coords1 - coords0, dim=-1)
    flow2 = torch.linalg.norm(coords2 - coords0, dim=-1)
    return beta * flow1 + (1 - beta) * flow2, val > 0.5
