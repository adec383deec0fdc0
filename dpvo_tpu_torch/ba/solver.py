"""Schur-complement sliding-window bundle adjustment — plain tensor code
around two kernels.

Port of ``dpvo_tpu/ba/solver.py``. System:

      [ B  E ] [ dX ]   [ v ]
      [ E^T C ] [ dZ ] = [ u ]

B: pose-pose blocks over the padded free window W; C: diagonal depth
Hessian over Md depth variables; S = B - E Q E^T with Q = (C+lambda)^-1,
damped S += I(lm*S + ep). The Gram products stay ``torch.matmul`` (the
JAX package leaves them to XLA); the depth reduction is
``ba/segsum.segment_sum`` and the pose solve ``ba/spd_solve.spd_solve``,
each a CUDA kernel on a card and its plain version on the CPU.
``t0`` and ``nfree`` are host integers, or 0-d int64 tensors on the
problem's device (the runtime's CUDA graph of the window BA,
``runtime/ba_graph.py``, where a host value would be baked into the
capture): then nothing reads them on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dpvo_tpu_torch.ba.segsum import segment_sum
from dpvo_tpu_torch.ba.spd_solve import spd_solve
from dpvo_tpu_torch.geom.projective import MIN_DEPTH_Z
from dpvo_tpu_torch.lie import se3, so3


class BAProblem(NamedTuple):
    poses: torch.Tensor        # [N,7]
    patch_ctr: torch.Tensor    # [Md,3] (x, y, inverse depth) at patch centres
    intrinsics: torch.Tensor   # [N,4]
    target: torch.Tensor       # [E,2]
    weight: torch.Tensor       # [E,2]
    valid: torch.Tensor        # [E] bool
    ii: torch.Tensor           # [E] source frame
    jj: torch.Tensor           # [E] target frame
    kd: torch.Tensor           # [E] dense depth-variable index in [0, Md)
    t0: int                    # first free pose (or a 0-d tensor, as nfree)
    nfree: int                 # number of free poses (<= W)
    kd_order: Optional[torch.Tensor] = None  # [E] stable argsort of kd


def _center_residuals(prob: BAProblem, bounds, res_clip: float):
    """Reprojection residual and closed-form Jacobians at patch centres,
    gated on ||r|| < res_clip, Z > 0.2 and the border around the image."""
    ctr = prob.patch_ctr[prob.kd]
    intr_i = prob.intrinsics[prob.ii]
    intr_j = prob.intrinsics[prob.jj]
    Gij = se3.mul(prob.poses[prob.jj], se3.inv(prob.poses[prob.ii]))
    q = se3.q_of(Gij)
    t = se3.t_of(Gij)

    d0 = ctr[:, 2]
    xn = (ctr[:, 0] - intr_i[:, 2]) / intr_i[:, 0]
    yn = (ctr[:, 1] - intr_i[:, 3]) / intr_i[:, 1]
    X0 = torch.stack([xn, yn, torch.ones_like(d0)], dim=-1)
    X1 = so3.quat_rotate(q, X0) + d0[:, None] * t
    X, Y, Z = X1[:, 0], X1[:, 1], X1[:, 2]
    H = d0

    fx, fy, cx, cy = (intr_j[:, k] for k in range(4))
    dz = 1.0 / torch.clamp(Z, min=0.1)
    x1 = fx * X * dz + cx
    y1 = fy * Y * dz + cy
    val = Z > MIN_DEPTH_Z

    r = prob.target - torch.stack([x1, y1], dim=-1)
    in_bounds = (x1 > bounds[0]) & (y1 > bounds[1]) & (x1 < bounds[2]) & (y1 < bounds[3])
    ok = (torch.linalg.norm(r, dim=-1) < res_clip) & val & in_bounds & prob.valid
    w = prob.weight * ok[:, None].to(prob.weight.dtype)

    big = torch.abs(Z) > MIN_DEPTH_Z
    d = torch.where(big, 1.0, 0.0) / torch.where(big, Z, torch.ones_like(Z))
    a0 = fx * d
    a2 = -fx * X * d * d
    b1 = fy * d
    b2 = -fy * Y * d * d
    o = torch.zeros_like(H)
    Jj0 = torch.stack([a0 * H, o, a2 * H, a2 * Y, a0 * Z - a2 * X, -a0 * Y], -1)
    Jj1 = torch.stack([o, b1 * H, b2 * H, b2 * Y - b1 * Z, -b2 * X, b1 * X], -1)
    Jj = torch.stack([Jj0, Jj1], dim=1)

    qi = so3.quat_inv(q)

    def adjt_row(row):
        a1, a2r = row[..., :3], row[..., 3:6]
        return torch.cat([so3.quat_rotate(qi, a1),
                          so3.quat_rotate(qi, so3.cross(a1, t) + a2r)], dim=-1)

    Ji = -torch.stack([adjt_row(Jj0), adjt_row(Jj1)], dim=1)
    Jz = torch.stack([a0 * t[:, 0] + a2 * t[:, 2], b1 * t[:, 1] + b2 * t[:, 2]], dim=-1)[..., None]
    return r, w, Ji, Jj, Jz


def no_sum(*xs):
    """The ``allsum`` of a BA on one rank: its tensors as they are. A
    distributed BA passes ``parallel.shard.all_sum(mesh, axis)``, which
    returns the tensors summed over the axis's ranks."""
    return xs


def assemble_normal_eqs(prob: BAProblem, bounds, *, W: int, Md: int, res_clip: float = 128.0,
                        allsum=no_sum, segsum=segment_sum):
    """Returns (B6 [6W,6W], E6 [6W,Md], C [Md], u [Md], v6 [6W]).

    allsum (``no_sum``): sums the partial B6, v6 and depth sums over the
    ranks that each assembled a part of the edges (``parallel/dist_ba.py``).
    segsum (``segment_sum``): the depth sums' call, (payload, kd, order, Md)
    -> [Md, K]; the runtime's CUDA graph of the window BA passes one that
    cuts its capture there (``runtime/ba_graph.py``)."""
    r, w, Ji, Jj, Jz = (x.to(torch.float32) for x in _center_residuals(prob, bounds, res_clip))
    pi = prob.ii - prob.t0
    pj = prob.jj - prob.t0
    free_i = (pi >= 0) & (pi < prob.nfree)
    free_j = (pj >= 0) & (pj < prob.nfree)
    blk = torch.arange(W * 6, device=pi.device) // 6
    ohi = ((blk[None, :] == pi[:, None]) & free_i[:, None]).to(torch.float32)
    ohj = ((blk[None, :] == pj[:, None]) & free_j[:, None]).to(torch.float32)

    def place_row(s):
        """Row s of the window Jacobian [E, 6W]: Ji / Jj at the slots of
        poses ii / jj (summed where they coincide)."""
        return ohi * Ji[:, s].repeat(1, W) + ohj * Jj[:, s].repeat(1, W)

    sw = torch.sqrt(w)
    Jw0 = place_row(0) * sw[:, 0:1]
    Jw1 = place_row(1) * sw[:, 1:2]
    Jw = torch.cat([Jw0, Jw1], dim=0)
    B6 = Jw.T @ Jw
    rw = torch.cat([sw[:, 0] * r[:, 0], sw[:, 1] * r[:, 1]])
    v6 = Jw.T @ rw

    Jz0, Jz1 = Jz[:, 0, 0], Jz[:, 1, 0]
    UE = Jw0 * (sw[:, 0] * Jz0)[:, None] + Jw1 * (sw[:, 1] * Jz1)[:, None]
    payload = torch.cat(
        [
            UE,
            (w[:, 0] * Jz0 ** 2 + w[:, 1] * Jz1 ** 2)[:, None],
            (w[:, 0] * Jz0 * r[:, 0] + w[:, 1] * Jz1 * r[:, 1])[:, None],
        ],
        dim=1,
    ).contiguous()
    kd = prob.kd.to(torch.int32)  # a no-op for the runtime's int32 indices
    order = prob.kd_order if prob.kd_order is not None else \
        torch.argsort(kd, stable=True).to(torch.int32)
    sums = segsum(payload, kd, order, Md)
    B6, v6, sums = allsum(B6, v6, sums)
    E6 = sums[:, : payload.shape[1] - 2].T
    C, u = sums[:, -2], sums[:, -1]
    return B6, E6, C, u, v6


def schur_solve(B6, E6, C, u, v6, lmbda: float, nfree: int, *, W: int, ep: float = 1.0,
                lm: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Damped Schur-complement solve; a non-finite pose update becomes a
    zero update for poses and depths alike."""
    Q = 1.0 / (C + lmbda)
    EQ = E6 * Q[None, :]
    S = B6 - EQ @ E6.T
    y = v6 - EQ @ u
    S = S + torch.diag(lm * torch.diagonal(S) + ep)

    free_row = (torch.arange(W, device=S.device) < nfree).repeat_interleave(6)
    S = S * (free_row[:, None] & free_row[None, :]) + torch.diag((~free_row).to(S.dtype))
    y = y * free_row

    dX6 = spd_solve(S.contiguous(), y.contiguous())
    bad = ~torch.isfinite(dX6).all()
    dX6 = torch.where(bad, torch.zeros_like(dX6), dX6)
    dZ = Q * (u - E6.T @ dX6)
    dZ = torch.where(bad, torch.zeros_like(dZ), dZ)
    return dX6.reshape(W, 6), dZ


def ba_delta(prob: BAProblem, bounds, lmbda: float, *, W: int, Md: int, ep: float = 1.0,
             lm: float = 1e-4, res_clip: float = 128.0, allsum=no_sum, segsum=segment_sum):
    """One Gauss-Newton step: returns (dX [W,6], dZ [Md]). allsum, segsum:
    as ``assemble_normal_eqs`` takes them."""
    B6, E6, C, u, v6 = assemble_normal_eqs(prob, bounds, W=W, Md=Md, res_clip=res_clip,
                                           allsum=allsum, segsum=segsum)
    return schur_solve(B6, E6, C, u, v6, lmbda, prob.nfree, W=W, ep=ep, lm=lm)


def ba_bounds(intrinsics, border: float):
    """The image bounds +- border that gate the BA's residuals, from frame
    0's intrinsics [N, 4], on the device."""
    cx, cy = intrinsics[0, 2], intrinsics[0, 3]
    return torch.stack([torch.full_like(cx, -border), torch.full_like(cy, -border),
                        2 * cx + border, 2 * cy + border])


def apply_pose_retr(poses, dX, t0: int, nfree: int):
    """poses[t0+l] <- Exp(dX[l]) * poses[t0+l] for l < nfree. With 0-d
    tensors t0 / nfree: ``apply_pose_retr_window``."""
    if isinstance(t0, torch.Tensor) or isinstance(nfree, torch.Tensor):
        return apply_pose_retr_window(poses, dX, t0, nfree)
    if nfree <= 0:
        return poses
    # no in-place write: training differentiates through the poses
    return torch.cat([poses[:t0], se3.retr(poses[t0:t0 + nfree], dX[:nfree]),
                      poses[t0 + nfree:]])


def apply_pose_retr_window(poses, dX, t0, nfree):
    """``apply_pose_retr`` with t0 and nfree 0-d device tensors (or ints),
    read on the device alone: the W = len(dX) rows from t0 (modulo N, so
    that a window at the buffer's end stays in range; W <= N keeps them
    distinct) are gathered, retracted where l < nfree, and written back.
    Row by row the bits of the host-int version."""
    l = torch.arange(dX.shape[0], device=poses.device)
    rows = (t0 + l) % poses.shape[0]
    old = poses[rows]
    new = torch.where((l < nfree)[:, None], se3.retr(old, dX), old)
    return poses.index_copy(0, rows, new)


def apply_depth_retr(depths, dZ, clamp_mode: str = "runtime"):
    """depths + dZ with the reference clamps.

    runtime:  d>20 -> 1.0; d = max(d, 1e-4)
    train:    clip(d, 1e-3, 10)
    """
    d = depths + dZ
    if clamp_mode == "runtime":
        d = torch.where(d > 20.0, torch.ones_like(d), d)
        return torch.clamp(d, min=1e-4)
    return torch.clamp(d, 1e-3, 10.0)


def ba(poses, patch_ctr, intrinsics, target, weight, valid, ii, jj, kd, t0: int, nfree: int,
       bounds, lmbda: float, *, W: int, Md: int, iterations: int = 2, ep: float = 1.0,
       lm: float = 1e-4, res_clip: float = 128.0, clamp_mode: str = "runtime", kd_order=None,
       allsum=no_sum, segsum=segment_sum):
    """Run ``iterations`` damped Gauss-Newton steps; returns (poses', depths').
    allsum (``no_sum``): the sum of the normal equations' partials over the
    ranks that each hold a part of the edges (a training unroll split over
    the mesh's edge axis passes its edge axis's ``all_sum``); every
    rank then solves the same system. segsum (``segment_sum``): as
    ``assemble_normal_eqs`` takes it."""
    depths = patch_ctr[:, 2]
    for _ in range(iterations):
        prob = BAProblem(poses, torch.cat([patch_ctr[:, :2], depths[:, None]], -1), intrinsics,
                         target, weight, valid, ii, jj, kd, t0, nfree, kd_order)
        dX, dZ = ba_delta(prob, bounds, lmbda, W=W, Md=Md, ep=ep, lm=lm, res_clip=res_clip,
                          allsum=allsum, segsum=segsum)
        poses = apply_pose_retr(poses, dX, t0, nfree)
        depths = apply_depth_retr(depths, dZ, clamp_mode)
    return poses, depths
