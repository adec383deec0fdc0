"""The clip loss of the plain reference: per unroll step the min over
patch pixels of the flow error on the supervised edges, and after step 2
the scale-aligned relative-pose errors. Frozen from the port's
``train/loss.py`` (one process, no mesh).

The norms are ``sqrt(sum(x^2))``, whose gradient at a zero vector is NaN,
as JAX's ``jnp.linalg.norm``: the i == j pose pairs' zero errors then send
NaN into the poses, which the update operator's gradient clip and the
optimizer's ``zero_nans`` remove, so only the unroll steps before the pose
term starts train the networks (the recipe's semantics)."""

from __future__ import annotations

import torch

from bench_port.reference.lie import se3


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def kabsch_scale(A, B):
    """Closed-form scale aligning B [n, 3] to A [n, 3]."""
    EA, EB = A.mean(0), B.mean(0)
    varA = torch.mean(torch.sum((A - EA) ** 2, dim=1))
    H = (A - EA).T @ (B - EB) / A.shape[0]
    return varA / torch.clamp(torch.sum(torch.linalg.svdvals(H)), min=1e-8)


def pose_error(Gs, Ps, n: int):
    """Mean relative translation and rotation errors over the ordered pairs
    i != j of the first n poses, the prediction scaled by the Kabsch scale
    clipped to [0.1, 10] (no gradient)."""
    P1, P2 = se3.inv(Gs[:n]), se3.inv(Ps[:n])
    with torch.no_grad():
        s = torch.clamp(kabsch_scale(P2[:, :3], P1[:, :3]), 0.1, 10.0)
    P1 = se3.scale(P1, s.expand(n))
    ar = torch.arange(n, device=Gs.device)
    ii, jj = torch.meshgrid(ar, ar, indexing="ij")
    kf = (ii != jj).reshape(-1).to(Gs.dtype)
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    dP = se3.mul(se3.inv(P1[ii]), P1[jj])
    dG = se3.mul(se3.inv(P2[ii]), P2[jj])
    e1 = se3.log(se3.mul(dP, se3.inv(dG))) * kf[:, None]
    tr, ro = _norm(e1[:, :3]), _norm(e1[:, 3:6])
    denom = torch.clamp(kf.sum(), min=1.0)
    return torch.sum(tr * kf) / denom, torch.sum(ro * kf) / denom


def flow_error(valid, coords, coords_gt, P: int):
    """Masked mean of the min over patch pixels of the flow error."""
    e = _norm(coords - coords_gt)
    e_min = torch.amin(e.reshape(e.shape[0], P * P), dim=-1)
    v = (valid > 0.5).to(e_min.dtype)
    return torch.sum(e_min * v) / torch.clamp(torch.sum(v), min=1.0)


def clip_loss(traj, poses_gt, P: int, flow_weight: float = 0.1, pose_weight: float = 10.0):
    """The sum of the per-step losses over the unroll."""
    loss = 0.0
    for i, (valid, coords, coords_gt, Gs, n) in enumerate(traj):
        loss = loss + flow_weight * flow_error(valid, coords, coords_gt, P)
        if i >= 2:
            tr, ro = pose_error(Gs, poses_gt, n)
            loss = loss + pose_weight * (tr + ro)
    return loss
