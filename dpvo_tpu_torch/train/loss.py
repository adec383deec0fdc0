"""Training loss: flow supervision plus a scale-aligned relative-pose error.

Port of ``dpvo_tpu/train/loss.py``: per unroll step, (1) the min over
patch pixels of the reprojection error on valid short-baseline edges,
(2) after step 2, the translation and rotation errors of every relative
pose pair once the predicted trajectory is aligned in scale.

The norms are written as ``sqrt(sum(x^2))``, whose gradient at a zero
vector is NaN, as ``jnp.linalg.norm``'s is under JAX's autodiff
(``torch.linalg.norm`` gives 0 there). ``pose_error`` takes the norm of
the i == j pairs' zero errors, so once the pose term is in the loss its
gradient into the poses is NaN, and the update operator's gradient clip
(``models/blocks.gradient_clip``, which zeroes NaN) removes that step's
whole BA path from the gradient: in both packages only the unroll steps
before the pose term starts (0 and 1) train the network, unless
``structure_only`` (ROADMAP §3). The port keeps the reference's
gradients, on the card too (see ``pose_error``).
"""

from __future__ import annotations

import torch

from dpvo_tpu_torch.lie import se3


def _norm(x):
    """Euclidean norm over the last axis with JAX's gradient (NaN at 0)."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def kabsch_scale(A, B):
    """Closed-form scale aligning B [n, 3] to A [n, 3]."""
    EA = A.mean(0)
    EB = B.mean(0)
    varA = torch.mean(torch.sum((A - EA) ** 2, dim=1))
    H = (A - EA).T @ (B - EB) / A.shape[0]
    d = torch.linalg.svdvals(H)
    return varA / torch.clamp(torch.sum(d), min=1e-8)


def pose_error(Gs, Ps, n: int):
    """Mean relative SE(3) translation and rotation errors over the
    ordered pairs i != j of the first n poses. Gs: predicted poses [F, 7]
    (world-to-camera); Ps: ground truth. The predicted trajectory is scaled
    by the Kabsch scale, clipped to [0.1, 10], with no gradient."""
    P1 = se3.inv(Gs[:n])
    P2 = se3.inv(Ps[:n])
    with torch.no_grad():
        s = torch.clamp(kabsch_scale(P2[:, :3], P1[:, :3]), 0.1, 10.0)
    P1 = se3.scale(P1, s.expand(n))

    ar = torch.arange(n, device=Gs.device)
    ii, jj = torch.meshgrid(ar, ar, indexing="ij")
    k = (ii != jj).reshape(-1)
    ii, jj = ii.reshape(-1), jj.reshape(-1)

    dP = se3.mul(se3.inv(P1[ii]), P1[jj])
    dG = se3.mul(se3.inv(P2[ii]), P2[jj])
    kf = k.to(Gs.dtype)
    # the i == j errors are zero in exact arithmetic and in the JAX
    # package's f32 on the CPU, but a fused multiply-add (the card) leaves
    # them ~1e-8: the product with the mask makes them exactly zero and
    # keeps their norm's NaN gradient flowing back (NaN * 0 is NaN), as JAX's
    e1 = se3.log(se3.mul(dP, se3.inv(dG))) * kf[:, None]
    tr = _norm(e1[:, :3])
    ro = _norm(e1[:, 3:6])
    denom = torch.clamp(kf.sum(), min=1.0)
    return torch.sum(tr * kf) / denom, torch.sum(ro * kf) / denom


def flow_error(valid, coords, coords_gt, P: int):
    """Masked mean of the min over patch pixels of the flow error; also
    the per-edge minima and the mask."""
    e = _norm(coords - coords_gt)  # [Es, P, P]
    e_min = torch.amin(e.reshape(e.shape[0], P * P), dim=-1)  # splits ties' gradient, as jnp.min
    v = (valid > 0.5).to(e_min.dtype)
    return torch.sum(e_min * v) / torch.clamp(torch.sum(v), min=1.0), e_min, v


def clip_loss(traj, poses_gt, P: int, flow_weight=0.1, pose_weight=10.0, structure_only=False):
    """Sum of the per-step losses over the unroll; the metrics (flow, tr,
    ro, px1) of the last step."""
    loss = 0.0
    metrics = {}
    for i, (valid, coords, coords_gt, Gs, n) in enumerate(traj):
        fe, e_min, v = flow_error(valid, coords, coords_gt, P)
        loss = loss + flow_weight * fe
        tr, ro = pose_error(Gs, poses_gt, n)
        if not structure_only and i >= 2:
            loss = loss + pose_weight * (tr + ro)
        if i == len(traj) - 1:
            px1 = torch.sum((e_min < 0.25) * v) / torch.clamp(torch.sum(v), min=1.0)
            metrics = {"flow": fe, "tr": tr, "ro": ro, "px1": px1}
    return loss, metrics
