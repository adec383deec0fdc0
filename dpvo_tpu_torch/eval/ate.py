"""Umeyama Sim(3) alignment and ATE-RMSE — numpy, a copy of the two
functions of ``dpvo_tpu/eval/ate.py`` (the rest of that module, its
timestamp association and file formats, is not ported yet)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares Sim(m) aligning x -> y; x, y are [m, n] (dim, points).

    Umeyama's closed form. Returns (R [m,m], t [m], s scalar); a
    zero-variance x has no defined scale, so the fit is then rigid."""
    m, n = x.shape
    mean_x = x.mean(1)
    mean_y = y.mean(1)
    sigma_x = ((x - mean_x[:, None]) ** 2).sum() / n
    cov = (y - mean_y[:, None]) @ (x - mean_x[:, None]).T / n
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(m)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[-1, -1] = -1
    R = u @ s_mat @ vt
    c = (np.diag(d) @ s_mat).trace() / sigma_x if with_scale and sigma_x > 1e-12 else 1.0
    t = mean_y - c * R @ mean_x
    return R, t, c


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, align_scale: bool = True) -> float:
    """ATE-RMSE between aligned position sequences [N,3]."""
    assert est_xyz.shape == gt_xyz.shape, (est_xyz.shape, gt_xyz.shape)
    R, t, s = umeyama_alignment(est_xyz.T, gt_xyz.T, with_scale=align_scale)
    est_aligned = (s * (R @ est_xyz.T)).T + t
    err = np.linalg.norm(est_aligned - gt_xyz, axis=1)
    return float(np.sqrt((err**2).mean()))
