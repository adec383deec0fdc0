"""Umeyama Sim(3) alignment, ATE-RMSE and the TUM protocol's timestamp
association — numpy, a copy of ``dpvo_tpu/eval/ate.py``."""

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


def associate(t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.02):
    """Associate two timestamp arrays (TUM protocol): for each est stamp
    find the closest gt stamp within max_dt. Returns index pairs."""
    ie, ig = [], []
    order = np.argsort(t_gt)
    t_gt_sorted = t_gt[order]
    for i, t in enumerate(t_est):
        j = np.searchsorted(t_gt_sorted, t)
        best, bestd = None, max_dt
        for cand in (j - 1, j):
            if 0 <= cand < len(t_gt_sorted):
                d = abs(t_gt_sorted[cand] - t)
                if d <= bestd:
                    best, bestd = cand, d
        if best is not None:
            ie.append(i)
            ig.append(order[best])
    return np.asarray(ie), np.asarray(ig)
