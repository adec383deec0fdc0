"""The pose system's SPD solve in the plain reference: a Cholesky
factorization in f64 (``torch.linalg.cholesky_ex``), where the port's
kernel factorizes in f32 (``dpvo_tpu_torch/ba/spd_solve.py``); a matrix
that is not positive definite gives a non-finite x, as the kernel's does."""

from __future__ import annotations

import torch

MAX_N = 96


def spd_solve(S, y):
    """Solve S x = y for a damped-SPD S [n, n], y [n]; f32 out."""
    L, info = torch.linalg.cholesky_ex(S.to(torch.float64))
    x = torch.cholesky_solve(y.to(torch.float64)[:, None], L)[:, 0]
    x = torch.where(info == 0, x, torch.full_like(x, float("nan")))
    return x.to(torch.float32)
