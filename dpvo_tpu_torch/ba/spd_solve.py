"""Small dense SPD solve: the CUDA kernel's wrapper (``csrc/spd_solve.cu``),
its plain version, and the autograd Function around both.

Port of ``dpvo_tpu/ba/spd_solve.py``: Gauss-Jordan without pivoting on
``[S | y]`` for the damped SPD pose system of the sliding-window BA
(n = 6 * W_OPT_MAX). Differentiable like the JAX custom VJP
(``spd_solve.py:48-70``): the backward pass is another solve with the
same symmetric matrix, y_bar = S^{-1} g, S_bar = -y_bar x^T.
"""

from __future__ import annotations

import torch

from dpvo_tpu_torch import kernels


def spd_solve_plain(S, y):
    """Gauss-Jordan elimination without pivoting, in torch (the
    kernel's arithmetic, sweep by sweep)."""
    n = S.shape[0]
    A = torch.cat([S, y[:, None]], dim=1).to(torch.float32)
    rows = torch.arange(n, device=S.device)
    for k in range(n):
        fac = A[:, k] / A[k, k]
        fac = torch.where(rows == k, torch.zeros_like(fac), fac)
        A = A - fac[:, None] * A[k][None, :]
    return A[:, n] / torch.diagonal(A[:, :n])


def _solve(S, y):
    if S.device.type == "cpu":
        return spd_solve_plain(S, y)
    n = S.shape[0]
    if S.shape != (n, n) or y.shape != (n,):
        raise ValueError(f"spd_solve: S [n,n] and y [n], got {tuple(S.shape)} {tuple(y.shape)}")
    if S.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("spd_solve: f32 only")
    S = S.contiguous()
    y = y.contiguous()
    kernels.require_cuda("spd_solve", S, y)
    lib = kernels.load()
    x = torch.empty_like(y)
    rc = lib.dpvo_spd_solve(S.data_ptr(), y.data_ptr(), x.data_ptr(), n, kernels.stream_ptr(S))
    kernels.check("spd_solve", rc)
    kernels.LAUNCHES["spd_solve"] += 1
    return x


class SPDSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, S, y):
        x = _solve(S, y)
        ctx.save_for_backward(S, x)
        return x

    @staticmethod
    def backward(ctx, g):
        S, x = ctx.saved_tensors
        yb = _solve(S, g.contiguous())
        return -torch.outer(yb, x), yb


def spd_solve(S, y):
    """Solve S x = y for a damped-SPD S [n, n], y [n] (f32)."""
    return SPDSolve.apply(S, y)
