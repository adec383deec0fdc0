"""Small dense SPD solve: the CUDA kernel's wrapper (``csrc/spd_solve.cu``),
its plain version, and the autograd Function around both.

Port of ``dpvo_tpu/ba/spd_solve.py``, the solve of the damped SPD pose
system of the sliding-window BA (n = 6 * W_OPT_MAX <= 96; the card's
tracker refuses a larger window when it is built). The TPU kernel
runs Gauss-Jordan without pivoting on ``[S | y]``; the port factorizes
S = L L^T (right-looking Cholesky, lower triangle of S) and solves
L z = y, L^T x = z: the same x for a symmetric positive definite S, and a
non-finite x where S is not positive definite. Differentiable like the
JAX custom VJP (``spd_solve.py:48-70``): the backward pass is another
solve with the same symmetric matrix, y_bar = S^{-1} g, S_bar = -y_bar x^T.
"""

from __future__ import annotations

import torch

from dpvo_tpu_torch import kernels


MAX_N = 96  # the kernel's register tile (csrc/spd_solve.cu: kMaxN)


def spd_solve_plain(S, y):
    """The kernel's arithmetic step by step in torch: the right-looking
    Cholesky factorization (pivot k's 1/sqrt, column k of L, the rank-1
    update of the trailing block), then forward and back substitution
    with the pivots' 1/sqrt."""
    n = S.shape[0]
    A = S.to(torch.float32)
    rows = torch.arange(n, device=S.device)
    cols, rdiag = [], []
    for k in range(n):
        r = torch.rsqrt(A[k, k])
        l = torch.where(rows > k, A[:, k] * r, torch.zeros_like(r))
        A = A - torch.outer(l, l)
        cols.append(l)
        rdiag.append(r)
    L = torch.stack(cols, 1)
    z = y.to(torch.float32)
    for k in range(n):
        zk = z[k] * rdiag[k]
        z = torch.where(rows == k, zk, torch.where(rows > k, z - L[:, k] * zk, z))
    for k in reversed(range(n)):
        xk = z[k] * rdiag[k]
        z = torch.where(rows == k, xk, torch.where(rows < k, z - L[k, :] * xk, z))
    return z


def _solve(S, y):
    if S.device.type == "cpu":
        return spd_solve_plain(S, y)
    n = S.shape[0]
    if S.shape != (n, n) or y.shape != (n,):
        raise ValueError(f"spd_solve: S [n,n] and y [n], got {tuple(S.shape)} {tuple(y.shape)}")
    if n > MAX_N:
        raise ValueError(f"spd_solve: the kernel solves n <= {MAX_N}, got {n}")
    if S.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("spd_solve: f32 only")
    S = S.contiguous()
    y = y.contiguous()
    kernels.require_cuda("spd_solve", S, y)
    lib = kernels.load()
    x = torch.empty_like(y)
    rc = lib.dpvo_spd_solve(S.data_ptr(), y.data_ptr(), x.data_ptr(), n, kernels.stream_ptr(S))
    kernels.check("spd_solve", rc)
    kernels.count("spd_solve")
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
