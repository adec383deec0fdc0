"""One distributed Gauss-Newton step of the windowed BA: the port of
``dpvo_tpu/parallel/dist_ba.py``.

Each rank of the mesh's ``edge`` axis assembles the partial normal
equations of its contiguous slice of the edges (``ba/solver.
assemble_normal_eqs``: its depth reduction on the sorted segment sum, in
the slice's own stable order of kd), one ``all_reduce`` sums the partials,
and every rank solves the small camera system (``schur_solve``, the SPD
kernel on the card), so every rank holds the same step.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dpvo_tpu_torch.ba.solver import BAProblem, assemble_normal_eqs, schur_solve
from dpvo_tpu_torch.parallel.shard import all_sum, edge_range


def dist_ba_delta(mesh, poses, patch_ctr, intrinsics, target, weight, valid, ii, jj, kd,
                  t0: int, nfree: int, bounds, lmbda: float, *, W: int, Md: int,
                  ep: float = 1.0, lm: float = 1e-4,
                  res_clip: float = 128.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ba/solver.ba_delta`` over the mesh's edge axis: edge arrays
    (target, weight, valid, ii, jj, kd) whole on every rank, each rank
    reducing its slice; returns (dX [W,6], dZ [Md]), the same on every
    rank. On one rank it is ``ba_delta`` bit for bit."""
    s, e = edge_range(kd.shape[0], mesh)
    prob = BAProblem(poses, patch_ctr, intrinsics, target[s:e], weight[s:e], valid[s:e],
                     ii[s:e], jj[s:e], kd[s:e], t0, nfree)
    B6, E6, C, u, v6 = assemble_normal_eqs(prob, bounds, W=W, Md=Md, res_clip=res_clip,
                                           allsum=all_sum(mesh, "edge"))
    return schur_solve(B6, E6, C, u, v6, lmbda, nfree, W=W, ep=ep, lm=lm)
