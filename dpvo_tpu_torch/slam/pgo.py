"""Sim(3) pose-graph optimization — Levenberg-Marquardt, port of
``dpvo_tpu/slam/pgo.py``.

Variables are the tangent logs of the inverse Sim(3) poses; constraints
are the odometry chain plus the loop-closure Sim(3) measurements, with the
residual r = Log(C * Exp(G_i) * Exp(G_j)^-1) and its Jacobians by
forward-mode autodiff (``torch.func.jacfwd``, as the JAX package's
``jax.jacfwd``). The dense 7n x 7n system is assembled on the sorted
segment sum (``ba/segsum.segment_sum``: the CUDA kernel on a card, never
float atomics, so the LM's accept test sees the same residuals run after
run) with segment ids and stable orders built once per ``run_pgo`` on the
host, and solved by ``torch.linalg.cholesky_ex`` / ``cholesky_solve`` (a
failed factorization or a non-finite step is a zero step, where the JAX
``cho_factor`` gives NaNs). The LM loop is host-driven, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from dpvo_tpu_torch.ba.segsum import segment_sum
from dpvo_tpu_torch.lie import sim3


def _residual_one(C, gi, gj):
    """r = Log(C * Exp(gi) * Exp(gj)^-1)."""
    return sim3.log(sim3.mul(sim3.mul(C, sim3.exp(gi)), sim3.inv(sim3.exp(gj))))


_jac_vmap = torch.func.vmap(torch.func.jacfwd(_residual_one, argnums=(1, 2)))


def pgo_graph(iii, jjj, freen: int, n: int, device) -> Dict[str, torch.Tensor]:
    """The host's part of a PGO step for constraints (iii, jjj): the segment
    ids of the four 7x7 block products of each constraint into the n*n pose
    pairs (``n*n``, which the sum drops, where a pose is not free) and of
    the two gradient terms into the n poses (``n`` likewise), each with its
    stable sort order, as int32 device tensors."""
    iii = np.asarray(iii, np.int64)
    jjj = np.asarray(jjj, np.int64)
    fi, fj = iii < freen, jjj < freen
    seg = lambda a, b, fa, fb: np.where(fa & fb, a * n + b, n * n)
    h_seg = np.concatenate([seg(iii, iii, fi, fi), seg(iii, jjj, fi, fj), seg(jjj, iii, fj, fi),
                            seg(jjj, jjj, fj, fj)])
    g_seg = np.concatenate([np.where(fi, iii, n), np.where(fj, jjj, n)])
    t = lambda a, dt=torch.int32: torch.as_tensor(a, device=device).to(dt)
    return dict(iii=t(iii, torch.int64), jjj=t(jjj, torch.int64),
                h_seg=t(h_seg), h_order=t(np.argsort(h_seg, kind="stable")),
                g_seg=t(g_seg), g_order=t(np.argsort(g_seg, kind="stable")))


def normal_eqs(Ginv, constants, valid, graph: Dict[str, torch.Tensor], n: int):
    """The undamped system of the constraints: (H [7n, 7n], g [7n],
    r [R, 7]), H and g summed over the free poses' pairs and poses."""
    gi = Ginv[graph["iii"]]
    gj = Ginv[graph["jjj"]]
    r = _residual_one(constants, gi, gj) * valid[:, None]
    Ji, Jj = _jac_vmap(constants, gi, gj)  # [R,7,7] each
    Ji = Ji * valid[:, None, None]
    Jj = Jj * valid[:, None, None]

    blk = lambda a, b: torch.einsum("rki,rkj->rij", a, b).reshape(-1, 49)
    Hp = torch.cat([blk(Ji, Ji), blk(Ji, Jj), blk(Jj, Ji), blk(Jj, Jj)]).contiguous()
    H = segment_sum(Hp, graph["h_seg"], graph["h_order"], n * n)
    H = H.reshape(n, n, 7, 7).permute(0, 2, 1, 3).reshape(7 * n, 7 * n)
    gp = torch.cat([torch.einsum("rki,rk->ri", Ji, r),
                    torch.einsum("rki,rk->ri", Jj, r)]).contiguous()
    g = segment_sum(gp, graph["g_seg"], graph["g_order"], n).reshape(7 * n)
    return H, g, r


def _pgo_step(Ginv, constants, iii, jjj, valid, lmbda: float, ep: float, freen: int, *, n: int,
              graph: Optional[Dict[str, torch.Tensor]] = None):
    """One LM iteration: returns (delta [n,7], the mean squared residual),
    both device tensors. ``graph``: ``pgo_graph(iii, jjj, freen, n)``,
    built here when not given."""
    if graph is None:
        graph = pgo_graph(iii, jjj, freen, n, Ginv.device)
    H, g, r = normal_eqs(Ginv, constants, valid, graph, n)

    # LM damping; poses that are not free get identity rows
    eye = torch.eye(7 * n, dtype=H.dtype, device=H.device)
    H = H + lmbda * torch.diag(torch.diagonal(H)) + ep * eye
    free_row = (torch.arange(n, device=H.device) < freen).repeat_interleave(7)
    H = H * (free_row[:, None] & free_row[None, :]) + torch.diag((~free_row).to(H.dtype))
    g = g * free_row

    L, info = torch.linalg.cholesky_ex(H)
    delta = -torch.cholesky_solve(g[:, None], L)[:, 0]
    bad = (info != 0) | ~torch.isfinite(delta).all()
    delta = torch.where(bad, torch.zeros_like(delta), delta)
    res = torch.sum(r ** 2) / torch.clamp(torch.sum(valid) * 7, min=1)
    return delta.reshape(n, 7), res


def run_pgo(pred_poses: np.ndarray, loop_sim3: np.ndarray, loop_ii: np.ndarray,
            loop_jj: np.ndarray, iters: int = 30, ep: float = 0.0, lmbda: float = 1e-6,
            device=None) -> np.ndarray:
    """The LM loop. pred_poses [n,7]: world-to-camera SE(3) estimates;
    loop_sim3 [L,8]: measured constraints C with C * G_i * G_j^-1 = Id
    ideally (G the inverse-pose embeddings). Returns the corrected Sim(3)
    poses [n,8] (world-to-camera, with scale), numpy. The torch work runs
    on ``device`` (None: the card)."""
    from dpvo_tpu_torch.runtime.dpvo import resolve_device

    dev = resolve_device(device)
    n = pred_poses.shape[0]
    pred = torch.as_tensor(np.asarray(pred_poses, np.float32), device=dev)
    Ginv = sim3.log(sim3.inv(sim3.from_se3(pred)))  # [n,7]

    # odometry-chain constants
    kk = np.arange(1, n)
    ll = kk - 1
    Ti = sim3.inv(sim3.from_se3(pred[kk]))
    Tj = sim3.inv(sim3.from_se3(pred[ll]))
    constants = torch.cat([sim3.mul(Tj, sim3.inv(Ti)),
                           torch.as_tensor(np.asarray(loop_sim3, np.float32), device=dev)])
    iii = np.concatenate([kk, np.asarray(loop_ii)])
    jjj = np.concatenate([ll, np.asarray(loop_jj)])
    valid = torch.ones(constants.shape[0], device=dev)

    freen = n  # every node free
    graph = pgo_graph(iii, jjj, freen, n, dev)  # the graph stays: built once
    lm = lmbda
    res_hist = []
    for itr in range(iters):
        delta, res = _pgo_step(Ginv, constants, iii, jjj, valid, lm, ep, freen, n=n, graph=graph)
        res_hist.append(float(res))
        G_new = Ginv + delta
        _, res_new = _pgo_step(G_new, constants, iii, jjj, valid, lm, ep, freen, n=n,
                               graph=graph)
        if float(res_new) < res_hist[-1]:
            Ginv = G_new
            lm /= 2
        else:
            lm *= 2
        if res_hist[-1] < 1e-5 and itr >= 4 and res_hist[-5] / max(res_hist[-1], 1e-12) < 1.5:
            break
    return sim3.inv(sim3.exp(Ginv)).cpu().numpy()


def apply_loop_closure(pred_poses: np.ndarray, loop_sim3, loop_ii, loop_jj,
                       device=None) -> np.ndarray:
    """Optimize, then re-anchor so that the pose just past the last loop
    frame is unchanged; returns the corrected Sim(3) poses [safe_i, 8] of
    the frames before that anchor, numpy (the PGO on ``device``)."""
    est = run_pgo(pred_poses, loop_sim3, loop_ii, loop_jj, device=device)
    safe_i = int(np.max(loop_ii)) + 1
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    anchor = sim3.mul(sim3.from_se3(t(pred_poses[safe_i])), sim3.inv(t(est[safe_i])))
    return sim3.mul(anchor[None], t(est))[:safe_i].numpy()
