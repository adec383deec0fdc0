"""O(edges)-memory global bundle adjustment — port of
``dpvo_tpu/ba/gba_sparse.py``.

The windowed solver (``ba/solver.py``) places every edge's Jacobian in a
dense [E, 6W] row; at global-BA scale (every pose since the oldest
edge, tens of thousands of depth variables) that does not fit. As in the
JAX package, the host enumerates the sparsity pattern once per global-BA
round (``build_sparse_indices``):

  rows    : one per (edge, free pose) incidence,
  entries : the distinct (depth k, pose a) pairs ("F"), each row mapped
            to its entry,
  kpairs  : the ordered entry pairs that share a depth variable, i.e. the
            nonzero 6x6 blocks of E Q E^T,

and the device forms per-edge Jacobians, reduces rows into per-entry
couplings F[f], forms the kpair outer products Q_k F[f1] F[f2]^T in
chunks of ``PAIR_CHUNK`` pairs and reduces them into the dense reduced
camera system S [6W, 6W], solved by a Cholesky factorization.

Every reduction is ``ba/segsum.segment_sum``: the sorted segment-sum
kernel on a card (no float atomics, so a card run is reproducible bit
for bit), its plain version (``index_add_``) on the CPU, both in one
order. The kernel reads its rows in the stable sort order of their
segment ids, which the host ships beside each id array. The pose blocks',
v's and E Q u's runs are thousands of rows long, the kpairs' hundreds:
each run is summed in pieces of ``segsum.CHUNK`` rows, each piece row
after row, the pieces then in order (XLA's order in the JAX package is
its own, so the two agree to rounding). The dense solve is ``torch.linalg.cholesky_ex`` and
``torch.cholesky_solve`` (the JAX package's ``cho_factor``/``cho_solve``
are XLA, not a Pallas kernel; the SPD kernel stops at 96 unknowns). The
port solves at the live size (W free poses, Md depth variables) where
the JAX package pads to ``GBA_POSES_MAX`` / ``GBA_DEPTHS_MAX`` with
identity rows and empty variables: the live block has the same solution.

``dist_gba`` splits the rows and kpairs over the ranks of a mesh's edge
axis (``shard_indices``) and sums their partial reductions with
``all_reduce``, as the JAX package's ``dist_gba`` does with ``psum``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from dpvo_tpu_torch.ba.segsum import segment_sum
from dpvo_tpu_torch.ba.solver import (BAProblem, _center_residuals, apply_depth_retr,
                                      apply_pose_retr, no_sum)

PAIR_CHUNK = 1 << 20  # kpairs whose [chunk, 36] products exist at once

# the arrays of build_sparse_indices that the device reads, as int32
_DEVICE_INDEX = ("re", "r2f", "fk", "fa", "p1", "p2", "kd_order", "blk_seg", "blk_order",
                 "v_seg", "v_order", "r2f_order", "pair_seg", "pair_order", "fa_order",
                 "fk_order")
_DEVICE_MASKS = ("rs", "fkeep")
UPLOADED = _DEVICE_INDEX + _DEVICE_MASKS  # the arrays index_tensors copies to the device


def _stable_order(ids: np.ndarray) -> np.ndarray:
    return np.argsort(ids, kind="stable").astype(np.int32)


def build_sparse_indices(ii: np.ndarray, jj: np.ndarray, kd: np.ndarray, t0: int, nfree: int,
                         *, W: int, R_MAX: int, KP_MAX: int) -> Dict[str, np.ndarray]:
    """Host-side sparsity enumeration for one global-BA topology.

    ii/jj/kd: the valid edges only. Returns live-length arrays (no
    padding): the JAX function's rows (re, ra, rs, r2f), entries (fk, fa,
    fkeep) and kpairs (p1, p2), with the same freeze on a ``KP_MAX``
    overflow, plus the segment ids and stable sort orders of the device's
    reductions: ``kd_order`` (depth variables), ``blk_seg``/``blk_order``
    (the four pose blocks of each edge, ``pic*W+pjc``; -1 where a pose is
    not free), ``v_seg``/``v_order`` (the pose gradient), ``r2f_order``,
    ``pair_seg``/``pair_order`` (``fa[p1]*W+fa[p2]``), ``fa_order`` and
    ``fk_order``.
    """
    E = len(ii)
    pi = np.asarray(ii, np.int64) - t0
    pj = np.asarray(jj, np.int64) - t0
    kd = np.asarray(kd, np.int64)

    # rows: (edge, local pose, side) for every free-pose incidence
    fi = (pi >= 0) & (pi < nfree)
    fj = (pj >= 0) & (pj < nfree)
    re = np.concatenate([np.nonzero(fi)[0], np.nonzero(fj)[0]])
    ra = np.concatenate([pi[fi], pj[fj]])
    rs = np.concatenate([np.zeros(fi.sum(), bool), np.ones(fj.sum(), bool)])
    rk = kd[re]
    R = len(re)
    assert R <= R_MAX, f"GBA rows {R} exceed capacity {R_MAX}"

    # entries: distinct (depth, pose) pairs; rows map onto them
    ent_key, r2f = np.unique(rk * W + ra, return_inverse=True)
    r2f = r2f.reshape(-1)
    F = len(ent_key)
    fk = ent_key // W
    fa = ent_key % W

    # kpairs: ordered entry pairs within each depth group (entries are
    # sorted by k*W + a, so a depth group is a contiguous run)
    if F:
        bounds = np.concatenate([[0], np.nonzero(np.diff(fk))[0] + 1, [F]])
        sizes = np.diff(bounds)
        sq = sizes * sizes
        starts = np.repeat(bounds[:-1], sq)
        m = np.repeat(sizes, sq)
        loc = np.arange(sq.sum()) - np.repeat(np.cumsum(sq) - sq, sq)
        p1 = starts + loc // m
        p2 = starts + loc % m
    else:
        sizes = sq = np.zeros(0, np.int64)
        p1 = p2 = np.zeros(0, np.int64)
    KP = len(p1)
    fkeep = np.ones(F, bool)
    if KP > KP_MAX:
        # keep the smallest depth groups' couplings whole and freeze the
        # depth variables of every group that loses any (excluded from
        # E Q E^T, from E Q u and from the depth back-substitution), which
        # keeps the Gauss-Newton system consistent
        pair_group = np.repeat(np.arange(len(sizes)), sq)
        keep = np.argsort(np.repeat(sizes, sq), kind="stable")[:KP_MAX]
        clean = np.bincount(pair_group[keep], minlength=len(sizes)) == sq
        keep = keep[clean[pair_group[keep]]]
        fkeep = clean[np.repeat(np.arange(len(sizes)), sizes)]
        print(f"warning: GBA kpairs {KP} exceed {KP_MAX}; freezing "
              f"{int((~clean).sum())} depth groups this round")
        p1, p2 = p1[keep], p2[keep]

    # segment ids of the device's edge-side reductions (-1: dropped)
    pic = np.where(fi, pi, -1)
    pjc = np.where(fj, pj, -1)
    blk = lambda a, b: np.where((a >= 0) & (b >= 0), a * W + b, -1)
    blk_seg = np.concatenate([blk(pic, pic), blk(pic, pjc), blk(pjc, pic), blk(pjc, pjc)])
    v_seg = np.concatenate([pic, pjc])
    pair_seg = fa[p1] * W + fa[p2]
    i32 = lambda a: np.asarray(a, np.int32)
    return dict(
        re=i32(re), ra=i32(ra), rs=rs, r2f=i32(r2f), fk=i32(fk), fa=i32(fa), fkeep=fkeep,
        p1=i32(p1), p2=i32(p2),
        kd_order=_stable_order(kd), blk_seg=i32(blk_seg), blk_order=_stable_order(blk_seg),
        v_seg=i32(v_seg), v_order=_stable_order(v_seg), r2f_order=_stable_order(r2f),
        pair_seg=i32(pair_seg), pair_order=_stable_order(pair_seg),
        fa_order=_stable_order(fa), fk_order=_stable_order(fk),
    )


def shard_indices(idx, rank: int, world: int):
    """Rank ``rank``'s part of ``build_sparse_indices``' arrays (numpy, or
    ``index_tensors``' tensors) for a BA distributed over ``world`` ranks
    (``dist_gba``), as the JAX package shards them over its mesh's edge
    axis: a contiguous slice [s, e) of the rows (re, ra, rs, r2f) and of
    the kpairs' sorted order (a contiguous range of the sorted
    ``pair_order`` is itself sorted by segment id, so each chunk's identity
    order holds); the entries and the edge-side orders stay whole. The
    slice's stable r2f order is the rows of the whole order that fall in
    [s, e), in that order, less s."""
    out = dict(idx)
    R, KP = len(idx["re"]), len(idx["pair_order"])
    s, e = R * rank // world, R * (rank + 1) // world
    for k in ("re", "ra", "rs", "r2f"):
        if k in idx:
            out[k] = idx[k][s:e]
    order = idx["r2f_order"]
    out["r2f_order"] = order[(order >= s) & (order < e)] - s
    out["pair_order"] = idx["pair_order"][KP * rank // world:KP * (rank + 1) // world]
    return out


def index_tensors(idx: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """build_sparse_indices' arrays as tensors on ``device`` (the kernel's
    ids and orders int32, the masks bool)."""
    out = {k: torch.as_tensor(idx[k], dtype=torch.int32, device=device) for k in _DEVICE_INDEX}
    for k in _DEVICE_MASKS:
        out[k] = torch.as_tensor(idx[k], device=device)
    return out


def _iteration(poses, depths, patch_ctr, intrinsics, target, weight, valid, ii, jj, kd,
               t0: int, nfree: int, bounds, lmbda: float, idx, *, W: int, Md: int, ep: float,
               lm: float, res_clip: float, allsum=no_sum):
    """One sparse Gauss-Newton iteration; returns (poses', depths').

    ``allsum`` (``ba/solver.no_sum``) sums its tensors over the ranks that
    share the rows and kpairs (``dist_gba``: each reduces its
    ``shard_indices`` slice, as the JAX iteration's ``psum`` over the edge
    axis); the edge-side terms and the entries are computed whole on every
    rank."""
    prob = BAProblem(poses, torch.cat([patch_ctr[:, :2], depths[:, None]], -1), intrinsics,
                     target, weight, valid, ii, jj, kd, t0, nfree)
    r, w, Ji, Jj, Jz = (x.to(torch.float32) for x in _center_residuals(prob, bounds, res_clip))
    Jz = Jz[:, :, 0]  # [E, 2]
    E = r.shape[0]
    dev = r.device

    def ssum(payload, seg, order, n):
        return segment_sum(payload.contiguous(), seg, order, n)

    # depth-side diagonal and gradient, one reduction
    Cu = ssum(torch.stack([(w * Jz * Jz).sum(-1), (w * Jz * r).sum(-1)], -1),
              kd, idx["kd_order"], Md)
    C, u = Cu[:, 0], Cu[:, 1]
    Q = 1.0 / (C + lmbda)

    # pose blocks B [W*W, 6, 6] and gradient v [W, 6] (ids of poses that
    # are not free are -1, dropped)
    def blk(Ja, Jb):
        return ((w[:, :, None, None] * Ja[:, :, :, None]) * Jb[:, :, None, :]).sum(1)

    vals = torch.cat([blk(Ji, Ji), blk(Ji, Jj), blk(Jj, Ji), blk(Jj, Jj)]).reshape(4 * E, 36)
    B = ssum(vals, idx["blk_seg"], idx["blk_order"], W * W)
    wr = w * r
    vvals = torch.cat([(wr[:, :, None] * Ji).sum(1), (wr[:, :, None] * Jj).sum(1)])
    v = ssum(vvals, idx["v_seg"], idx["v_order"], W)

    # per-row pose-depth couplings -> per-(depth, pose) entries F
    re, r2f, fk, fa = idx["re"], idx["r2f"], idx["fk"], idx["fa"]
    F = fk.shape[0]
    Jr = torch.where(idx["rs"][:, None, None], Jj[re], Ji[re])  # [R, 2, 6]
    ekr = ((w * Jz)[re][:, :, None] * Jr).sum(1)
    (Fe,) = allsum(ssum(ekr, r2f, idx["r2f_order"], F))  # [F, 6]

    # E Q E^T, reduced into S over chunks of pairs taken in sorted id order
    # (each chunk's ids are then sorted: its order is the identity)
    Spairs = torch.zeros((W * W, 36), dtype=torch.float32, device=dev)
    p1, p2, pair_seg, pair_order = idx["p1"], idx["p2"], idx["pair_seg"], idx["pair_order"]
    for s in range(0, pair_order.shape[0], PAIR_CHUNK):
        q = pair_order[s:s + PAIR_CHUNK]
        q1, q2 = p1[q], p2[q]
        pv = Q[fk[q1]][:, None, None] * (Fe[q1][:, :, None] * Fe[q2][:, None, :])
        ident = torch.arange(q.shape[0], dtype=torch.int32, device=dev)
        Spairs = Spairs - ssum(pv.reshape(-1, 36), pair_seg[q], ident, W * W)
    (Spairs,) = allsum(Spairs)
    S = (B + Spairs).reshape(W, W, 6, 6).permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
    # truncated kpairs can drop one of a symmetric block pair
    S = 0.5 * (S + S.T)

    # y = v - E Q u per entry; entries of frozen depth groups left out
    fkeep = idx["fkeep"]
    equ = Fe * (Q[fk] * u[fk] * fkeep.to(torch.float32))[:, None]
    y = (v - ssum(equ, fa, idx["fa_order"], W)).reshape(6 * W)

    # damping; rows of poses that are not free are identity rows
    S = S + torch.diag(lm * torch.diagonal(S) + ep)
    free_row = (torch.arange(W, device=dev) < nfree).repeat_interleave(6)
    S = S * (free_row[:, None] & free_row[None, :]) + torch.diag((~free_row).to(torch.float32))
    y = y * free_row

    L, info = torch.linalg.cholesky_ex(S)
    dX = torch.cholesky_solve(y[:, None], L)[:, 0]
    # a failed factorization or a non-finite step is a zero step
    bad = (info != 0) | ~torch.isfinite(dX).all()
    dX = torch.where(bad, torch.zeros_like(dX), dX).reshape(W, 6)

    # dZ = Q (u - E^T dX); the depth variables of frozen groups take no step
    ef = ssum(torch.stack([(Fe * dX[fa]).sum(-1), (~fkeep).to(torch.float32)], -1), fk,
              idx["fk_order"], Md)
    dZ = torch.where(bad | (ef[:, 1] > 0), torch.zeros_like(u), Q * (u - ef[:, 0]))

    poses = apply_pose_retr(poses, dX, t0, nfree)
    depths = apply_depth_retr(depths, dZ, "runtime")
    return poses, depths


def gba(poses, patch_ctr, intrinsics, target, weight, valid, ii, jj, kd, t0: int, nfree: int,
        bounds, lmbda: float, idx: Dict[str, torch.Tensor], *, W: int, Md: int,
        iterations: int = 2, ep: float = 1.0, lm: float = 1e-4, res_clip: float = 128.0,
        allsum=no_sum) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse-assembled global BA; returns (poses', depths' [Md]).

    The contract of ``ba/solver.ba`` with clamp_mode "runtime", plus the
    host-built sparsity ``idx`` (``index_tensors(build_sparse_indices(...))``
    with the same W). Edges past the ones ``build_sparse_indices`` saw are
    padding (invalid) and are left out. W >= nfree free poses from t0;
    Md depth variables (patch_ctr [Md, 3]). ``allsum``: ``_iteration``'s.
    """
    E = idx["kd_order"].shape[0]
    target, weight, valid = target[:E], weight[:E], valid[:E]
    kd = kd[:E].to(torch.int32)
    ii, jj = ii[:E].long(), jj[:E].long()
    depths = patch_ctr[:, 2]
    for _ in range(iterations):
        poses, depths = _iteration(poses, depths, patch_ctr, intrinsics, target, weight, valid,
                                   ii, jj, kd, t0, nfree, bounds, lmbda, idx, W=W, Md=Md, ep=ep,
                                   lm=lm, res_clip=res_clip, allsum=allsum)
    return poses, depths


def dist_gba(mesh, poses, patch_ctr, intrinsics, target, weight, valid, ii, jj, kd, t0: int,
             nfree: int, bounds, lmbda: float, idx: Dict[str, torch.Tensor], *, W: int,
             Md: int, iterations: int = 2, ep: float = 1.0, lm: float = 1e-4,
             res_clip: float = 128.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gba`` over the mesh's ``edge`` axis (the JAX package's
    ``dist_gba``), on the same arguments, whole on every rank. Each rank
    takes its ``shard_indices`` of idx (its rank and the size of the edge
    axis), reduces its rows into the entries' couplings and its kpairs into
    the camera system, one ``all_reduce`` over the edge group sums each, and
    every rank solves: each rank returns the same (poses', depths'). On one
    rank it is ``gba`` bit for bit."""
    from dpvo_tpu_torch.parallel.shard import all_sum, edge_rank

    return gba(poses, patch_ctr, intrinsics, target, weight, valid, ii, jj, kd, t0, nfree,
               bounds, lmbda, shard_indices(idx, *edge_rank(mesh)), W=W, Md=Md,
               iterations=iterations, ep=ep, lm=lm, res_clip=res_clip,
               allsum=all_sum(mesh, "edge"))
