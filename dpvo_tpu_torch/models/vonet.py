"""VONet training-time forward: the VO unroll with BA in the loop.

Port of ``dpvo_tpu/models/vonet.py``. On a short clip it patchifies every
frame, builds a factor graph among the first ``init_frames`` frames, then
runs STEPS rounds of the update operator and two differentiable BA
iterations while frames join at fixed steps, and returns each step's
supervision tuple for the clip loss (``train/loss.py``).

The edge schedule is static given (F, M, STEPS): ``build_schedule`` is a
numpy copy of the JAX one. The JAX PRNG draws (patch centroids, the
initial inverse depths ``d0`` and each step's frame-dropout coin) cannot
be reproduced in torch, so ``vo_forward`` takes them as an input
(``draw_inputs`` draws them from a ``torch.Generator``; under
GRADIENT_BIAS the candidates, which it selects from). The correlation
is the exact-window kernel with its hand-written backward pass
(``ops/corr_cuda.corr_features_train``); BA's depth reduction and
SoftAgg's sums go through the sorted segment sum, the pose solve through
the SPD kernel, each differentiable. ``remat`` checkpoints each unroll
step (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``);
the hidden state ``net_full`` is not detached between steps, so its
gradient crosses the whole unroll, as in JAX.

With a mesh whose edge axis has more than one rank (``vo_forward(...,
mesh=)``), each rank computes the edges of the patches it owns
(``owned_topo``): reprojection, correlation, the update operator, its
part of BA's normal equations and its supervised edges. The encoders,
the poses and the depths stay whole on every rank; SoftAgg's frame-pair
sums, its softmax shifts and BA's normal equations are reduced over the
edge group (``parallel.shard.EdgeSplit``), where the JAX package's
``edge_shard`` annotations let XLA insert the collectives.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from dpvo_tpu_torch.ba import solver as ba_solver
from dpvo_tpu_torch.ba.spd_solve import MAX_N as SPD_MAX_N
from dpvo_tpu_torch.config import Config
from dpvo_tpu_torch.geom import projective as pops
from dpvo_tpu_torch.lie import se3
from dpvo_tpu_torch.models.patchifier import draw_count, random_candidates, select_centroids
from dpvo_tpu_torch.ops.corr import avg_pool2d_nhwc
from dpvo_tpu_torch.ops.corr_cuda import corr_features_train
from dpvo_tpu_torch.parallel.shard import edge_split, owned_edges
from dpvo_tpu_torch.runtime.topology import neighbors


class StepTopo(NamedTuple):
    """Static per-step edge topology (numpy)."""

    kk: np.ndarray
    jj: np.ndarray
    ii: np.ndarray
    kk_seg: np.ndarray
    ij_seg: np.ndarray
    ix: np.ndarray
    jx: np.ndarray
    mask_ix: np.ndarray
    mask_jx: np.ndarray
    n: int                 # active frame count
    new_frame: int         # frame added at this step (-1 if none)
    sup: np.ndarray        # indices of supervised edges (0 < |ii-jj| <= 2)


def build_schedule(F: int, M: int, STEPS: int, init_frames: int = 8) -> List[StepTopo]:
    """Static edge growth schedule: all patches of the first
    ``init_frames`` frames to all of those frames, then from step
    ``init_frames`` one frame joins a step (old patches to it, its
    patches to every frame so far)."""
    init_frames = min(init_frames, F)
    ix_all = np.arange(F * M) // M

    kk = np.nonzero(ix_all < init_frames)[0]
    kk, jj = np.meshgrid(kk, np.arange(init_frames), indexing="ij")
    kk, jj = kk.reshape(-1), jj.reshape(-1)

    steps = []
    n = init_frames
    for s in range(STEPS):
        new_frame = -1
        if s >= init_frames and n < F:
            kk1 = np.nonzero(ix_all < n)[0]
            jj1 = np.full_like(kk1, n)
            kk2 = np.nonzero(ix_all == n)[0]
            kk2, jj2 = np.meshgrid(kk2, np.arange(n + 1), indexing="ij")
            kk = np.concatenate([kk, kk1, kk2.reshape(-1)])
            jj = np.concatenate([jj, jj1, jj2.reshape(-1)])
            new_frame = n
            n += 1

        ii = kk // M
        _, kk_seg = np.unique(kk, return_inverse=True)
        _, ij_seg = np.unique(ii * np.int64(1 << 20) + jj, return_inverse=True)
        nix, njx, hp, hn = neighbors(kk, jj)
        dij = np.abs(ii - jj)
        sup = np.nonzero((dij > 0) & (dij <= 2))[0]
        steps.append(
            StepTopo(kk.copy(), jj.copy(), ii, kk_seg.astype(np.int32),
                     ij_seg.astype(np.int32), nix, njx, hp, hn, n, new_frame, sup)
        )
    return steps


def owned_topo(st: StepTopo, rank: int, size: int) -> StepTopo:
    """The edges of st that rank ``rank`` of an edge axis of ``size`` ranks
    owns (``parallel.shard.owned_edges``: by patch), in their order: kk, jj,
    ii and the masks restricted; kk_seg the dense rank of the owned kk (the
    patches are this rank's alone); ij_seg st's frame-pair ids, which every
    rank shares; ix/jx and sup remapped to owned rows (a patch's
    neighbours are edges of the same patch). The edge list only grows at
    its end, so a step's owned edges lead the next step's. Raises where the
    rank owns no edge."""
    own = owned_edges(st.kk, rank, size)
    if own.size == 0:
        raise ValueError(f"owned_topo: edge rank {rank} of {size} owns none of a step's "
                         f"{len(st.kk)} edges (more edge ranks than patches a frame?)")
    row = np.full(len(st.kk), -1, np.int64)
    row[own] = np.arange(own.size)
    sup = row[st.sup]
    _, kk_seg = np.unique(st.kk[own], return_inverse=True)
    return StepTopo(st.kk[own], st.jj[own], st.ii[own], kk_seg.astype(np.int32), st.ij_seg[own],
                    row[st.ix[own]], row[st.jx[own]], st.mask_ix[own], st.mask_jx[own], st.n,
                    st.new_frame, sup[sup >= 0])


def step_tensors(st: StepTopo, device) -> Dict[str, torch.Tensor]:
    """A step's index arrays on the device (int32, as the kernels take
    them; ``sup`` int64), with the host's stable sort orders: kk's (BA's
    depth reduction, SoftAgg by patch and the correlation backward's gmap
    rows; kk_seg is kk's dense rank, so it sorts alike), ij_seg's and jj's
    (the correlation backward's walk over each frame's edges)."""
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device).to(torch.int32)
    return dict(
        kk=i32(st.kk), jj=i32(st.jj), ii=i32(st.ii), kk_seg=i32(st.kk_seg),
        ij_seg=i32(st.ij_seg), ix=i32(st.ix), jx=i32(st.jx),
        mask_ix=torch.as_tensor(st.mask_ix, device=device),
        mask_jx=torch.as_tensor(st.mask_jx, device=device),
        sup=torch.as_tensor(st.sup, device=device),
        kk_order=i32(np.argsort(st.kk, kind="stable")),
        ij_order=i32(np.argsort(st.ij_seg, kind="stable")),
        jj_order=i32(np.argsort(st.jj, kind="stable")),
    )


def draw_inputs(F: int, M: int, h: int, w: int, STEPS: int, generator: torch.Generator,
                device=None, strategy: str = "RANDOM") -> Dict[str, torch.Tensor]:
    """The unroll's random draws, as ``vo_forward`` takes them: the patch
    points on the 1/4-resolution map (h, w) under ``strategy`` (RANDOM:
    the centroids [F, M, 2]; GRADIENT_BIAS: candidates [F, 3M, 2], of which
    ``vo_forward`` keeps the M of highest image gradient), the initial
    inverse depths d0 [F*M] ~ U[0, 1), and each step's dropout coin drop
    [STEPS] (true with probability 0.1)."""
    K = draw_count(strategy, M)
    pts = torch.stack([random_candidates(K, h, w, generator) for _ in range(F)])
    d0 = torch.rand((F * M,), generator=generator)
    drop = torch.rand((STEPS,), generator=generator) < 0.1
    return {"points": pts.to(device), "d0": d0.to(device), "drop": drop.to(device)}


def _apply(module, prefix: str, params, *args, **kwargs):
    """module(*args) with ``params`` (a flat dict keyed like the networks'
    state dict) in place of its own parameters, when given."""
    if params is None:
        return module(*args, **kwargs)
    sub = {k[len(prefix) + 1:]: v for k, v in params.items() if k.startswith(prefix + ".")}
    return torch.func.functional_call(module, sub, args, kwargs)


def vo_forward(nets, cfg: Config, images, poses_gt, disps, intrinsics, draws, STEPS: int = 18,
               structure_only: bool = False, frozen_encoders: bool = False, remat: bool = True,
               params: Optional[Dict[str, torch.Tensor]] = None, mesh=None):
    """Returns a list of per-step supervision tuples (valid [Es], coords
    [Es,P,P,2], coords_gt [Es,P,P,2], poses [F,7], n) over the step's
    supervised edges (with a split mesh, this rank's).

    nets: ``runtime/weights.Networks``; params: an optional flat dict of
    tensors used in place of its parameters (the train step passes a
    differentiable bf16 cast of f32 master weights). images [F, H, W, 3]
    in [0, 255]; poses_gt [F, 7] world-to-camera; disps [F, H, W]
    ground-truth inverse depth; intrinsics [4] at full resolution; draws
    as ``draw_inputs`` gives them for ``cfg.CENTROID_SEL_STRAT`` (the
    GRADIENT_BIAS candidates scored on each frame's normalized image in
    the configuration's dtype, as the JAX patchifier scores them).
    ``frozen_encoders`` runs the patchifier without a gradient. mesh: a
    (data, edge) mesh (``parallel.make_mesh``) whose edge axis splits the
    unroll (see the module docstring); every rank of the edge group passes
    the same inputs and parameters, and takes the same collectives."""
    F, H, W, _ = images.shape
    M, P = cfg.PATCHES_PER_FRAME, cfg.P
    dev = images.device
    fdt = torch.bfloat16 if cfg.MIXED_PRECISION else torch.float32
    if dev.type != "cpu" and 6 * F > SPD_MAX_N:
        raise ValueError(f"vo_forward: the card's SPD kernel solves n <= {SPD_MAX_N} unknowns, "
                         f"so a clip holds at most {SPD_MAX_N // 6} frames (n_frames), got {F}")

    images_n = (2.0 * (images.to(torch.float32) / 255.0) - 0.5).to(fdt)
    intr_all = (intrinsics.to(torch.float32) / cfg.RES)[None].repeat(F, 1)
    disps4 = disps[:, 1::cfg.RES, 1::cfg.RES].to(torch.float32)

    centroids = select_centroids(images_n, draws["points"], M, cfg.CENTROID_SEL_STRAT)
    with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen_encoders):
        fmap, gmap, imap, patches, _ = _apply(nets.patchifier, "patchifier", params, images_n,
                                              centroids, disps=disps4)
    pyr1 = fmap.to(fdt)
    pyr2 = avg_pool2d_nhwc(pyr1, 4)
    gmap = gmap.to(fdt)

    patches_gt = patches
    d0 = draws["d0"].to(torch.float32)
    patches = torch.cat([patches[:, :2], d0[:, None, None, None].expand(F * M, 1, P, P)], 1)

    schedule = build_schedule(F, M, STEPS)
    split = edge_split(mesh)
    topos = schedule if split is None else [owned_topo(st, split.rank, split.size)
                                            for st in schedule]
    net_full = torch.zeros((len(topos[-1].kk), cfg.DIM), dtype=fdt, device=dev)

    Gs = se3.identity((F,), device=dev)
    if structure_only:
        Gs = poses_gt.to(torch.float32)
    poses_gt = poses_gt.to(torch.float32)

    h4, w4 = fmap.shape[1], fmap.shape[2]
    bounds = [-64.0, -64.0, w4 + 64.0, h4 + 64.0]
    c = P // 2

    traj = []
    for s, (st, tp) in enumerate(zip(schedule, topos)):
        Es, E = len(st.kk), len(tp.kk)  # the step's edges; this rank's
        t = step_tensors(tp, dev)
        ii, jj, kk = t["ii"], t["jj"], t["kk"]
        # the frame-pair groups, which a split sums over its ranks
        group = {} if split is None else dict(group=split, ij_shared=int(st.ij_seg.max()) + 1)

        def step_body(Gs, patches, net_full, st=st, Es=Es, E=E, t=t, ii=ii, jj=jj, kk=kk, s=s,
                      group=group):
            Gs, patches = Gs.detach(), patches.detach()
            if st.new_frame > 0:
                nf = st.new_frame
                if not structure_only:
                    Gs = torch.cat([Gs[:nf], Gs[nf - 1:nf], Gs[nf + 1:]])
                # the median of the previous two frames' inverse depths, the
                # mean of the middle two of an even count (jnp.median's)
                med = torch.quantile(patches[(nf - 2) * M:nf * M, 2].reshape(-1), 0.5)
                d = patches[:, 2:3]
                d = torch.cat([d[:nf * M], med.expand(M, 1, P, P), d[(nf + 1) * M:]])
                patches = torch.cat([patches[:, :2], d], 1)

            drop_frame = st.n - 4
            dropped = (ii == drop_frame) | (jj == drop_frame)
            valid = ~(draws["drop"][s] & dropped)

            coords = pops.transform(Gs, patches, intr_all, ii, jj, kk)
            corr = corr_features_train(gmap, pyr1, pyr2, coords.to(torch.float32).contiguous(),
                                       kk, jj, valid, t["kk_order"], t["jj_order"],
                                       radius=cfg.CORR_RADIUS)
            corr = corr.reshape(E, -1).to(fdt)

            net, delta, weight = _apply(
                nets.update, "update", params, net_full[:E], imap[kk.long()].to(fdt), corr,
                t["ix"], t["jx"], t["mask_ix"], t["mask_jx"], t["kk_seg"], t["ij_seg"], valid,
                num_segments=Es, kk_order=t["kk_order"], ij_order=t["ij_order"], **group)
            net_full = torch.cat([net, net_full[E:]])

            target = coords[:, c, c, :].to(torch.float32) + delta
            wgt = weight * valid[:, None]

            # two differentiable BA iterations; structure_only freezes every
            # pose (nfree = 0: the pose system is an identity solve)
            ctr = patches[:, :, c, c]
            nfree = 0 if structure_only else st.n - 1
            Gs, depths = ba_solver.ba(
                Gs, ctr, intr_all, target, wgt, valid, ii, jj, kk, 1, nfree, bounds, 1e-4,
                W=F, Md=F * M, iterations=2, ep=10.0, lm=1e-4, res_clip=250.0,
                clamp_mode="train", kd_order=t["kk_order"],
                allsum=ba_solver.no_sum if split is None else split.sum)
            dz = depths - ctr[:, 2]
            patches = torch.cat([patches[:, :2], patches[:, 2:] + dz[:, None, None, None]], 1)

            sup = t["sup"]
            cs = pops.transform(Gs, patches, intr_all, ii[sup], jj[sup], kk[sup])
            cs_gt, val_gt = pops.transform(poses_gt, patches_gt, intr_all, ii[sup], jj[sup],
                                           kk[sup], valid=True)
            val = val_gt * valid[sup]
            return Gs, patches, net_full, val, cs, cs_gt

        if remat and torch.is_grad_enabled():
            out = torch.utils.checkpoint.checkpoint(step_body, Gs, patches, net_full,
                                                    use_reentrant=False)
        else:
            out = step_body(Gs, patches, net_full)
        Gs, patches, net_full, val, cs, cs_gt = out
        traj.append((val, cs, cs_gt, Gs, st.n))
    return traj
