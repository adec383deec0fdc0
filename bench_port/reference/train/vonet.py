"""VONet's training forward in the plain reference: the VO unroll with BA
in the loop, from the recipe's definition (princeton-vl/DPVO
``dpvo/net.py:VONet.forward``, as the port's ``models/vonet.py`` states it).

On a clip it patchifies every frame (both encoders), builds a patch graph
among the first 8 frames, then runs STEPS rounds of the update operator
and two differentiable BA iterations while one frame a step joins from
step 8 on, and returns each step's supervision for the clip loss. Plain
``torch`` in f32: the correlation is ``corr_features_plain``'s exact
windows (its gather and products differentiable in the features), BA's
reductions ``index_add_``, the pose solve a Cholesky factorization; the
correlation's coordinates, and each step's incoming poses and patches,
carry no gradient, as in the recipe. ``remat`` recomputes each unroll
step in the backward pass (``torch.utils.checkpoint``), so that a step of
480x640 clips fits the card.

``precision="fp8"`` is the control: every convolution's and dense layer's
weight and input rounded to e4m3 in the forward pass (the gradients pass
straight through the rounding), and the stored features (fmap, gmap,
imap) and each step's hidden state rounded too.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from bench_port.reference.ba import solver as ba_solver
from bench_port.reference.geom import projective as pops
from bench_port.reference.lie import se3
from bench_port.reference.models.patchifier import select_centroids
from bench_port.reference.ops.corr import avg_pool2d_nhwc, corr_features_plain
from bench_port.reference.precision import fp8_round
from bench_port.reference.runtime.topology import neighbors


class StepTopo(NamedTuple):
    kk: np.ndarray
    jj: np.ndarray
    ii: np.ndarray
    kk_seg: np.ndarray
    ij_seg: np.ndarray
    ix: np.ndarray
    jx: np.ndarray
    mask_ix: np.ndarray
    mask_jx: np.ndarray
    n: int              # frames in the graph
    new_frame: int      # the frame that joined at this step (-1: none)
    sup: np.ndarray     # supervised edges: 0 < |ii - jj| <= 2


def build_schedule(F: int, M: int, STEPS: int, init_frames: int = 8) -> List[StepTopo]:
    """Every patch of the first ``init_frames`` frames to each of them;
    from step ``init_frames`` on, one frame joins a step (the old patches to
    it, its patches to every frame so far)."""
    init_frames = min(init_frames, F)
    ix_all = np.arange(F * M) // M
    kk = np.nonzero(ix_all < init_frames)[0]
    kk, jj = np.meshgrid(kk, np.arange(init_frames), indexing="ij")
    kk, jj = kk.reshape(-1), jj.reshape(-1)
    steps, n = [], init_frames
    for s in range(STEPS):
        new_frame = -1
        if s >= init_frames and n < F:
            kk1 = np.nonzero(ix_all < n)[0]
            kk2, jj2 = np.meshgrid(np.nonzero(ix_all == n)[0], np.arange(n + 1), indexing="ij")
            kk = np.concatenate([kk, kk1, kk2.reshape(-1)])
            jj = np.concatenate([jj, np.full_like(kk1, n), jj2.reshape(-1)])
            new_frame, n = n, n + 1
        ii = kk // M
        _, kk_seg = np.unique(kk, return_inverse=True)
        _, ij_seg = np.unique(ii * np.int64(1 << 20) + jj, return_inverse=True)
        nix, njx, hp, hn = neighbors(kk, jj)
        dij = np.abs(ii - jj)
        steps.append(StepTopo(kk.copy(), jj.copy(), ii, kk_seg, ij_seg, nix, njx, hp, hn, n,
                              new_frame, np.nonzero((dij > 0) & (dij <= 2))[0]))
    return steps


def _ste(x, rounded):
    """rounded in the forward pass, the identity's gradient."""
    return x + (rounded - x).detach()


def _fp8_product(mod, args, out):
    x = _ste(args[0], fp8_round(args[0]))
    w = _ste(mod.weight, fp8_round(mod.weight))
    if isinstance(mod, torch.nn.Linear):
        return torch.nn.functional.linear(x, w, mod.bias)
    return mod._conv_forward(x, w, mod.bias)


def fp8_products(nets):
    """The control's products: each convolution and dense layer computes
    again from its weight and input rounded to e4m3. Returns the hooks'
    handles."""
    return [m.register_forward_hook(_fp8_product) for m in nets.modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]


def vo_forward(nets, cfg, images, poses_gt, disps, intrinsics, draws, STEPS: int = 18,
               remat: bool = True, precision: str = "f32"):
    """[(valid [Es], coords [Es,P,P,2], coords_gt, poses [F,7], n)] a step,
    over its supervised edges. images [F,H,W,3] in [0, 255]; poses_gt
    [F,7] world-to-camera; disps [F,H,W] inverse depth; intrinsics [4];
    draws: points [F,M,2] at 1/4 resolution, d0 [F*M], drop [STEPS]."""
    F, H, W, _ = images.shape
    M, P = cfg.PATCHES_PER_FRAME, cfg.P
    dev = images.device
    low = (lambda x: _ste(x, fp8_round(x))) if precision == "fp8" else (lambda x: x)

    images_n = 2.0 * (images.to(torch.float32) / 255.0) - 0.5
    intr_all = (intrinsics.to(torch.float32) / cfg.RES)[None].repeat(F, 1)
    disps4 = disps[:, 1::cfg.RES, 1::cfg.RES].to(torch.float32)
    centroids = select_centroids(images_n, draws["points"], M, cfg.CENTROID_SEL_STRAT)
    fmap, gmap, imap, patches, _ = nets.patchifier(images_n, centroids, disps=disps4)
    pyr1 = low(fmap)
    pyr2 = avg_pool2d_nhwc(pyr1, 4)
    gmap, imap = low(gmap), low(imap)

    patches_gt = patches
    d0 = draws["d0"].to(torch.float32)
    patches = torch.cat([patches[:, :2], d0[:, None, None, None].expand(F * M, 1, P, P)], 1)
    schedule = build_schedule(F, M, STEPS)
    net_full = torch.zeros((len(schedule[-1].kk), cfg.DIM), device=dev)
    Gs = se3.identity((F,), device=dev)
    poses_gt = poses_gt.to(torch.float32)
    h4, w4 = fmap.shape[1], fmap.shape[2]
    bounds = [-64.0, -64.0, w4 + 64.0, h4 + 64.0]
    c = P // 2
    idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)

    traj = []
    for s, st in enumerate(schedule):
        E = len(st.kk)
        ii, jj, kk = idx(st.ii), idx(st.jj), idx(st.kk)
        t = dict(kk_seg=idx(st.kk_seg), ij_seg=idx(st.ij_seg), ix=idx(st.ix), jx=idx(st.jx),
                 mask_ix=torch.as_tensor(st.mask_ix, device=dev),
                 mask_jx=torch.as_tensor(st.mask_jx, device=dev), sup=idx(st.sup))

        def step_body(Gs, patches, net_full, st=st, E=E, t=t, ii=ii, jj=jj, kk=kk, s=s):
            Gs, patches = Gs.detach(), patches.detach()
            if st.new_frame > 0:
                nf = st.new_frame
                Gs = torch.cat([Gs[:nf], Gs[nf - 1:nf], Gs[nf + 1:]])
                med = torch.quantile(patches[(nf - 2) * M:nf * M, 2].reshape(-1), 0.5)
                d = patches[:, 2:3]
                d = torch.cat([d[:nf * M], med.expand(M, 1, P, P), d[(nf + 1) * M:]])
                patches = torch.cat([patches[:, :2], d], 1)
            dropped = (ii == st.n - 4) | (jj == st.n - 4)
            valid = ~(draws["drop"][s] & dropped)

            coords = pops.transform(Gs, patches, intr_all, ii, jj, kk)
            corr = corr_features_plain(gmap, pyr1, pyr2, coords.detach(), kk, jj, valid,
                                       cfg.CORR_RADIUS).reshape(E, -1)
            net, delta, weight = nets.update(
                net_full[:E], imap[kk], corr, t["ix"], t["jx"], t["mask_ix"], t["mask_jx"],
                t["kk_seg"], t["ij_seg"], valid, num_segments=E)
            net_full = low(torch.cat([net, net_full[E:]]))
            target = coords[:, c, c, :] + delta
            wgt = weight * valid[:, None]
            ctr = patches[:, :, c, c]
            Gs, depths = ba_solver.ba(
                Gs, ctr, intr_all, target, wgt, valid, ii, jj, kk, 1, st.n - 1, bounds, 1e-4,
                W=F, Md=F * M, iterations=2, ep=10.0, lm=1e-4, res_clip=250.0,
                clamp_mode="train")
            dz = depths - ctr[:, 2]
            patches = torch.cat([patches[:, :2], patches[:, 2:] + dz[:, None, None, None]], 1)
            sup = t["sup"]
            cs = pops.transform(Gs, patches, intr_all, ii[sup], jj[sup], kk[sup])
            cs_gt, val_gt = pops.transform(poses_gt, patches_gt, intr_all, ii[sup], jj[sup],
                                           kk[sup], valid=True)
            return Gs, patches, net_full, val_gt * valid[sup], cs, cs_gt

        if remat and torch.is_grad_enabled():
            out = torch.utils.checkpoint.checkpoint(step_body, Gs, patches, net_full,
                                                    use_reentrant=False)
        else:
            out = step_body(Gs, patches, net_full)
        Gs, patches, net_full, val, cs, cs_gt = out
        traj.append((val, cs, cs_gt, Gs, st.n))
    return traj
