"""Device step functions of the VO runtime — port of
``dpvo_tpu/runtime/steps.py``.

PyTorch runs eagerly, so the JAX package's fused per-frame program, its
capacity buckets and its packed uint8 frame payload have no counterpart:
the host orchestrator (``runtime/dpvo.py``) calls these steps in order
on the live edge set. The steps update ``VOState`` buffers in place.

Given an ``ExportedVONet`` (``deploy/export.py``), patchify and the update
operator run its ``torch.export`` programs instead of the modules, as
the JAX steps run their StableHLO artifacts.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from dpvo_tpu_torch.ba import gba_sparse
from dpvo_tpu_torch.ba import solver as ba_solver
from dpvo_tpu_torch.config import Config
from dpvo_tpu_torch.geom import projective as pops
from dpvo_tpu_torch.lie import se3
from dpvo_tpu_torch.models.patchifier import select_centroids
from dpvo_tpu_torch.ops.corr import avg_pool2d_nhwc
from dpvo_tpu_torch.ops.corr_cuda import corr_features
from dpvo_tpu_torch.ops.corr_pallas import (corr_features_pallas, corr_features_pallas_dma,
                                            corr_features_pallas_sw)
from dpvo_tpu_torch.runtime.state import VOState
from dpvo_tpu_torch.runtime.topology import EdgeSet
from dpvo_tpu_torch.utils import trace

PAIR_MAX = 1024  # distinct (ii, jj) pairs in the active window (SoftAgg size / 2)

_TWO_OVER_255 = float(np.float32(2.0 / 255.0))

_EDGE_INDEX = ("ii", "jj", "kk", "ix", "jx", "dense2patch")
# read by the CUDA kernels as int32
_KERNEL_INDEX = ("ii1", "jj1", "kk_seg", "ij_seg", "kd", "kd_order", "ij_order")
_EDGE_MASKS = ("valid", "mask_ix", "mask_jx")
EDGE_UPLOADS = len(_EDGE_INDEX) + len(_KERNEL_INDEX) + len(_EDGE_MASKS)  # copies of edge_tensors

# CORR_IMPL -> the JAX tracker's correlation function of that name
# (dpvo_tpu/runtime/steps.py:57-65, :523-528); "auto" is "xla" off the TPU
CORR_IMPLS = ("auto", "xla", "pallas", "pallas_sw", "pallas_dma", "pallas_fused")
_CORR_FNS = {"pallas": corr_features_pallas, "pallas_sw": corr_features_pallas_sw,
             "pallas_dma": corr_features_pallas_dma}


def edge_tensors(es: EdgeSet, device) -> Dict[str, torch.Tensor]:
    """The EdgeSet's arrays as device tensors (the kernels' indices int32,
    the others int64)."""
    out = {k: torch.as_tensor(np.asarray(getattr(es, k), np.int64), device=device)
           for k in _EDGE_INDEX}
    for k in _KERNEL_INDEX:
        out[k] = torch.as_tensor(np.asarray(getattr(es, k), np.int32), device=device)
    for k in _EDGE_MASKS:
        out[k] = torch.as_tensor(getattr(es, k), device=device)
    out["n_depths"] = es.n_depths
    out["count"] = es.count
    return out


def _uploads(*arrays) -> int:
    """The blocking copies that uploading arrays makes: an empty one copies
    nothing."""
    return sum(np.size(a) > 0 for a in arrays)


def median(x):
    """Median that averages the two middle values of an even-length
    input (``jnp.median``; ``torch.median`` returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) / 2


class PatchifyStep(nn.Module):
    """The tracker's patchify on tensors alone (the module that
    ``deploy/export.py`` exports): image [H,W,3] uint8, draws [K,2] ->
    (fmap [h,w,fdim], gmap [M,fdim,P,P], imap [M,dim], patches [M,3,P,P],
    clr [M,3] f32). The draws are the M centroids (RANDOM) or 3M candidates
    (GRADIENT_BIAS), selected here from the normalized image in the
    configuration's dtype, which the encoders read
    (``models/patchifier.select_centroids``), so an exported program keeps
    the selection. The features in the configuration's dtype; the colours
    in BGR order and scaled to [0, 255] as the JAX step makes them
    (``dpvo_tpu/runtime/steps.py:_patchify``)."""

    def __init__(self, patchifier, fdt, M: int, strategy: str = "RANDOM"):
        super().__init__()
        self.patchifier = patchifier
        self.fdt = fdt
        self.M = M
        self.strategy = strategy

    def forward(self, image_u8, draws):
        img = (2.0 * (image_u8.to(torch.float32) / 255.0) - 0.5).to(self.fdt)[None]
        centroids = select_centroids(img, draws[None], self.M, self.strategy)
        fmap, gmap, imap, patches, _ = self.patchifier(img, centroids)
        # the colours: the centroids are integers, so JAX's bilinear sample
        # at 4 * (c + 0.5) reads the one pixel (4y + 2, 4x + 2). Its value
        # normalized as XLA computes it for the JAX tracker: u times
        # f32(2/255) minus 0.5 rounded once (a fused multiply-add, exact in
        # f64), whose roundings the truncation to uint8 tells apart; rounded
        # to the configuration's dtype as the encoders' input is
        c = (4 * centroids[0] + 2).long()
        u = image_u8[c[:, 1], c[:, 0]]
        clr = (u.to(torch.float64) * _TWO_OVER_255 - 0.5).to(torch.float32)
        clr = clr.to(self.fdt).to(torch.float32)
        clr = (clr.flip(-1) + 0.5) * (255.0 / 2)
        return fmap[0].to(self.fdt), gmap.to(self.fdt), imap.to(self.fdt), patches, clr


class StepFunctions:
    def __init__(self, cfg: Config, nets, device, exported=None, mesh=None):
        """mesh: a ``parallel.make_mesh`` mesh; with one, the global BA runs
        through ``ba/gba_sparse.dist_gba``, its rows and kpairs split over
        the mesh's edge axis (JAX step :36-53)."""
        self.cfg = cfg
        self.nets = nets
        self.device = device
        self.fdt = torch.bfloat16 if cfg.MIXED_PRECISION else torch.float32
        self.exported = exported
        self.mesh = mesh
        if exported is not None:
            self.patchify = exported.patchify
        elif nets is not None:
            self.patchify = PatchifyStep(nets.patchifier, self.fdt, cfg.PATCHES_PER_FRAME,
                                         cfg.CENTROID_SEL_STRAT)
        self.pmem = cfg.MAX_EDGE_AGE if cfg.LOOP_CLOSURE else cfg.PMEM
        if cfg.CORR_IMPL not in CORR_IMPLS:
            raise ValueError(f"CORR_IMPL={cfg.CORR_IMPL!r}: expected one of {CORR_IMPLS}")
        self.corr_impl = "xla" if cfg.CORR_IMPL == "auto" else cfg.CORR_IMPL

    # ---------------- frame ingestion ----------------

    def _patchify(self, image_u8, draws):
        """image_u8 [H,W,3] uint8, draws [K,2] (``PatchifyStep``'s) ->
        (fmap [h,w,fdim], gmap [M,fdim,P,P], imap [M,dim], patches [M,3,P,P],
        clr [M,3]): ``PatchifyStep``, or the exported program of it."""
        return self.patchify(image_u8, draws)

    def _ingest(self, state: VOState, n: int, fmap, gmap_p, imap_p, patches, clr, intrinsics,
                motion_fac: float, is_initialized: bool, do_motion: bool, depth_init):
        """Write one frame into row n of the buffers, with the
        damped-linear motion model and the depth init (random before
        initialization, else the median of the last three frames). The
        colours clr [M,3] are cast to uint8 by truncation, as JAX's
        ``astype`` does."""
        cfg = self.cfg
        M = cfg.PATCHES_PER_FRAME
        with trace.blocked("upload", "intrinsics", self.device):
            intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32, device=self.device)
        state.intrinsics[n] = intrinsics / cfg.RES
        state.colors[n] = clr.to(torch.uint8)

        P1 = state.poses[max(n - 1, 0)]
        P2 = state.poses[max(n - 2, 0)]
        if do_motion:
            xi = cfg.MOTION_DAMPING * motion_fac * se3.log(se3.mul(P1, se3.inv(P2)))
            state.poses[n] = se3.mul(se3.exp(xi), P1)
        else:
            state.poses[n] = P1

        if is_initialized:
            lo = max(n - 3, 0) * M
            depth = median(state.dvec[lo:lo + 3 * M]).expand(M)
        else:
            with trace.blocked("upload", "depth_init", self.device):
                depth = depth_init.to(device=self.device, dtype=torch.float32)
        patches = patches.clone()
        patches[:, 2] = depth[:, None, None]
        state.patches[n * M:(n + 1) * M] = patches
        state.dvec[n * M:(n + 1) * M] = depth

        slot = (n % self.pmem) * M
        state.imap[slot:slot + M] = imap_p
        state.gmap[slot:slot + M] = gmap_p
        state.fmap1[n % cfg.MEM] = fmap
        state.fmap2[n % cfg.MEM] = avg_pool2d_nhwc(fmap, 4)

    def _zero_edges(self, state: VOState, start: int, count: int):
        """Zero the hidden state of freshly appended edges, within the
        clamped window of min(E_MAX, M*2*PATCH_LIFETIME) rows from
        ``start`` (the caller chunks larger appends by that span)."""
        cfg = self.cfg
        span = min(cfg.E_MAX, cfg.PATCHES_PER_FRAME * 2 * cfg.PATCH_LIFETIME)
        s0 = min(max(start, 0), cfg.E_MAX - span)
        lo, hi = max(start, s0), min(start + count, s0 + span)
        if hi > lo:
            state.net[lo:hi] = 0

    # ---------------- the hot loop ----------------

    def _edge_forward(self, state: VOState, es: Dict[str, torch.Tensor], net=None):
        """reproject -> correlate -> update operator."""
        with trace.span("edge_forward", E=es["count"], n_depths=es["n_depths"]):
            cfg = self.cfg
            E = es["ii"].shape[0]
            if net is None:
                net = state.net[:E]
            coords = pops.transform(state.poses, state.patches, state.intrinsics, es["ii"],
                                    es["jj"], es["kk"], depth=state.dvec)
            corr = self._corr(state, coords.to(torch.float32).contiguous(), es)
            corr = corr.reshape(E, -1).to(self.fdt)
            ctx = state.imap[es["ii1"]]
            args = (net, ctx, corr, es["ix"], es["jx"], es["mask_ix"], es["mask_jx"],
                    es["kk_seg"], es["ij_seg"], es["valid"])
            if self.exported is not None:
                net, delta, weight = self.exported.update(
                    *args, es["kd_order"], es["ij_order"],
                    num_segments=es["dense2patch"].shape[0])
            else:
                net, delta, weight = self.nets.update(
                    *args, num_segments=es["dense2patch"].shape[0],
                    num_ij_segments=2 * PAIR_MAX, kk_order=es["kd_order"],
                    ij_order=es["ij_order"])
            c = cfg.P // 2
            target = coords[:, c, c, :].to(torch.float32) + delta
            return net, target, weight, delta

    def _corr(self, state: VOState, coords, es: Dict[str, torch.Tensor]):
        """Correlation features by CORR_IMPL (JAX step :523-538). The
        pallas variants take bf16 features whatever the configuration, as
        their JAX namesakes do. Where the JAX step ships the host's jj sort,
        the port sorts on the device: the same order, so the same values."""
        r = self.cfg.CORR_RADIUS
        args = (state.gmap, state.fmap1, state.fmap2, coords, es["ii1"], es["jj1"], es["valid"])
        if self.corr_impl == "xla":
            return corr_features(*args, radius=r)
        bf16 = tuple(t.to(torch.bfloat16) for t in args[:3]) + args[3:]
        if self.corr_impl == "pallas_fused":
            return corr_features(*bf16, radius=r, clamp=True)
        return _CORR_FNS[self.corr_impl](*bf16, radius=r)

    def _ba_bounds(self, state: VOState):
        """Image bounds +- BA_BORDER, from frame 0's intrinsics (device side)."""
        cx, cy = state.intrinsics[0, 2], state.intrinsics[0, 3]
        b = self.cfg.BA_BORDER
        return torch.stack([torch.full_like(cx, -b), torch.full_like(cy, -b), 2 * cx + b, 2 * cy + b])

    def _update(self, state: VOState, es: Dict[str, torch.Tensor], t0: int, nfree: int):
        """One tracking round: update operator + sliding-window BA."""
        target, weight = self._update_noba(state, es)
        self._window_ba(state, es, target, weight, t0, nfree)

    def _ba_only(self, state: VOState, es: Dict[str, torch.Tensor], target, weight, t0: int,
                 nfree: int):
        """Sliding-window BA on given targets and weights [E, 2] (the oracle
        hook: the network's prediction bypassed); they are stored as the
        edges' own, which the global BA reads."""
        E = es["ii"].shape[0]
        state.target[:E] = target
        state.weight[:E] = weight
        self._window_ba(state, es, target, weight, t0, nfree)

    def _update_noba(self, state: VOState, es: Dict[str, torch.Tensor]):
        """The update operator alone (before a global-BA round, which takes
        the sliding-window solve's place); stores and returns the edges'
        target and weight."""
        E = es["ii"].shape[0]
        net, target, weight, _ = self._edge_forward(state, es)
        state.net[:E] = net
        state.target[:E] = target
        state.weight[:E] = weight
        return target, weight

    def _window_ba(self, state: VOState, es: Dict[str, torch.Tensor], target, weight, t0: int,
                   nfree: int):
        with trace.span("window_ba"):
            cfg = self.cfg
            c = cfg.P // 2
            nd = es["n_depths"]
            Md = es["dense2patch"].shape[0]
            d2p = es["dense2patch"][:nd]
            ctr = torch.zeros((Md, 3), dtype=torch.float32, device=self.device)
            ctr[:nd, :2] = state.patches[d2p, :2, c, c]
            ctr[:nd, 2] = state.dvec[d2p]
            poses, depths = ba_solver.ba(
                state.poses, ctr, state.intrinsics, target, weight, es["valid"], es["ii"],
                es["jj"], es["kd"], t0, nfree, self._ba_bounds(state), cfg.BA_LMBDA,
                W=cfg.W_OPT_MAX, Md=Md, iterations=cfg.BA_ITERS, ep=cfg.BA_EP, lm=cfg.BA_LM,
                res_clip=cfg.BA_RESIDUAL_CLIP, clamp_mode="runtime", kd_order=es["kd_order"])
            state.poses.copy_(poses)
            state.dvec[d2p] = depths[:nd]

    def _probe(self, state: VOState, es: Dict[str, torch.Tensor]):
        """Motion probe: median |delta| over the probe edges with zero
        hidden state, no BA (the upper middle for an even count, as the
        JAX step takes it)."""
        E = es["ii"].shape[0]
        zero_net = torch.zeros((E, self.cfg.DIM), dtype=self.fdt, device=self.device)
        _, _, _, delta = self._edge_forward(state, es, net=zero_net)
        mag = torch.linalg.norm(delta, dim=-1)
        mag = torch.where(es["valid"], mag, torch.full_like(mag, 1e9))
        k = es["count"]
        return torch.sort(mag).values[k // 2]

    def _flowmag_pair(self, state: VOState, ii, jj, kk, beta: float):
        """Mean flow magnitude over the given edges."""
        mag, _ = pops.flow_mag(state.poses, state.patches, state.intrinsics, ii, jj, kk,
                               beta=beta, depth=state.dvec)
        return mag.mean(dim=(1, 2)).sum() / max(ii.shape[0], 1)

    # ---------------- topology maintenance ----------------

    def _compact_edges(self, state: VOState, keep: torch.Tensor):
        """Move the kept edges' payloads to the front, in order."""
        n = keep.shape[0]
        for buf in (state.net, state.target, state.weight):
            buf[:n] = buf[keep]

    def _store_inactive(self, state: VOState, src: torch.Tensor, dst: torch.Tensor):
        """Copy removed edges' targets/weights into the inactive ring."""
        state.target_inac[dst] = state.target[src]
        state.weight_inac[dst] = state.weight[src]

    def _keyframe_shift(self, state: VOState, k: int, n_after: int):
        """Delete keyframe k: frame-indexed rows k..n_after-1 take rows
        k+1..n_after; circular slots f % period take (f+1) % period for
        f = k..n_after (a gather from the buffer before the move)."""
        M = self.cfg.PATCHES_PER_FRAME
        for buf, rows in ((state.poses, 1), (state.intrinsics, 1), (state.colors, 1),
                          (state.patches, M), (state.dvec, M)):
            buf[k * rows:n_after * rows] = buf[(k + 1) * rows:(n_after + 1) * rows].clone()
        f = np.arange(k, n_after + 1)
        for buf, period, rows in ((state.imap, self.pmem, M), (state.gmap, self.pmem, M),
                                  (state.fmap1, self.cfg.MEM, 1), (state.fmap2, self.cfg.MEM, 1)):
            dst = ((f % period)[:, None] * rows + np.arange(rows)[None, :]).reshape(-1)
            src = (((f + 1) % period)[:, None] * rows + np.arange(rows)[None, :]).reshape(-1)
            with trace.blocked("upload", "keyframe_shift", self.device, 2):
                dst, src = (torch.as_tensor(x, device=self.device) for x in (dst, src))
            buf[dst] = buf[src]

    def _apply_pgo(self, state: VOState, poses_new, scales, m: int):
        """Apply a Sim(3) PGO result: poses < m from poses_new [>= m, 7],
        and their patches' inverse depths divided by their frame's scale
        (scales [>= m])."""
        M = self.cfg.PATCHES_PER_FRAME
        state.poses[:m] = poses_new[:m]
        state.dvec[:m * M] = state.dvec[:m * M] / scales[:m].repeat_interleave(M)

    # ---------------- outputs ----------------

    def _point_cloud(self, state: VOState, m: int):
        """World points [m, 3] at the centre pixels of the m live patches
        (viewer, PLY and COLMAP export), dehomogenised as the JAX step does
        (``dpvo_tpu/runtime/steps.py:_point_cloud``)."""
        cfg = self.cfg
        ix = torch.arange(m, device=self.device) // cfg.PATCHES_PER_FRAME
        X = pops.point_cloud(state.poses, state.patches[:m], state.intrinsics, ix,
                             depth=state.dvec[:m])
        c = cfg.P // 2
        w = X[:, c, c, 3:]
        return X[:, c, c, :3] / torch.clamp(w.abs(), min=1e-8) * torch.sign(w)

    # ---------------- global BA + gauge ----------------

    def _normalize(self, state: VOState, n: int, m: int):
        """Scale-gauge guard before a global-BA round, as the JAX step: only
        when the mean inverse depth of the m live patches has left [1e-2,
        1e2], divide the depths and scale the translations of the n live
        poses by s (the mean clamped to [0.25, 4]) and re-anchor them to
        pose 0; otherwise s = 1 and nothing moves. Returns s (a device
        scalar)."""
        d = state.dvec[:m]
        s_raw = d.sum() / max(m, 1)
        drifted = (s_raw < 1e-2) | (s_raw > 1e2)
        s = torch.where(drifted, torch.clamp(s_raw, 0.25, 4.0), torch.ones_like(s_raw))
        state.dvec[:m] = d / s
        poses = state.poses[:n].clone()
        poses[:, :3] = poses[:, :3] * s
        anchored = se3.mul(poses, se3.inv(poses[0])[None])
        state.poses[:n] = torch.where(drifted, anchored, poses)
        return s

    def _global_ba(self, state: VOState, ges, pos, ninac: int, t0: int, nfree: int, idx):
        """Full-history BA over the inactive and active edges, sparse-assembled
        (``ba/gba_sparse.py``). ges: ``Topology.global_edge_set``'s edges;
        pos [ninac] the ring slots of the first ninac; idx: their sparsity
        (``build_sparse_indices`` with W = max(nfree, 1)). With a mesh,
        through ``dist_gba``."""
        arrays = [pos, ges["dense2patch"], ges["ii"], ges["jj"], ges["kd"]]
        arrays += [idx[k] for k in gba_sparse.UPLOADED]
        with trace.blocked("upload", "gba", self.device, _uploads(*arrays)):
            args, kw = self._gba_inputs(state, ges, pos, ninac, t0, nfree, idx)
        if self.mesh is None:
            poses, depths = gba_sparse.gba(*args, **kw)
        else:
            poses, depths = gba_sparse.dist_gba(self.mesh, *args, **kw)
        state.poses.copy_(poses)
        with trace.blocked("upload", "gba_depths", self.device):
            d2p = torch.as_tensor(ges["dense2patch"], device=self.device)
        state.dvec[d2p] = depths

    def _gba_inputs(self, state: VOState, ges, pos, ninac: int, t0: int, nfree: int, idx):
        """The arguments of ``gba_sparse.gba`` for a global-BA round: the
        edges' stored target and weight (the inactive ring's slots pos, then
        the active edges'), the depth variables' patch centres and inverse
        depths, the sparsity on the device."""
        cfg = self.cfg
        dev = self.device
        E = ges["count"]
        pos = torch.as_tensor(np.asarray(pos, np.int64), device=dev)
        target = torch.cat([state.target_inac[pos], state.target[:E - ninac]])
        weight = torch.cat([state.weight_inac[pos], state.weight[:E - ninac]])
        c = cfg.P // 2
        d2p = torch.as_tensor(ges["dense2patch"], dtype=torch.int64, device=dev)
        ctr = torch.cat([state.patches[d2p, :2, c, c], state.dvec[d2p][:, None]], 1)
        t = lambda k, dt: torch.as_tensor(np.asarray(ges[k]), dtype=dt, device=dev)
        args = (state.poses, ctr, state.intrinsics, target, weight,
                torch.ones(E, dtype=torch.bool, device=dev), t("ii", torch.int64),
                t("jj", torch.int64), t("kd", torch.int32), t0, nfree, self._ba_bounds(state),
                cfg.BA_LMBDA, gba_sparse.index_tensors(idx, dev))
        kw = dict(W=max(nfree, 1), Md=ges["n_depths"], iterations=cfg.GBA_ITERS, ep=cfg.BA_EP,
                  lm=cfg.BA_LM, res_clip=cfg.BA_RESIDUAL_CLIP)
        return args, kw
