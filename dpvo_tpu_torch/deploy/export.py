"""Deployment export: ``torch.export`` programs of the network, the port of
``dpvo_tpu/deploy/export.py`` (StableHLO there).

An export directory holds:
    patchify.pt2   image [H,W,3] uint8, draws [K,2] -> fmap, gmap, imap,
                   patches, clr (``runtime/steps.PatchifyStep``: K = M
                   centroids under RANDOM, 3M candidates under
                   GRADIENT_BIAS, whose selection the program holds)
    update.pt2     net, ctx, corr, ix, jx, mask_ix, mask_jx, kk_seg, ij_seg,
                   valid, kk_order, ij_order -> net', delta, weight
                   (``UpdateStep``), at any edge count 2..e_max
    meta.json      the JAX package's keys (ht, wd, e_max, dim, fdim,
                   corr_width, patches_per_frame, mixed_precision,
                   m_opt_max, pair_max), the device type it runs on and
                   the centroid strategy (centroid_sel_strat)
    params.npz     the weights in the JAX package's format

The patch draws are an input, not a PRNG key: the tracker draws them
(``runtime/dpvo.py``), and a tracker runs only an export of its own
strategy. The JAX package pads the update to ``e_max`` edges
and exports a second program at the motion probe's edge count; the port
runs on the live edge count, so ``update.pt2`` is exported once with a
dynamic edge dimension. Its segment counts are fixed at the capacities
the JAX artifact fixes (``M_OPT_MAX`` depth variables, ``2 * PAIR_MAX``
frame pairs), which are the ones the eager tracker passes whenever the
live depth variables fit in ``M_OPT_MAX`` (``runtime/topology.py`` pads
``dense2patch`` to it); SoftAgg's branch (``models/blocks.py``) is taken
at those counts. The segment sum is the op ``dpvo_tpu_torch::segment_sum``
(``ba/segsum.py``), so the program keeps it as a node, which launches the
hand-written kernel on the card. A program is exported on the device it
will run on (its constants live there).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Optional

import torch
import torch.nn as nn

import dpvo_tpu_torch.ba.segsum  # noqa: F401  (registers dpvo_tpu_torch::segment_sum)
from dpvo_tpu_torch.config import Config
from dpvo_tpu_torch.models.patchifier import draw_count, random_candidates
from dpvo_tpu_torch.runtime.steps import PAIR_MAX, PatchifyStep
from dpvo_tpu_torch.runtime.weights import save_npz

class UpdateStep(nn.Module):
    """The update operator on tensors alone, its segment counts fixed."""

    def __init__(self, update, num_segments: int, num_ij_segments: int):
        super().__init__()
        self.update = update
        self.num_segments = num_segments
        self.num_ij_segments = num_ij_segments

    def forward(self, net, ctx, corr, ix, jx, mask_ix, mask_jx, kk_seg, ij_seg, valid,
                kk_order, ij_order):
        return self.update(net, ctx, corr, ix, jx, mask_ix, mask_jx, kk_seg, ij_seg, valid,
                           num_segments=self.num_segments,
                           num_ij_segments=self.num_ij_segments, kk_order=kk_order,
                           ij_order=ij_order)


def update_inputs(cfg: Config, E: int, device, generator: torch.Generator):
    """UpdateStep's inputs at E edges, with the dtypes the tracker passes
    (``runtime/steps.edge_tensors``): random features, valid indices, the
    stable orders of the group ids."""
    fdt = torch.bfloat16 if cfg.MIXED_PRECISION else torch.float32
    g = generator

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(device, fdt)

    def ids(n, dtype):
        return torch.randint(0, n, (E,), generator=g).to(device, dtype)

    kk_seg, ij_seg = ids(cfg.M_OPT_MAX, torch.int32), ids(2 * PAIR_MAX, torch.int32)
    flag = lambda p: (torch.rand(E, generator=g) < p).to(device)
    order = lambda s: torch.argsort(s, stable=True).to(torch.int32)
    return (rnd(E, cfg.DIM), rnd(E, cfg.DIM), rnd(E, cfg.CORR_WIDTH), ids(E, torch.int64),
            ids(E, torch.int64), flag(0.8), flag(0.8), kk_seg, ij_seg, flag(0.95),
            order(kk_seg), order(ij_seg))


def export_network(nets, cfg: Config, ht: int, wd: int, outdir: str, device="cuda",
                   e_max: Optional[int] = None) -> str:
    """Export ``Networks`` nets (f32, as ``runtime/weights.load_networks``
    makes them) for (ht, wd) images on ``device`` into outdir."""
    device = torch.device(device)
    os.makedirs(outdir, exist_ok=True)
    E = e_max or cfg.E_MAX
    fdt = torch.bfloat16 if cfg.MIXED_PRECISION else torch.float32
    save_npz(os.path.join(outdir, "params.npz"), nets.state_dict())
    nets = copy.deepcopy(nets).to(device, fdt).eval()
    g = torch.Generator().manual_seed(0)
    M, h, w = cfg.PATCHES_PER_FRAME, ht // cfg.RES, wd // cfg.RES
    image = torch.randint(0, 256, (ht, wd, 3), generator=g, dtype=torch.uint8).to(device)
    points = random_candidates(draw_count(cfg.CENTROID_SEL_STRAT, M), h, w, g).to(device)
    # an example edge count that equals no other size of the program
    e_ex = max(2, min(E, 2 * M + 3))
    dyn = {0: torch.export.Dim("E", min=2, max=E)}
    with torch.no_grad():
        pf = torch.export.export(PatchifyStep(nets.patchifier, fdt, M, cfg.CENTROID_SEL_STRAT),
                                 (image, points))
        up = torch.export.export(UpdateStep(nets.update, cfg.M_OPT_MAX, 2 * PAIR_MAX),
                                 update_inputs(cfg, e_ex, device, g),
                                 dynamic_shapes=(dyn,) * 12)
    torch.export.save(pf, os.path.join(outdir, "patchify.pt2"))
    torch.export.save(up, os.path.join(outdir, "update.pt2"))
    meta = dict(ht=ht, wd=wd, e_max=E, dim=cfg.DIM, fdim=cfg.FDIM, corr_width=cfg.CORR_WIDTH,
                patches_per_frame=M, mixed_precision=bool(cfg.MIXED_PRECISION),
                m_opt_max=cfg.M_OPT_MAX, pair_max=PAIR_MAX, device=device.type,
                centroid_sel_strat=cfg.CENTROID_SEL_STRAT)
    with open(os.path.join(outdir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return outdir


def read_meta(outdir: str) -> dict:
    with open(os.path.join(outdir, "meta.json")) as f:
        return json.load(f)


def load_exported(outdir: str) -> "ExportedVONet":
    """The programs of an export directory (the segment-sum op is
    registered by this module's import)."""
    return ExportedVONet(torch.export.load(os.path.join(outdir, "patchify.pt2")),
                         torch.export.load(os.path.join(outdir, "update.pt2")), read_meta(outdir))


class ExportedVONet:
    """The network of an export directory, in the tracker's calling
    convention (``runtime/steps.StepFunctions``)."""

    def __init__(self, patchify_ep, update_ep, meta):
        self.patchify_program, self.update_program = patchify_ep, update_ep
        self.patchify = patchify_ep.module()  # (image_u8, draws) as PatchifyStep
        self._update = update_ep.module()
        self.meta = meta
        self.e_max = meta["e_max"]

    def update(self, net, ctx, corr, ix, jx, mask_ix, mask_jx, kk_seg, ij_seg, valid, kk_order,
               ij_order, num_segments: Optional[int] = None):
        """One update round at E edges, 2 <= E <= e_max; ``num_segments``,
        when given, must be the depth-variable count the program sums into."""
        E = net.shape[0]
        if not 2 <= E <= self.e_max:
            raise ValueError(f"the exported update takes 2..{self.e_max} edges, got {E}")
        if num_segments is not None and num_segments != self.meta["m_opt_max"]:
            raise ValueError(f"the exported update sums into {self.meta['m_opt_max']} depth "
                             f"variables (M_OPT_MAX), this round has {num_segments}")
        return self._update(net, ctx, corr, ix, jx, mask_ix, mask_jx, kk_seg, ij_seg, valid,
                            kk_order, ij_order)
