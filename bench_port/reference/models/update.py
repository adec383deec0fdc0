"""The recurrent update operator — ``nn.Module`` port of
``dpvo_tpu/models/update.py`` (upstream message passing: temporal
neighbours, SoftAgg by patch and by frame pair). Submodule names follow
the flax parameter tree.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from bench_port.reference.models.blocks import GatedResidual, LayerNorm, MLP2, SoftAgg, gradient_clip


class Update(nn.Module):
    def __init__(self, dim: int = 384, corr_width: int = 1152):
        super().__init__()
        D = dim
        self.Dense_0 = nn.Linear(corr_width, D)
        self.Dense_1 = nn.Linear(D, D)
        self.LayerNorm_0 = LayerNorm(D)
        self.Dense_2 = nn.Linear(D, D)
        self.LayerNorm_1 = LayerNorm(D)
        self.c1 = MLP2(D)
        self.c2 = MLP2(D)
        self.agg_kk = SoftAgg(D)
        self.agg_ij = SoftAgg(D)
        self.LayerNorm_2 = LayerNorm(D)
        self.GatedResidual_0 = GatedResidual(D)
        self.LayerNorm_3 = LayerNorm(D)
        self.GatedResidual_1 = GatedResidual(D)
        self.head_d = nn.Linear(D, 2)
        self.head_w = nn.Linear(D, 2)

    def forward(self, net, inp, corr, ix, jx, mask_ix, mask_jx, kk_seg, ij_seg, valid,
                num_segments: int, num_ij_segments: int = 0, kk_order=None, ij_order=None,
                group=None, ij_shared: int = 0):
        """One round of the recurrent edge-GNN.

        net [E,D] hidden state; inp [E,D] context; corr [E,CORR_WIDTH]
        canonical correlation features; ix/jx [E] previous/next edge of
        the same patch (masked by mask_ix/mask_jx); kk_seg/ij_seg [E]
        dense group ids; valid [E] edge mask; kk_order/ij_order [E]
        optional stable argsorts of kk_seg/ij_seg (the topology ships them;
        else SoftAgg sorts on the device). group (``parallel.shard.
        EdgeSplit``): the rows are this rank's share of a training unroll
        split by patch, kk_seg numbering this rank's patches and ij_seg the
        frame pairs of every rank, ij_shared of them (SoftAgg's ``shared``).

        Returns (net', delta [E,2] f32, weight [E,2] f32).
        """
        c = self.Dense_2(F.relu(self.LayerNorm_0(self.Dense_1(F.relu(self.Dense_0(corr))))))
        net = self.LayerNorm_1(net + inp + c)

        net = net + self.c1(mask_ix[:, None].to(net.dtype) * net[ix])
        net = net + self.c2(mask_jx[:, None].to(net.dtype) * net[jx])

        n_ij = num_ij_segments or num_segments
        net = net + self.agg_kk(net, kk_seg, num_segments, valid, kk_order, group)
        net = net + self.agg_ij(net, ij_seg, n_ij, valid, ij_order, group, ij_shared)

        net = self.GatedResidual_0(self.LayerNorm_2(net))
        net = self.GatedResidual_1(self.LayerNorm_3(net))

        d = gradient_clip(self.head_d(F.relu(net)).to(torch.float32))
        w = torch.sigmoid(gradient_clip(self.head_w(F.relu(net)).to(torch.float32)))
        return net, d, w
