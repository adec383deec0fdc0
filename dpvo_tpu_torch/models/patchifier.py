"""Patch extraction: encoders + feature gathers at given centroids.

Port of ``dpvo_tpu/models/patchifier.py`` (RANDOM centroid strategy).
The centroids are an input: the caller draws them (``random_centroids``
with a ``torch.Generator``, or injected draws), because JAX's PRNG
cannot be reproduced in torch.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dpvo_tpu_torch.models.extractor import BasicEncoder4
from dpvo_tpu_torch.ops.corr import patchify


def random_centroids(M: int, h: int, w: int, generator: torch.Generator):
    """RANDOM strategy: integer (x, y) in [1, w-1) x [1, h-1), [M, 2] f32."""
    x = torch.randint(1, w - 1, (M,), generator=generator)
    y = torch.randint(1, h - 1, (M,), generator=generator)
    return torch.stack([x, y], dim=-1).to(torch.float32)


class Patchifier(nn.Module):
    def __init__(self, patch_size: int = 3, dim: int = 384, fdim: int = 128):
        super().__init__()
        self.patch_size = patch_size
        self.fnet = BasicEncoder4(fdim, norm_fn="instance")
        self.inet = BasicEncoder4(dim, norm_fn="none")

    def forward(self, images, centroids, disps=None):
        """images [B,H,W,3] normalized to [-0.5, 1.5]; centroids [B,M,2]
        (x, y) at 1/4 resolution.

        Returns fmap [B,h,w,fdim], gmap [B*M,fdim,P,P], imap [B*M,dim],
        patches [B*M,3,P,P] (x, y, inverse depth) and clr [B*M,3].
        """
        P = self.patch_size
        fmap = self.fnet(images) / 4.0
        imap = self.inet(images) / 4.0
        B, h, w, _ = fmap.shape
        if disps is None:
            disps = torch.ones((B, h, w), dtype=images.dtype, device=images.device)
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=images.device),
                                torch.arange(w, dtype=torch.float32, device=images.device),
                                indexing="ij")
        outs = []
        for b in range(B):
            cd = centroids[b].to(torch.float32)
            fm = fmap[b].permute(2, 0, 1).to(torch.float32)
            im = imap[b].permute(2, 0, 1).to(torch.float32)
            img = images[b].permute(2, 0, 1).to(torch.float32)
            grid = torch.stack([gx, gy, disps[b].to(torch.float32)], dim=0)
            outs.append((
                patchify(fm, cd, P // 2),
                patchify(im, cd, 0)[:, :, 0, 0],
                patchify(grid, cd, P // 2),
                patchify(img, 4.0 * (cd + 0.5), 0)[:, :, 0, 0],
            ))
        gmap, imap_p, patches, clr = (torch.cat(x, 0) for x in zip(*outs))
        return fmap, gmap, imap_p, patches, clr
