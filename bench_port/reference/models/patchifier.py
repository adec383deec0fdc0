"""Patch extraction: encoders + centroid selection + feature gathers.

Port of ``dpvo_tpu/models/patchifier.py``, both centroid strategies:
RANDOM takes M drawn centroids as they are; GRADIENT_BIAS scores 3M drawn
candidates by the image's pooled gradient magnitude and keeps the best M
(``gradient_bias_centroids``). The draws are an input: the caller makes
them (``random_candidates`` with a ``torch.Generator``, or injected
draws), because JAX's PRNG cannot be reproduced in torch. Selection runs
in torch on the images' device.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from bench_port.reference.models.extractor import BasicEncoder4
from bench_port.reference.ops.corr import patchify

STRATEGIES = ("RANDOM", "GRADIENT_BIAS")


def draw_count(strategy: str, M: int) -> int:
    """Points drawn per frame under a CENTROID_SEL_STRAT: M centroids
    (RANDOM) or 3M candidates (GRADIENT_BIAS); any other value raises, as
    the JAX patchifier does."""
    if strategy not in STRATEGIES:
        raise ValueError(f"CENTROID_SEL_STRAT={strategy!r}: expected one of {STRATEGIES}")
    return M if strategy == "RANDOM" else 3 * M


def random_candidates(n: int, h: int, w: int, generator: torch.Generator):
    """n integer (x, y) in [1, w-1) x [1, h-1), [n, 2] f32: x drawn first,
    then y. ``draw_count`` points a frame: RANDOM's M centroids or
    GRADIENT_BIAS's 3M candidates."""
    x = torch.randint(1, w - 1, (n,), generator=generator)
    y = torch.randint(1, h - 1, (n,), generator=generator)
    return torch.stack([x, y], dim=-1).to(torch.float32)


def image_gradient(images):
    """Grayscale gradient magnitude, 4x4 mean pooled: images [B,H,W,3]
    normalized, f32 or bf16 -> [B, (H-1)//4, (W-1)//4] in that dtype
    (``Patchifier._image_gradient`` of the JAX package).

    Bf16 follows the roundings of XLA's compiled program (its optimized
    HLO): x + 0.5 rounded, times 127.5 unrounded into an f32 channel sum
    (exact), the gray rounded, then each of the differences, squares, their
    sum and the square root rounded to bf16, the 16 taps summed in f32
    (exact for a real frame's magnitudes) and the mean rounded. That gives
    the JAX tracker's scores bit for bit on 480x640 and 48x64 frames (an
    op-by-op JAX run rounds the product too and differs in 24-85% of
    scores). F32: XLA's fused 4x4 sum takes an order that varies with the
    shape; this one (each row of 4 taps left to right, then the rows) gives
    its bits at 480x640 and differs by up to one ulp at other sizes. The
    square root goes through f64, which is correctly rounded on the CPU and
    the card alike (the CPU's vectorized f32 root is not always), and the
    sums run in a fixed order, so the card and the CPU choose the same
    centroids."""
    dt = images.dtype

    def rnd(t):  # the f32 result rounded to the images' dtype
        return t.to(dt).to(torch.float32)

    a = rnd(images.to(torch.float32) + 0.5) * 127.5
    gray = rnd((a[..., 0] + a[..., 1]) + a[..., 2])
    dx = rnd(gray[:, :-1, 1:] - gray[:, :-1, :-1])
    dy = rnd(gray[:, 1:, :-1] - gray[:, :-1, :-1])
    sq = rnd(rnd(dx * dx) + rnd(dy * dy))
    g = rnd(sq.to(torch.float64).sqrt().to(torch.float32))
    B, H1, W1 = g.shape
    h, w = H1 // 4, W1 // 4
    t = g[:, :h * 4, :w * 4].reshape(B, h, 4, w, 4)
    rows = [((t[:, :, r, :, 0] + t[:, :, r, :, 1]) + t[:, :, r, :, 2]) + t[:, :, r, :, 3]
            for r in range(4)]
    return ((((rows[0] + rows[1]) + rows[2]) + rows[3]) * 0.0625).to(dt)


def gradient_bias_centroids(images, candidates, M: int):
    """GRADIENT_BIAS strategy: images [B,H,W,3] normalized (the encoders'
    input, in its dtype), candidates [B, 3M, 2] integer (x, y) at 1/4
    resolution -> the M best scored by ``image_gradient``, [B, M, 2] f32,
    in descending score order with equal scores taken in candidate order
    (``jax.lax.top_k``'s order; a stable sort, where ``torch.topk``
    promises no order among ties).

    A candidate's score is the pooled gradient at row x, column y, each
    index clamped into the map, as the JAX patchifier reads it: its
    ``vmap(lambda gb, xb, yb: gb[yb, xb])(g, y, x)`` binds xb to y, and
    JAX clamps the gather's out-of-range rows (the reference DPVO samples
    row y, column x)."""
    g = image_gradient(images)
    B, gh, gw = g.shape
    c = candidates.to(torch.int64)
    row = c[..., 0].clamp(0, gh - 1)
    col = c[..., 1].clamp(0, gw - 1)
    score = g.reshape(B, gh * gw).gather(1, row * gw + col)
    top = torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :M]
    return c.gather(1, top[..., None].expand(B, M, 2)).to(torch.float32)


def select_centroids(images, draws, M: int, strategy: str):
    """The M centroids [B, M, 2] of a strategy from its draws [B, K, 2]
    (``draw_count`` points a frame)."""
    if draws.shape[-2] != draw_count(strategy, M):
        raise ValueError(f"{strategy} takes {draw_count(strategy, M)} drawn points a frame, "
                         f"got {draws.shape[-2]}")
    if strategy == "RANDOM":
        return draws.to(torch.float32)
    return gradient_bias_centroids(images, draws, M)


class Patchifier(nn.Module):
    def __init__(self, patch_size: int = 3, dim: int = 384, fdim: int = 128):
        super().__init__()
        self.patch_size = patch_size
        self.fnet = BasicEncoder4(fdim, norm_fn="instance")
        self.inet = BasicEncoder4(dim, norm_fn="none")

    def forward(self, images, centroids, disps=None):
        """images [B,H,W,3] normalized to [-0.5, 1.5]; centroids [B,M,2]
        (x, y) at 1/4 resolution (``select_centroids``).

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
