"""Correlation features: the CUDA kernel's wrapper (``csrc/corr.cu``).

Port of the TPU correlation entry point
``dpvo_tpu/ops/corr_pallas.py:corr_features_pallas_fused`` (the v4
kernel). The kernel computes exact per-pixel windows (``CORR_IMPL`` auto
and xla, the semantics of ``corr_features_xla``) or, with ``clamp=True``,
v4's windows clamped within +-3 px of the patch centre's
(``CORR_IMPL=pallas_fused``); ``ops/corr.py:corr_features_plain`` is its
plain version, which the wrapper runs for CPU tensors; a CUDA tensor
launches the kernel or raises.

bf16 features with C = 128 channels (every shipped configuration's FDIM)
go to the tile kernel: it computes an (edge, level) item from its union
window staged in shared memory when the union fits its level's stage (rows
of at most ``BOX_W[level]`` positions, at most ``STAGE_POS[level]`` in
all), else by its per-pixel branch (``union_tile_levels`` applies the
kernel's rule). f32 features, and bf16 at another C, go to the per-pixel
kernel.
"""

from __future__ import annotations

import torch

from dpvo_tpu_torch import kernels
from dpvo_tpu_torch.ops.corr import clamped_windows, corr_features_plain, window_corners

BOX_W = (12, 9)  # union row width staged per level (csrc/corr.cu: kBoxW1, kBoxW2)
STAGE_POS = (132, 90)  # positions a level's stage holds (kStagePos1, kStagePos2)


def union_tile_levels(coords, hw1, hw2, radius: int = 3, clamp: bool = False):
    """[E, 2] bool: which levels of which edges the tile kernel computes
    from a staged union window (True) rather than by its per-pixel branch.
    The kernel's rule: the union, the bounding box of the 9 pixels' window
    corners (v4's clamped corners with ``clamp``) widened by the window,
    is at most BOX_W[level] wide and its rows of BOX_W[level] positions
    hold at most STAGE_POS[level]. hw1 / hw2: each level's map (H, W)."""
    E, P = coords.shape[0], coords.shape[1]
    D = 2 * radius + 2
    cs = coords.reshape(E, P * P, 2)
    fits = []
    for (H, W), scale, bw, cap in zip((hw1, hw2), (1.0, 4.0), BOX_W, STAGE_POS):
        c = cs / scale
        by, bx = (clamped_windows(c, radius, H, W) if clamp else window_corners(c, radius))[:2]
        uh, uw = by.amax(1) - by.amin(1) + D, bx.amax(1) - bx.amin(1) + D
        fits.append((uw <= bw) & (uh * bw <= cap))
    return torch.stack(fits, 1)


def corr_features(gmap, fmap1, fmap2, coords, ii1, jj1, valid, radius: int = 3,
                  clamp: bool = False):
    """Two-level correlation features, canonical [E, P*P, 2*(2r+2)^2] bf16.

    gmap [Np, C, P, P]; fmap1 [mem, H1, W1, C], fmap2 [mem, H2, W2, C]
    (NHWC, the same dtype as gmap: bf16 or f32); coords [E, P, P, 2] f32
    at level-1 scale; ii1 / jj1 [E] gmap row / fmap slot; valid [E] bool.
    clamp: v4's clamped windows.
    """
    if coords.device.type == "cpu":
        return corr_features_plain(gmap, fmap1, fmap2, coords, ii1, jj1, valid, radius, clamp)
    E, P = coords.shape[0], coords.shape[1]
    Np, C = gmap.shape[0], gmap.shape[1]
    mem, H1, W1, _ = fmap1.shape
    _, H2, W2, _ = fmap2.shape
    if radius != 3 or P != 3:
        raise ValueError("the CUDA correlation kernel is built for CORR_RADIUS=3, P=3")
    if gmap.dtype not in (torch.bfloat16, torch.float32) or fmap1.dtype != gmap.dtype \
            or fmap2.dtype != gmap.dtype:
        raise ValueError(f"corr: gmap/fmap dtypes {gmap.dtype}/{fmap1.dtype}/{fmap2.dtype}")
    bf16 = gmap.dtype == torch.bfloat16
    if C % 8 or fmap1.shape[-1] != C or fmap2.shape[-1] != C or fmap2.shape[0] != mem:
        raise ValueError(f"corr: channel/slot mismatch {tuple(gmap.shape)} "
                         f"{tuple(fmap1.shape)} {tuple(fmap2.shape)}")
    if coords.dtype != torch.float32 or coords.shape[2:] != (P, 2):
        raise ValueError(f"corr: coords must be f32 [E,{P},{P},2], got {coords.dtype} "
                         f"{tuple(coords.shape)}")
    if ii1.dtype != torch.int32 or jj1.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError(f"corr: ii1/jj1 must be int32 and valid bool, got {ii1.dtype}/"
                         f"{jj1.dtype}/{valid.dtype}")
    if ii1.shape != (E,) or jj1.shape != (E,) or valid.shape != (E,):
        raise ValueError("corr: ii1/jj1/valid must be [E]")
    kernels.require_cuda("corr", gmap, fmap1, fmap2, coords, ii1, jj1, valid)
    for t in (gmap, fmap1, fmap2):
        if t.data_ptr() % 16:
            raise ValueError("corr: feature buffers must be 16-byte aligned")
    lib = kernels.load()
    out = torch.empty((E, P * P, 2 * (2 * radius + 2) ** 2), dtype=torch.bfloat16,
                      device=coords.device)
    rc = lib.dpvo_corr_features(
        gmap.data_ptr(), fmap1.data_ptr(), fmap2.data_ptr(), coords.data_ptr(),
        ii1.data_ptr(), jj1.data_ptr(), valid.data_ptr(), out.data_ptr(),
        E, Np, mem, C, H1, W1, H2, W2, int(bf16), int(clamp),
        kernels.stream_ptr(coords))
    kernels.check("corr", rc)
    kernels.count("corr")
    return out
