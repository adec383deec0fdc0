"""Correlation features: the CUDA kernel's wrapper (``csrc/corr.cu``).

Port of the TPU correlation entry point
``dpvo_tpu/ops/corr_pallas.py:corr_features_pallas_fused`` (the v4
kernel). The kernel computes exact per-pixel windows (``CORR_IMPL`` auto
and xla, the semantics of ``corr_features_xla``) or, with ``clamp=True``,
v4's windows clamped within +-3 px of the patch centre's
(``CORR_IMPL=pallas_fused``); ``ops/corr.py:corr_features_plain`` is its
plain version, which the wrapper runs for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from dpvo_tpu_torch import kernels
from dpvo_tpu_torch.ops.corr import corr_features_plain


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
        E, Np, mem, C, H1, W1, H2, W2, int(gmap.dtype == torch.bfloat16), int(clamp),
        kernels.stream_ptr(coords))
    kernels.check("corr", rc)
    kernels.LAUNCHES["corr"] += 1
    return out
