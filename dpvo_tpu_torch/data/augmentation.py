"""Training augmentation: colour jitter, random grayscale and invert, and a
random rescale with centre crop and intrinsics adjustment.

Port of ``dpvo_tpu/data/augmentation.py`` without OpenCV: the resize is
``torch.nn.functional.interpolate(mode="bilinear", align_corners=False)``
on CPU tensors, OpenCV's ``INTER_LINEAR`` for float input at these
up-scales (half-pixel centres). ``color_jitter`` makes the same numpy
``Generator`` calls in the same order as the JAX package's, so one seed
gives both the same clip.
"""

from __future__ import annotations

import numpy as np
import torch


def color_jitter(images: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """images [F,H,W,3] float in [0,255]."""
    out = images
    # brightness / contrast / saturation jitter
    b = rng.uniform(0.75, 1.25)
    c = rng.uniform(0.75, 1.25)
    s = rng.uniform(0.6, 1.4)
    mean = out.mean(axis=(1, 2, 3), keepdims=True)
    out = (out - mean) * c + mean * b
    gray = out.mean(-1, keepdims=True)
    out = gray + (out - gray) * s
    if rng.uniform() < 0.1:  # random grayscale
        out = np.repeat(out.mean(-1, keepdims=True), 3, axis=-1)
    if rng.uniform() < 0.1:  # random invert
        out = 255.0 - out
    return np.clip(out, 0, 255)


def resize_bilinear(x: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """[N, H, W] or [N, H, W, C] float32 -> [N, nh, nw(, C)]: bilinear with
    half-pixel centres (OpenCV's INTER_LINEAR for float input)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    chw = t.permute(0, 3, 1, 2) if t.ndim == 4 else t[:, None]
    out = torch.nn.functional.interpolate(chw, size=(nh, nw), mode="bilinear",
                                          align_corners=False)
    out = out.permute(0, 2, 3, 1) if t.ndim == 4 else out[:, 0]
    return out.contiguous().numpy()


def random_scale_crop(images, disps, intrinsics, rng, out_hw=None, max_scale=2**0.5):
    """Random rescale + centre crop with intrinsics adjustment. Returns
    (images, disps, intrinsics)."""
    F, H, W = disps.shape
    out_h, out_w = out_hw or (H, W)
    min_scale = max(out_h / H, out_w / W)
    scale = rng.uniform(min_scale, max(max_scale, min_scale + 1e-3))
    nh, nw = int(round(H * scale)), int(round(W * scale))

    imgs = resize_bilinear(images, nh, nw)
    dsp = resize_bilinear(disps, nh, nw)
    intr = intrinsics * scale

    y0 = (nh - out_h) // 2
    x0 = (nw - out_w) // 2
    imgs = imgs[:, y0 : y0 + out_h, x0 : x0 + out_w]
    dsp = dsp[:, y0 : y0 + out_h, x0 : x0 + out_w]
    intr = intr - np.array([0, 0, x0, y0], intr.dtype)
    return imgs, dsp, intr


def augment_clip(images, disps, intrinsics, rng, out_hw=None):
    images = color_jitter(images, rng)
    return random_scale_crop(images, disps, intrinsics, rng, out_hw=out_hw)
