"""Patchify, pooling and the plain (reference) patch correlation.

Port of ``dpvo_tpu/ops/corr.py``. ``corr_features_plain`` computes the
exact per-pixel semantics of the reference altcorr kernel — each patch
pixel dotted against a (2r+2)^2 window of the frame features around its
reprojected position (zero outside the image), then a 2x2 bilinear
reduction with the coordinates' fractional part — for both pyramid
levels, in the canonical layout shared with the CUDA kernel
(``ops/corr_cuda.py``):

  out[e, p, l*D*D + u*D + v]   p = py*P+px, u = dy, v = dx, D = 2r+2

with the last row and column of each D x D block zero, ``valid``-masked
edges zero, bf16. This is the function the CUDA kernel is held to; the
JAX package's ``corr_features_xla`` computes the same values wherever
its 16-px region covers the window.
"""

from __future__ import annotations

import torch


def _window_index(coords, radius: int):
    """floor/frac of coords [..., 2] and the (2r+2) integer offsets."""
    x0 = torch.floor(coords[..., 0])
    y0 = torch.floor(coords[..., 1])
    fx = coords[..., 0] - x0
    fy = coords[..., 1] - y0
    offs = torch.arange(2 * radius + 2, device=coords.device) - radius
    return x0.long(), y0.long(), fx, fy, offs


def _bilinear(win, fy, fx):
    """2x2 bilinear reduction of [..., D, D] (rows dy, cols dx) windows
    with fractions broadcast over the leading axes -> [..., D-1, D-1]."""
    d = win.shape[-1] - 1
    return (
        (1 - fy) * (1 - fx) * win[..., :d, :d]
        + (1 - fy) * fx * win[..., :d, 1:]
        + fy * (1 - fx) * win[..., 1:, :d]
        + fy * fx * win[..., 1:, 1:]
    )


def sparse_corr(gmap, fmap, coords, ii1, jj1, radius: int = 3, chunk: int = 1024):
    """One pyramid level of patch <-> frame correlation, exact windows.

    gmap   [Np, C, P, P]   patch matching features
    fmap   [mem, H, W, C]  frame features (NHWC)
    coords [E, P, P, 2]    reprojected (x, y) at this level's scale
    ii1, jj1 [E]           gmap row / fmap slot per edge
    returns [E, P*P, 2r+1, 2r+1] float32, window axes (dy, dx)
    """
    E, P = coords.shape[0], coords.shape[1]
    mem, H, W, C = fmap.shape
    D = 2 * radius + 2
    fflat = fmap.reshape(mem, H * W, C)
    outs = []
    for s in range(0, E, chunk):
        cs = coords[s:s + chunk].reshape(-1, P * P, 2)
        Ec = cs.shape[0]
        f1 = gmap[ii1[s:s + chunk]].reshape(Ec, C, P * P).transpose(1, 2).float()
        x0, y0, fx, fy, offs = _window_index(cs, radius)
        ix = (x0[..., None, None] + offs[None, None, None, :]).expand(Ec, P * P, D, D)
        iy = (y0[..., None, None] + offs[None, None, :, None]).expand(Ec, P * P, D, D)
        ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        lin = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        f2 = fflat[jj1[s:s + chunk, None, None], lin.reshape(Ec, P * P, D * D)]
        corr = torch.einsum("epc,epdc->epd", f1, f2.float()).reshape(Ec, P * P, D, D)
        corr = corr * ok.to(corr.dtype)
        outs.append(_bilinear(corr, fy[..., None, None], fx[..., None, None]))
    return torch.cat(outs, 0)


def corr_features_plain(gmap, fmap1, fmap2, coords, ii1, jj1, valid, radius: int = 3):
    """Both levels (fmap2 at coords / 4) in the canonical layout
    [E, P*P, 2*(2r+2)^2] bf16 (see the module docstring)."""
    E, P = coords.shape[0], coords.shape[1]
    D = 2 * radius + 2
    outs = []
    for fmap, scale in ((fmap1, 1.0), (fmap2, 4.0)):
        c = sparse_corr(gmap, fmap, coords / scale, ii1, jj1, radius)
        c = torch.nn.functional.pad(c, (0, 1, 0, 1))
        outs.append(c.reshape(E, P * P, D * D))
    out = torch.cat(outs, -1) * valid[:, None, None].to(torch.float32)
    return out.to(torch.bfloat16)


def patchify(fmap, coords, radius: int):
    """Bilinear window gather at centroids.

    fmap [C, H, W]; coords [M, 2] (x, y) -> [M, C, 2r+1, 2r+1]
    """
    C, H, W = fmap.shape
    M = coords.shape[0]
    D = 2 * radius + 2
    x0, y0, fx, fy, offs = _window_index(coords, radius)
    ix = (x0[:, None, None] + offs[None, None, :]).expand(M, D, D)
    iy = (y0[:, None, None] + offs[None, :, None]).expand(M, D, D)
    ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    lin = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
    win = fmap.reshape(C, H * W)[:, lin] * ok.to(fmap.dtype)  # [C,M,D,D]
    win = win.transpose(0, 1)
    return _bilinear(win, fy[:, None, None, None], fx[:, None, None, None])


def avg_pool2d(x, k: int):
    """Average pool with stride k over [..., C, H, W]; H, W divisible by k."""
    if k == 1:
        return x
    *lead, C, H, W = x.shape
    return x.reshape(*lead, C, H // k, k, W // k, k).mean(dim=(-3, -1))


def avg_pool2d_nhwc(x, k: int):
    """Average pool with stride k over [..., H, W, C]; H, W divisible by k."""
    if k == 1:
        return x
    *lead, H, W, C = x.shape
    return x.reshape(*lead, H // k, k, W // k, k, C).mean(dim=(-4, -2))
