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

``clamp=True`` gives the windows of the v4 TPU kernel
(``dpvo_tpu/ops/corr_pallas.py:_level_coeffs``, ``CORR_IMPL=
pallas_fused``): each pixel's window corner is clamped into a
superwindow anchored 3 px before the patch centre's own corner, so a
pixel more than +-3 px from the centre samples the nearest window that
fits, and a pixel whose window lies wholly outside the image gives zero.
The integer corner arithmetic (``window_corners``,
``clamp_into_superwindow``) follows JAX's int32 semantics exactly, for the
superwindow kernels of ``ops/corr_pallas.py`` too.
"""

from __future__ import annotations

import torch


RS3, CS3 = 16, 24  # the v3/v4 superwindow: rows, columns (8-aligned corner)


def wrap_i32(v):
    """Two's-complement wrap of int64 values into the int32 range: JAX's
    int32 arithmetic wraps where int64 would not."""
    return torch.remainder(v + 2 ** 31, 2 ** 32) - 2 ** 31


def floor_i32(x):
    """``jnp.floor(x).astype(jnp.int32)`` as int64: saturating at the int32
    range, NaN to 0 (a plain torch cast of such values is undefined)."""
    f = torch.floor(x).double()
    f = torch.where(torch.isnan(f), torch.zeros_like(f), f)
    return f.clamp(-2.0 ** 31, 2.0 ** 31 - 1).long()


def window_corners(cs, radius: int):
    """Per-pixel window corners (sy, sx) = floor(coords) - radius (int64
    holding int32 values) and the fractions (dyf, dxf) of cs [..., 2]."""
    x, y = cs[..., 0], cs[..., 1]
    dxf, dyf = x - torch.floor(x), y - torch.floor(y)
    return wrap_i32(floor_i32(y) - radius), wrap_i32(floor_i32(x) - radius), dyf, dxf


def clamp_into_superwindow(sy, sx, margin: int, ymax: int, xmax: int, H: int, W: int):
    """An edge's superwindow corner (syc, sxc) [E]: the centre pixel's
    window corner less ``margin``, clamped into the zero border of 16, x
    aligned down to 8; and each pixel's window offset in it (dy, dxw) [E,
    P2], clamped to [0, ymax] x [0, xmax] (``corr_pallas.py:328-329``,
    ``:364-365``; ``:608-613``). sy/sx [E, P2], the map H x W."""
    c = sy.shape[1] // 2
    Wa = -(-W // 8) * 8
    syc = wrap_i32(sy[:, c] - margin).clamp(-16, H)
    sxc = torch.div(wrap_i32(sx[:, c] - margin).clamp(-16, Wa) + 16, 8,
                    rounding_mode="floor") * 8 - 16
    dy = wrap_i32(sy - syc[:, None]).clamp(0, ymax)
    dxw = wrap_i32(sx - sxc[:, None]).clamp(0, xmax)
    return syc, sxc, dy, dxw


def pixel_mask(valid, sy, sx, H: int, W: int, D: int):
    """1.0 where the edge is valid and the pixel's window can touch the
    image, else 0.0 (``vp`` of ``corr_pallas.py``)."""
    vp = valid[:, None] & (sy >= -D) & (sy <= H) & (sx >= -D) & (sx <= W)
    return vp.to(torch.float32)


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


def clamped_windows(cs, radius: int, H: int, W: int):
    """v4's windows for cs [E, P2, 2]: corners (y, x) [E, P2] clamped into
    the RS3 x CS3 superwindow (``corr_pallas.py:844-850``), the fractions
    and the mask of pixels whose own window can touch the image."""
    D = 2 * radius + 2
    sy, sx, dyf, dxf = window_corners(cs, radius)
    syc, sxc, dy, dxw = clamp_into_superwindow(sy, sx, 3, RS3 - 9, CS3 - 9, H, W)
    ok = pixel_mask(torch.ones_like(sy[:, 0], dtype=torch.bool), sy, sx, H, W, D)
    return syc[:, None] + dy, sxc[:, None] + dxw, dyf, dxf, ok


def sparse_corr(gmap, fmap, coords, ii1, jj1, radius: int = 3, chunk: int = 1024,
                clamp: bool = False):
    """One pyramid level of patch <-> frame correlation, exact windows
    (``clamp=True``: v4's clamped windows, see the module docstring).

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
        if clamp:
            y0, x0, fy, fx, keep = clamped_windows(cs, radius, H, W)
            offs = torch.arange(D, device=coords.device)
        else:
            x0, y0, fx, fy, offs = _window_index(cs, radius)
        ix = (x0[..., None, None] + offs[None, None, None, :]).expand(Ec, P * P, D, D)
        iy = (y0[..., None, None] + offs[None, None, :, None]).expand(Ec, P * P, D, D)
        ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        lin = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        f2 = fflat[jj1[s:s + chunk, None, None], lin.reshape(Ec, P * P, D * D)]
        corr = torch.einsum("epc,epdc->epd", f1, f2.float()).reshape(Ec, P * P, D, D)
        corr = corr * ok.to(corr.dtype)
        out = _bilinear(corr, fy[..., None, None], fx[..., None, None])
        outs.append(out * keep[..., None, None] if clamp else out)
    return torch.cat(outs, 0)


def corr_features_plain(gmap, fmap1, fmap2, coords, ii1, jj1, valid, radius: int = 3,
                        clamp: bool = False):
    """Both levels (fmap2 at coords / 4) in the canonical layout
    [E, P*P, 2*(2r+2)^2] bf16 (see the module docstring)."""
    E, P = coords.shape[0], coords.shape[1]
    D = 2 * radius + 2
    outs = []
    for fmap, scale in ((fmap1, 1.0), (fmap2, 4.0)):
        c = sparse_corr(gmap, fmap, coords / scale, ii1, jj1, radius, clamp=clamp)
        c = torch.nn.functional.pad(c, (0, 1, 0, 1))
        outs.append(c.reshape(E, P * P, D * D))
    # the reference keeps the f32 values (the port rounds them to bf16)
    return torch.cat(outs, -1) * valid[:, None, None].to(torch.float32)


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
