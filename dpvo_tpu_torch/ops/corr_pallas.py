"""The correlation variants behind ``CORR_IMPL`` = ``pallas``, ``pallas_sw``
and ``pallas_dma``: port of ``dpvo_tpu/ops/corr_pallas.py``
(``_corr_features_common`` and its three level functions).

Each entry point computes the two-level correlation features in the
canonical layout of ``ops/corr.py`` ([E, P*P, 2*(2r+2)^2] bf16) as its
JAX namesake does, rounding points included:

- the edges are sorted valid-first by target slot (a stable device sort,
  the order of the host's ``corr_sort_order`` that the JAX step ships
  for pallas_dma), the patch features gathered in that order, and the
  result unsorted at the end;
- the patch and frame features are bf16 whatever the configuration;
- per level, a kernel takes the dots of the patch pixels with a
  rectangle of the frame map (f32 accumulation, rounded once to bf16;
  zero outside the image; zero for invalid edges):

  ``pallas``      kernel A, each pixel's exact D x D window;
  ``pallas_sw``   kernel B, one RS x CS = 14 x 32 superwindow per edge,
                  anchored at the centre pixel, shared by its 9 pixels;
  ``pallas_dma``  kernel C, one RS3 x CS3 = 16 x 24 superwindow per edge;

- the window selection and the 2x2 bilinear reduction follow: in torch
  for A and B (XLA in JAX; gathers here, not the TPU's one-hot stacks),
  in kernel D for C (the v3 tap stencil, its row stage rounded to bf16
  after every tap as the TPU's bf16 scratch is).

The superwindow variants clamp each pixel's window into the superwindow
(within +-3 px of the patch centre), as the TPU kernels do. The
128-edge padding of the TPU kernels is a block size and is left out: the
port runs on the live edges.

Every kernel has a wrapper here that runs its plain version for CPU
tensors and launches the CUDA kernel (``csrc/corr_pallas.cu``) for CUDA
tensors, or raises.
"""

from __future__ import annotations

import torch

from dpvo_tpu_torch import kernels
from dpvo_tpu_torch.ops.corr import CS3, RS3, clamp_into_superwindow, pixel_mask, window_corners

RS, CS = 14, 32  # the pallas_sw superwindow (corr_pallas.py:259-260)
_BF16 = torch.bfloat16


# ---------------- plain versions of the kernels ----------------


def _map_rows(fmap, jj, valid, iy, ix):
    """Frame-feature vectors at (iy, ix) [E, ...] of slot jj [E] as f32,
    zero outside the image and for invalid edges."""
    mem, H, W, C = fmap.shape
    ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    ok = ok & valid.reshape((-1,) + (1,) * (iy.dim() - 1))
    lin = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(iy.shape[0], -1)
    rows = fmap.reshape(mem, H * W, C)[jj.long().clamp(0, mem - 1)[:, None], lin]
    return rows.float() * ok.reshape(iy.shape[0], -1, 1).to(torch.float32)


def corr_window_plain(f1, fmap, jj, valid, sy, sx, D: int = 8, chunk: int = 256):
    """Kernel A's function: out[e, p, u*D + v] = bf16(f1[e, p] .
    fmap[jj[e], sy[e, p] + u, sx[e, p] + v]). f1 [E, P2, C] bf16, fmap
    [mem, H, W, C] bf16, jj [E], valid [E] bool, sy/sx [E, P2] -> [E, P2,
    D*D] bf16."""
    E, P2, _ = f1.shape
    off = torch.arange(D, device=f1.device)
    outs = []
    for s in range(0, E, chunk):
        e = slice(s, s + chunk)
        iy = (sy[e].long()[..., None, None] + off[:, None]).expand(-1, -1, D, D)
        ix = (sx[e].long()[..., None, None] + off[None, :]).expand(-1, -1, D, D)
        rows = _map_rows(fmap, jj[e], valid[e], iy, ix).reshape(iy.shape[0], P2, D * D, -1)
        outs.append(torch.einsum("epc,epdc->epd", f1[e].float(), rows).to(_BF16))
    return torch.cat(outs, 0)


def superwindow_plain(f1, fmap, jj, valid, syc, sxc, R: int, Cw: int, chunk: int = 256):
    """Kernels B and C's function: out[e, p, r*Cw + c] = bf16(f1[e, p] .
    fmap[jj[e], syc[e] + r, sxc[e] + c]) for the R x Cw superwindow at
    (syc, sxc) [E] -> [E, P2, R*Cw] bf16."""
    E = f1.shape[0]
    r = torch.arange(R, device=f1.device)[:, None]
    c = torch.arange(Cw, device=f1.device)[None, :]
    outs = []
    for s in range(0, E, chunk):
        e = slice(s, s + chunk)
        iy = (syc[e].long()[:, None, None] + r).expand(-1, R, Cw)
        ix = (sxc[e].long()[:, None, None] + c).expand(-1, R, Cw)
        rows = _map_rows(fmap, jj[e], valid[e], iy, ix)
        outs.append(torch.einsum("epc,eqc->epq", f1[e].float(), rows).to(_BF16))
    return torch.cat(outs, 0)


def epilogue_v3_plain(s, dy, dxw, dyf, dxf, vf):
    """Kernel D's function (``_make_epi_kernel``, corr_pallas.py:510-533):
    s [E, P2, RS3*CS3] bf16; dy, dxw [E, P2] int; dyf, dxf, vf [E, P2] f32
    -> [E, P2, 7*CS3] bf16. Row stage: 9 taps merging the row one-hot with
    the y-bilinear, each product and each running sum rounded to bf16;
    column stage: 17 taps merging the column one-hot (alignment remainder
    included) with the x-bilinear and the pixel mask, f32 accumulation."""
    E, P2, _ = s.shape
    W7 = 7 * CS3
    dy, dxw = dy.long(), dxw.long()
    tmp = torch.zeros((E, P2, W7 + 24), dtype=_BF16, device=s.device)
    for a in range(9):
        cR = (dy == a).float() * (1.0 - dyf) + (dy == a - 1).float() * dyf
        tmp[:, :, :W7] += (cR[..., None] * s[:, :, a * CS3:a * CS3 + W7].float()).to(_BF16)
    acc = torch.zeros((E, P2, W7), dtype=torch.float32, device=s.device)
    for b in range(17):
        cC = (dxw == b).float() * (1.0 - dxf) + (dxw == b - 1).float() * dxf
        acc += (cC * vf)[..., None] * tmp[:, :, b:b + W7].float()
    return acc.to(_BF16)


# ---------------- kernel wrappers ----------------


def _check(name, f1, fmap, jj, valid, corners):
    E, P2, C = f1.shape
    if f1.dtype != _BF16 or fmap.dtype != _BF16:
        raise ValueError(f"{name}: f1/fmap must be bf16, got {f1.dtype}/{fmap.dtype}")
    if P2 != 9 or fmap.shape[-1] != C or C not in (32, 64, 128, 256):
        raise ValueError(f"{name}: f1 {tuple(f1.shape)} / fmap {tuple(fmap.shape)} (the kernel "
                         "takes 9 patch pixels and 32, 64, 128 or 256 channels)")
    if jj.dtype != torch.int32 or valid.dtype != torch.bool or jj.shape != (E,) \
            or valid.shape != (E,):
        raise ValueError(f"{name}: jj must be int32 [E] and valid bool [E]")
    for t in corners:
        if t.dtype != torch.int32 or t.shape[0] != E:
            raise ValueError(f"{name}: window corners must be int32 [E, ...]")
    kernels.require_cuda(name, f1, fmap, jj, valid, *corners)
    if f1.data_ptr() % 4 or fmap.data_ptr() % 16:
        raise ValueError(f"{name}: f1/fmap must be 4/16-byte aligned")


def corr_window(f1, fmap, jj, valid, sy, sx):
    """Kernel A (``CORR_IMPL=pallas``): each patch pixel's exact 8 x 8
    window of raw dots; see ``corr_window_plain``. On the card jj, sy, sx
    are int32."""
    if f1.device.type == "cpu":
        return corr_window_plain(f1, fmap, jj, valid, sy, sx)
    _check("corr_window", f1, fmap, jj, valid, (sy, sx))
    E, P2, C = f1.shape
    mem, H, W, _ = fmap.shape
    out = torch.empty((E, P2, 64), dtype=_BF16, device=f1.device)
    rc = kernels.load().dpvo_corr_window(
        f1.data_ptr(), fmap.data_ptr(), jj.data_ptr(), valid.data_ptr(), sy.data_ptr(),
        sx.data_ptr(), out.data_ptr(), E, mem, H, W, C, kernels.stream_ptr(f1))
    kernels.check("corr_window", rc)
    kernels.LAUNCHES["corr_window"] += 1
    return out


def _superwindow(name, entry, R, Cw, f1, fmap, jj, valid, syc, sxc):
    if f1.device.type == "cpu":
        return superwindow_plain(f1, fmap, jj, valid, syc, sxc, R, Cw)
    _check(name, f1, fmap, jj, valid, (syc, sxc))
    E, P2, C = f1.shape
    mem, H, W, _ = fmap.shape
    out = torch.empty((E, P2, R * Cw), dtype=_BF16, device=f1.device)
    rc = getattr(kernels.load(), entry)(
        f1.data_ptr(), fmap.data_ptr(), jj.data_ptr(), valid.data_ptr(), syc.data_ptr(),
        sxc.data_ptr(), out.data_ptr(), E, mem, H, W, C, kernels.stream_ptr(f1))
    kernels.check(name, rc)
    kernels.LAUNCHES[name] += 1
    return out


def superwindow_sw(f1, fmap, jj, valid, syc, sxc):
    """Kernel B (``CORR_IMPL=pallas_sw``): the 14 x 32 superwindow of raw
    dots at (syc, sxc) [E] for all 9 pixels -> [E, 9, 448] bf16."""
    return _superwindow("corr_sw", "dpvo_corr_superwindow_sw", RS, CS, f1, fmap, jj, valid,
                        syc, sxc)


def superwindow_v3(f1, fmap, jj, valid, syc, sxc):
    """Kernel C (``CORR_IMPL=pallas_dma``): the 16 x 24 superwindow of raw
    dots at (syc, sxc) [E] for all 9 pixels -> [E, 9, 384] bf16."""
    return _superwindow("corr_v3", "dpvo_corr_superwindow_v3", RS3, CS3, f1, fmap, jj, valid,
                        syc, sxc)


def epilogue_v3(s, dy, dxw, dyf, dxf, vf):
    """Kernel D (the v3 epilogue); see ``epilogue_v3_plain``. On the card
    dy, dxw are int32 and dyf, dxf, vf f32, all [E, 9]."""
    if s.device.type == "cpu":
        return epilogue_v3_plain(s, dy, dxw, dyf, dxf, vf)
    E, P2, SW = s.shape
    if s.dtype != _BF16 or (P2, SW) != (9, RS3 * CS3):
        raise ValueError(f"corr_v3_epi: s must be bf16 [E, 9, {RS3 * CS3}], got {s.dtype} "
                         f"{tuple(s.shape)}")
    if dy.dtype != torch.int32 or dxw.dtype != torch.int32 or any(
            t.dtype != torch.float32 for t in (dyf, dxf, vf)):
        raise ValueError("corr_v3_epi: dy/dxw must be int32 and dyf/dxf/vf f32")
    if any(t.shape != (E, P2) for t in (dy, dxw, dyf, dxf, vf)):
        raise ValueError("corr_v3_epi: dy/dxw/dyf/dxf/vf must be [E, 9]")
    kernels.require_cuda("corr_v3_epi", s, dy, dxw, dyf, dxf, vf)
    out = torch.empty((E, P2, 7 * CS3), dtype=_BF16, device=s.device)
    rc = kernels.load().dpvo_corr_epilogue_v3(
        s.data_ptr(), dy.data_ptr(), dxw.data_ptr(), dyf.data_ptr(), dxf.data_ptr(),
        vf.data_ptr(), out.data_ptr(), E, kernels.stream_ptr(s))
    kernels.check("corr_v3_epi", rc)
    kernels.LAUNCHES["corr_v3_epi"] += 1
    return out


# ---------------- the level functions ----------------


def _i32(t):
    return t.to(torch.int32).contiguous()


def window_inputs(cs, vs, H: int, W: int, radius: int):
    """Kernel A's arguments for one level of the map (H x W): each pixel's
    window corner (sy, sx) int32 [E, P2], clipped as the TPU's cache
    corners are (a clipped pixel has vf = 0), and the bilinear terms (dyf,
    dxf, vf) f32 [E, P2]. cs [E, P2, 2] and vs [E] in sorted edge order."""
    D = 2 * radius + 2
    sy, sx, dyf, dxf = window_corners(cs, radius)
    return ((_i32(sy.clamp(-D, H)), _i32(sx.clamp(-D, W))),
            (dyf, dxf, pixel_mask(vs, sy, sx, H, W, D)))


def _superwindow_inputs(cs, vs, H, W, radius, margin, ymax, xmax):
    D = 2 * radius + 2
    sy, sx, dyf, dxf = window_corners(cs, radius)
    syc, sxc, dy, dxw = clamp_into_superwindow(sy, sx, margin, ymax, xmax, H, W)
    return ((_i32(syc), _i32(sxc)),
            (_i32(dy), _i32(dxw), dyf.contiguous(), dxf.contiguous(),
             pixel_mask(vs, sy, sx, H, W, D)))


def sw_inputs(cs, vs, H: int, W: int, radius: int):
    """Kernel B's arguments for one level (``_corr_level_sw``,
    corr_pallas.py:328-329, :364-365): the superwindow corner (syc, sxc)
    int32 [E]; each pixel's window offset in it (dy, dxw) int32 and the
    bilinear terms (dyf, dxf, vf) f32, [E, P2]."""
    D = 2 * radius + 2
    return _superwindow_inputs(cs, vs, H, W, radius, (RS - D) // 2, RS - D, CS - D)


def v3_inputs(cs, vs, H: int, W: int, radius: int):
    """Kernel C's superwindow corner and kernel D's arguments for one level
    (``_corr_level_v3``, corr_pallas.py:608-613), as ``sw_inputs``: pixel
    windows clamped within +-3 px of the centre's."""
    return _superwindow_inputs(cs, vs, H, W, radius, 3, RS3 - 9, CS3 - 9)


def _bilinear_weights(dyf, dxf, vf):
    """The four 2x2 bilinear weights times the pixel mask [E, P2, 1]."""
    return [(w * vf)[..., None] for w in ((1 - dyf) * (1 - dxf), (1 - dyf) * dxf,
                                          dyf * (1 - dxf), dyf * dxf)]


def level_window(fmap, f1, cs, jj, vs, radius: int):
    """``_corr_level`` (corr_pallas.py:155-243): one level, exact
    per-pixel windows. fmap [mem, H, W, C] bf16; f1 [E, P2, C] bf16 and
    cs [E, P2, 2], jj [E], vs [E] in sorted edge order -> [E, P2, D*D]."""
    _, H, W, _ = fmap.shape
    D = 2 * radius + 2
    corners, (dyf, dxf, vf) = window_inputs(cs, vs, H, W, radius)
    sw = corr_window(f1, fmap, jj, vs, *corners).float()
    w00, w01, w10, w11 = _bilinear_weights(dyf, dxf, vf)
    o = (w00 * sw + w01 * torch.roll(sw, -1, -1) + w10 * torch.roll(sw, -D, -1)
         + w11 * torch.roll(sw, -(D + 1), -1))
    lane = torch.arange(D * D, device=o.device)
    keep = ((lane % D < D - 1) & (lane // D < D - 1)).to(o.dtype)
    return (o * keep).to(_BF16)


def _select(s4, dy, dxw, D: int):
    """sw[e, p, u, v] = s4[e, p, dy + u, dxw + v] (gathers)."""
    off = torch.arange(D, device=s4.device)
    rows = torch.take_along_dim(s4, (dy.long()[..., None] + off)[..., None], dim=2)
    cols = (dxw.long()[..., None] + off)[:, :, None, :].expand(-1, -1, D, -1)
    return torch.take_along_dim(rows, cols, dim=3)


def level_sw(fmap, f1, cs, jj, vs, radius: int):
    """``_corr_level_sw`` (corr_pallas.py:305-384): one level through the
    14 x 32 superwindow, per-pixel windows clamped into it."""
    E, P2, _ = f1.shape
    _, H, W, _ = fmap.shape
    D = 2 * radius + 2
    corner, (dy, dxw, dyf, dxf, vf) = sw_inputs(cs, vs, H, W, radius)
    s = superwindow_sw(f1, fmap, jj, vs, *corner)
    sw = _select(s.float().reshape(E, P2, RS, CS), dy, dxw, D)
    w00, w01, w10, w11 = (w[..., None] for w in _bilinear_weights(dyf, dxf, vf))
    o = (w00 * sw[..., :D - 1, :D - 1] + w01 * sw[..., :D - 1, 1:]
         + w10 * sw[..., 1:, :D - 1] + w11 * sw[..., 1:, 1:])
    o = torch.nn.functional.pad(o, (0, 1, 0, 1))
    return o.reshape(E, P2, D * D).to(_BF16)


def level_v3(fmap, f1, cs, jj, vs, radius: int):
    """``_corr_level_v3`` (corr_pallas.py:582-659): one level through the
    16 x 24 superwindow (kernel C), per-pixel windows clamped within
    +-3 px of the centre's, then the tap-stencil epilogue (kernel D)."""
    E, P2, _ = f1.shape
    _, H, W, _ = fmap.shape
    D = 2 * radius + 2
    corner, epi = v3_inputs(cs, vs, H, W, radius)
    wide = epilogue_v3(superwindow_v3(f1, fmap, jj, vs, *corner), *epi)
    out = wide.reshape(E, P2, D - 1, CS3)[..., :D - 1]
    out = torch.nn.functional.pad(out, (0, 1, 0, 1))
    return out.reshape(E, P2, D * D)


# ---------------- entry points ----------------


def device_sort_order(jj1, valid):
    """The valid-first stable jj sort (corr_pallas.py:1035-1037) and its
    inverse, int32. It is the order of the host's ``corr_sort_order``,
    which the JAX step ships for pallas_dma and pallas_fused."""
    key = torch.where(valid, jj1.long(), torch.full_like(jj1, 2 ** 30, dtype=torch.long))
    order = torch.argsort(key, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return order.to(torch.int32), inv.to(torch.int32)


def sort_edges(gmap, coords, ii1, jj1, valid):
    """The edges in the kernels' order (corr_pallas.py:1029-1044): patch
    rows f1 [E, P2, C] bf16, coords [E, P2, 2], slots jj [E] int32 and
    validity [E], sorted valid-first by slot, and the inverse
    permutation."""
    E = coords.shape[0]
    Np, C, P, _ = gmap.shape
    order, inv = device_sort_order(jj1, valid)
    f1 = gmap.permute(0, 2, 3, 1).reshape(Np, P * P, C).to(_BF16)[ii1[order]].contiguous()
    cs = coords.reshape(E, P * P, 2)[order]
    return f1, cs, jj1[order].to(torch.int32).contiguous(), valid[order].contiguous(), inv


def corr_features_common(level_fn, gmap, fmap1, fmap2, coords, ii1, jj1, valid,
                         radius: int = 3):
    """``_corr_features_common`` (corr_pallas.py:1003-1051): gmap [Np, C,
    P, P]; fmap1 [mem, H, W, C], fmap2 [mem, H/4, W/4, C]; coords [E, P,
    P, 2] f32 at level-1 scale; ii1/jj1 [E] gmap row / fmap slot; valid [E]
    bool. Returns [E, P*P, 2*D*D] bf16."""
    f1, cs, jj, vs, inv = sort_edges(gmap, coords, ii1, jj1, valid)
    outs = [level_fn(fmap.to(_BF16).contiguous(), f1, cs / scale, jj, vs, radius)
            for fmap, scale in ((fmap1, 1.0), (fmap2, 4.0))]
    return torch.cat(outs, -1)[inv]


def corr_features_pallas(gmap, fmap1, fmap2, coords, ii1, jj1, valid, radius: int = 3):
    """``CORR_IMPL=pallas``: exact per-pixel windows (kernel A)."""
    return corr_features_common(level_window, gmap, fmap1, fmap2, coords, ii1, jj1, valid,
                                radius)


def corr_features_pallas_sw(gmap, fmap1, fmap2, coords, ii1, jj1, valid, radius: int = 3):
    """``CORR_IMPL=pallas_sw``: the 14 x 32 superwindow (kernel B); pixels
    more than +-3 px from the patch centre sample clamped windows."""
    return corr_features_common(level_sw, gmap, fmap1, fmap2, coords, ii1, jj1, valid, radius)


def corr_features_pallas_dma(gmap, fmap1, fmap2, coords, ii1, jj1, valid, radius: int = 3):
    """``CORR_IMPL=pallas_dma``: the v3 16 x 24 superwindow (kernel C) and
    its tap-stencil epilogue (kernel D); windows clamped within +-3 px of
    the patch centre's."""
    return corr_features_common(level_v3, gmap, fmap1, fmap2, coords, ii1, jj1, valid, radius)
