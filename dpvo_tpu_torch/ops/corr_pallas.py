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
  ``pallas_sw``   kernel B, the dots of the RS x CS = 14 x 32 superwindow
                  anchored at the centre pixel, shared by its 9 pixels,
                  with the window selection and the 2x2 bilinear fused:
                  one launch writes the level's output;
  ``pallas_dma``  kernel C+D, the dots of the RS3 x CS3 = 16 x 24
                  superwindow that its pixels' windows reach, with v3's
                  tap-stencil epilogue fused (its row stage rounded to bf16
                  after every tap as the TPU's bf16 scratch is): one launch
                  writes the level's output, the raw superwindow never
                  reaches memory;

- A's 2x2 bilinear reduction follows in torch (XLA in JAX).

Each kernel computes an (edge, level)'s dots once over the union of its
9 pixels' windows (``window_union`` gives the rule for the union that
its grid holds: A's and B's may not fit, C+D's always does).

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
UNION_POS = 352  # union positions a kernel's dot grid holds (csrc/corr_pallas.cu: kGridPos)
_BF16 = torch.bfloat16


# ---------------- plain versions of the kernels ----------------


def _map_rows(fmap, jj, valid, iy, ix):
    """Frame-feature vectors at (iy, ix) [E, ...] of slot jj [E] as f32,
    zero outside the image and for invalid edges or slots out of range
    (as the kernels write them)."""
    mem, H, W, C = fmap.shape
    ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    live = valid & (jj >= 0) & (jj < mem)
    ok = ok & live.reshape((-1,) + (1,) * (iy.dim() - 1))
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
    """The dots of kernels B and C: out[e, p, r*Cw + c] = bf16(f1[e, p] .
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


def corr_v3_fused_plain(f1, fmap, jj, valid, syc, sxc, dy, dxw, dyf, dxf, vf):
    """Kernel C+D's function, ``level_v3``'s output: the 16 x 24
    superwindow's dots at (syc, sxc) [E], the v3 epilogue on them, its
    kept 7 x 7 per pixel with a zero last row and column -> [E, P2, 64]
    bf16 (dy, dxw, dyf, dxf, vf [E, P2] as ``v3_inputs`` makes them)."""
    E, P2, _ = f1.shape
    s = superwindow_plain(f1, fmap, jj, valid, syc, sxc, RS3, CS3)
    wide = epilogue_v3_plain(s, dy, dxw, dyf, dxf, vf)
    out = torch.nn.functional.pad(wide.reshape(E, P2, 7, CS3)[..., :7], (0, 1, 0, 1))
    return out.reshape(E, P2, 64)


def _select(s4, dy, dxw, D: int):
    """sw[e, p, u, v] = s4[e, p, dy + u, dxw + v] (gathers)."""
    off = torch.arange(D, device=s4.device)
    rows = torch.take_along_dim(s4, (dy.long()[..., None] + off)[..., None], dim=2)
    cols = (dxw.long()[..., None] + off)[:, :, None, :].expand(-1, -1, D, -1)
    return torch.take_along_dim(rows, cols, dim=3)


def bilinear_sw(sw, dyf, dxf, vf):
    """``_corr_level_sw``'s 2x2 bilinear reduction (corr_pallas.py:376-384)
    of each pixel's window sw [E, P2, D, D] f32 -> [E, P2, D*D] bf16, the
    last row and column zero."""
    E, P2, D, _ = sw.shape
    w00, w01, w10, w11 = (w[..., None] for w in _bilinear_weights(dyf, dxf, vf))
    o = (w00 * sw[..., :D - 1, :D - 1] + w01 * sw[..., :D - 1, 1:]
         + w10 * sw[..., 1:, :D - 1] + w11 * sw[..., 1:, 1:])
    o = torch.nn.functional.pad(o, (0, 1, 0, 1))
    return o.reshape(E, P2, D * D).to(_BF16)


def epilogue_sw_plain(s, dy, dxw, dyf, dxf, vf):
    """``_corr_level_sw``'s epilogue (corr_pallas.py:366-384): s [E, P2,
    RS*CS] bf16, each pixel's 8 x 8 window of it at (dy, dxw) [E, P2] and
    its 2x2 bilinear -> [E, P2, 64] bf16."""
    E, P2, _ = s.shape
    return bilinear_sw(_select(s.float().reshape(E, P2, RS, CS), dy, dxw, 8), dyf, dxf, vf)


def corr_sw_fused_plain(f1, fmap, jj, valid, syc, sxc, dy, dxw, dyf, dxf, vf):
    """Kernel B's function, ``level_sw``'s output: the 14 x 32
    superwindow's dots at (syc, sxc) [E], then ``epilogue_sw_plain`` ->
    [E, P2, 64] bf16 (dy, dxw, dyf, dxf, vf [E, P2] as ``sw_inputs`` makes
    them)."""
    s = superwindow_plain(f1, fmap, jj, valid, syc, sxc, RS, CS)
    return epilogue_sw_plain(s, dy, dxw, dyf, dxf, vf)


def window_union(sy, sx, D: int = 8):
    """A kernel's geometry per edge, from its pixels' window corners sy, sx
    [E, P2] (B and C+D: syc + dy, sxc + dxw): the union of the D x D
    windows, corner (y0, x0) and size (uh, uw) int64 [E], and whether the
    kernel computes it from its dot grid (``UNION_POS`` positions) rather
    than by its per-pixel branch."""
    y0, x0 = sy.long().amin(1), sx.long().amin(1)
    uh, uw = sy.long().amax(1) - y0 + D, sx.long().amax(1) - x0 + D
    return y0, x0, uh, uw, uh * uw <= UNION_POS


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
    kernels.count("corr_window")
    return out


def _superwindow_fused(name, args):
    """Launch kernel B or C+D (entry point ``dpvo_<name>``) on the card."""
    f1, fmap, jj, valid, syc, sxc, dy, dxw, dyf, dxf, vf = args
    _check(name, f1, fmap, jj, valid, (syc, sxc, dy, dxw))
    E, P2, C = f1.shape
    mem, H, W, _ = fmap.shape
    if syc.shape != (E,) or sxc.shape != (E,) or any(
            t.shape != (E, P2) for t in (dy, dxw, dyf, dxf, vf)):
        raise ValueError(f"{name}: syc/sxc must be [E] and dy/dxw/dyf/dxf/vf [E, 9]")
    if any(t.dtype != torch.float32 for t in (dyf, dxf, vf)):
        raise ValueError(f"{name}: dyf/dxf/vf must be f32")
    kernels.require_cuda(name, f1, dyf, dxf, vf)
    out = torch.empty((E, P2, 64), dtype=_BF16, device=f1.device)
    rc = getattr(kernels.load(), "dpvo_" + name)(
        *(t.data_ptr() for t in args), out.data_ptr(), E, mem, H, W, C, kernels.stream_ptr(f1))
    kernels.check(name, rc)
    kernels.count(name)
    return out


def corr_sw_fused(f1, fmap, jj, valid, syc, sxc, dy, dxw, dyf, dxf, vf):
    """Kernel B (``CORR_IMPL=pallas_sw``): one level's output [E, 9, 64]
    bf16; see ``corr_sw_fused_plain``. On the card syc, sxc [E] and dy,
    dxw [E, 9] are int32 (dy in [0, 6], dxw in [0, 24], as ``sw_inputs``
    clamps them), dyf, dxf, vf [E, 9] f32."""
    args = (f1, fmap, jj, valid, syc, sxc, dy, dxw, dyf, dxf, vf)
    if f1.device.type == "cpu":
        return corr_sw_fused_plain(*args)
    return _superwindow_fused("corr_sw_fused", args)


def corr_v3_fused(f1, fmap, jj, valid, syc, sxc, dy, dxw, dyf, dxf, vf):
    """Kernel C+D (``CORR_IMPL=pallas_dma``): one level's output [E, 9,
    64] bf16; see ``corr_v3_fused_plain``. On the card syc, sxc [E] and
    dy, dxw [E, 9] are int32 (dy in [0, 7], dxw in [0, 15], as
    ``v3_inputs`` clamps them), dyf, dxf, vf [E, 9] f32."""
    args = (f1, fmap, jj, valid, syc, sxc, dy, dxw, dyf, dxf, vf)
    if f1.device.type == "cpu":
        return corr_v3_fused_plain(*args)
    return _superwindow_fused("corr_v3_fused", args)


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
    """Kernel C+D's arguments for one level (``_corr_level_v3``,
    corr_pallas.py:608-613), as ``sw_inputs``: pixel windows clamped
    within +-3 px of the centre's."""
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


def level_sw(fmap, f1, cs, jj, vs, radius: int):
    """``_corr_level_sw`` (corr_pallas.py:305-384): one level through the
    14 x 32 superwindow, per-pixel windows clamped into it, and the 2x2
    bilinear, in one kernel (B)."""
    _, H, W, _ = fmap.shape
    if radius != 3:
        raise ValueError("pallas_sw's kernel is built for CORR_RADIUS=3 (8 x 8 windows)")
    corner, epi = sw_inputs(cs, vs, H, W, radius)
    return corr_sw_fused(f1, fmap, jj, vs, *corner, *epi)


def level_v3(fmap, f1, cs, jj, vs, radius: int):
    """``_corr_level_v3`` (corr_pallas.py:582-659): one level through the
    16 x 24 superwindow, per-pixel windows clamped within +-3 px of the
    centre's, and the tap-stencil epilogue, in one kernel (C+D)."""
    _, H, W, _ = fmap.shape
    if radius != 3:
        raise ValueError("pallas_dma's 16 x 24 superwindow is built for CORR_RADIUS=3")
    corner, epi = v3_inputs(cs, vs, H, W, radius)
    return corr_v3_fused(f1, fmap, jj, vs, *corner, *epi)


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
    """``CORR_IMPL=pallas_dma``: the v3 16 x 24 superwindow and its
    tap-stencil epilogue (kernel C+D); windows clamped within +-3 px of the
    patch centre's."""
    return corr_features_common(level_v3, gmap, fmap1, fmap2, coords, ii1, jj1, valid, radius)
