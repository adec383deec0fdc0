"""The correlation backward's summation order, its orders' checks and the
training unroll's jj order, on the CPU.

csrc/corr_bwd.cu's map kernel sums each map position's contributions in
ascending (edge, pixel) order with corr_backward_plain's roundings, so that
the card's map gradients are torch.equal to the plain version's on the
CPU. The first test pins that order: the plain version against a plain
Python loop in that order, bit for bit. The card holds the kernel to the
plain version (tests/test_torch_cuda.py, chip_smoke.py phase 2).
"""

import numpy as np
import pytest
import torch

from dpvo_tpu_torch.config import Config
from dpvo_tpu_torch.models import vonet
from dpvo_tpu_torch.ops.corr import corr_backward_plain
from dpvo_tpu_torch.ops.corr_cuda import corr_backward
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)

F, H, W, C, NP = 3, 14, 18, 8, 6


def order_case(dtype, seed=0):
    """Edges to interleaved slots (2, 0, 1, 0, 2, ...), one patch spread 4
    px, a pixel 8 px past the border, one non-finite pixel, one invalid
    edge; windows overlapping across edges on both levels."""
    rng = np.random.default_rng(seed)
    E = 14
    gmap = rng.normal(size=(NP, C, 3, 3)).astype(np.float32)
    f1 = rng.normal(size=(F, H, W, C)).astype(np.float32)
    f2 = rng.normal(size=(F, H // 4, W // 4, C)).astype(np.float32)
    ctr = rng.uniform([2.0, 2.0], [W - 2.0, H - 2.0], size=(E, 1, 1, 2))
    off = np.stack(np.meshgrid(np.arange(-1.0, 2.0), np.arange(-1.0, 2.0), indexing="ij"),
                   -1)[..., ::-1]
    spread = np.ones((E, 1, 1, 1))
    spread[3] = 4.0
    coords = (ctr + spread * off[None] + 0.3 * rng.normal(size=(E, 3, 3, 2))).astype(np.float32)
    coords[5, 2, 2] = [W + 8.0, 3.5]
    coords[7, 0, 1, 1] = np.nan
    ii = rng.integers(0, NP, E).astype(np.int32)
    jj = np.array([2, 0, 1, 0, 2, 2, 1, 0, 0, 1, 2, 0, 1, 2], np.int32)
    valid = np.ones(E, bool)
    valid[9] = False
    g = rng.normal(size=(E, 9, 128)).astype(np.float32)
    t = torch.as_tensor
    return (t(g).to(torch.bfloat16), t(gmap).to(dtype), t(f1).to(dtype), t(f2).to(dtype),
            t(coords), t(ii), t(jj), t(valid))


def loop_maps(g, gmap, fmap1, fmap2, coords, ii1, jj1, valid):
    """The map gradients by a plain loop: for each level, edge and pixel in
    ascending order, G at each window position (0 + the four taps in
    order, each (wy * wx) * g, in f32) and acc = acc + G * f1 (product
    rounded first) at each window position on the map, from +0.0."""
    f32 = np.float32
    g = g.float().numpy().reshape(-1, 9, 2, 8, 8)
    f1 = gmap.float().numpy().reshape(gmap.shape[0], C, 9)
    cs, ii1, jj1, valid = coords.numpy().reshape(-1, 9, 2), ii1.numpy(), jj1.numpy(), valid.numpy()
    out = []
    for lvl, fmap in enumerate((fmap1, fmap2)):
        mem, h, w, _ = fmap.shape
        acc = np.zeros((mem, h, w, C), np.float32)
        for e in range(cs.shape[0]):
            if not valid[e]:
                continue
            for p in range(9):
                x, y = cs[e, p] / f32(4.0 if lvl else 1.0)
                if not (np.isfinite(x) and np.isfinite(y)):
                    continue
                xf, yf = np.floor(np.clip(x, f32(-64), f32(w + 64))), \
                    np.floor(np.clip(y, f32(-64), f32(h + 64)))
                fx, fy = f32(x - xf), f32(y - yf)
                wy, wx = (f32(f32(1) - fy), fy), (f32(f32(1) - fx), fx)
                for i in range(8):
                    for j in range(8):
                        yy, xx = int(yf) - 3 + i, int(xf) - 3 + j
                        if not (0 <= yy < h and 0 <= xx < w):
                            continue
                        G = f32(0)
                        for a in (0, 1):
                            for b in (0, 1):
                                u, v = i - a, j - b
                                if 0 <= u < 7 and 0 <= v < 7:
                                    G = f32(G + f32(f32(wy[a] * wx[b]) * f32(g[e, p, lvl, u, v])))
                        acc[jj1[e], yy, xx] = acc[jj1[e], yy, xx] + G * f1[ii1[e], :, p]
        out.append(torch.as_tensor(acc).to(fmap.dtype))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_maps_follow_the_edge_pixel_order(dtype):
    """corr_backward_plain's d fmap1 and d fmap2 equal, bit for bit, the
    loop in ascending (edge, pixel) order: the order and roundings the
    card's map kernel follows."""
    args = order_case(dtype)
    _, dfm1, dfm2 = corr_backward_plain(*args)
    want1, want2 = loop_maps(*args)
    assert dfm1.dtype == dtype and dfm1.any() and dfm2.any()
    assert torch.equal(dfm1, want1)
    assert torch.equal(dfm2, want2)
    # the order matters: another order's sums differ in some last bits
    if dtype == torch.float32:
        rev = [a.flip(0) if k in (0, 4, 5, 6, 7) else a for k, a in enumerate(args)]
        assert not torch.equal(corr_backward_plain(*rev)[1], dfm1)


@pytest.mark.parametrize("bad", ["dtype", "shape"])
@pytest.mark.parametrize("which", ["ii1_order", "jj1_order"])
def test_corr_backward_rejects_bad_orders(which, bad):
    """An order of the wrong dtype or shape raises before anything runs,
    on any device."""
    args = order_case(torch.float32)
    E = args[4].shape[0]
    order = torch.argsort(args[6], stable=True)
    order = order if bad == "dtype" else order[:-1].to(torch.int32)
    with pytest.raises(ValueError, match=which):
        corr_backward(*args, **{which: order})
    with pytest.raises(ValueError, match=which):
        corr_backward(*(a.to("meta") for a in args), **{which: order.to("meta")})
    ok = torch.argsort(args[6], stable=True).to(torch.int32)
    assert ok.shape == (E,)
    got = corr_backward(*args, **{which: ok})
    assert all(torch.equal(a, b) for a, b in zip(got, corr_backward_plain(*args)))


def test_unroll_passes_the_jj_order():
    """step_tensors ships numpy's stable argsort of each step's jj, and the
    training unroll hands it to the correlation with the kk order."""
    for st in vonet.build_schedule(4, 4, 4, init_frames=3):
        t = vonet.step_tensors(st, "cpu")
        assert t["jj_order"].dtype == torch.int32
        assert np.array_equal(t["jj_order"].numpy(), np.argsort(st.jj, kind="stable"))

    from dpvo_tpu_torch.runtime.weights import init_networks

    cfg = Config(PATCHES_PER_FRAME=4, DIM=32, FDIM=16, MIXED_PRECISION=False)
    nets = init_networks(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    Fr, ht, wd = 4, 64, 64
    images = torch.as_tensor(rng.uniform(0, 255, (Fr, ht, wd, 3)).astype(np.float32))
    poses = torch.as_tensor(np.tile([0, 0, 0, 0, 0, 0, 1.0], (Fr, 1)).astype(np.float32))
    disps = torch.ones((Fr, ht, wd))
    intr = torch.tensor([50.0, 50.0, 32.0, 32.0])
    draws = vonet.draw_inputs(Fr, 4, ht // 4, wd // 4, 2, torch.Generator().manual_seed(0))
    seen = []
    real = vonet.corr_features_train

    def record(gmap, f1, f2, coords, ii1, jj1, valid, ii1_order=None, jj1_order=None, **kw):
        seen.append((ii1, jj1, ii1_order, jj1_order))
        return real(gmap, f1, f2, coords, ii1, jj1, valid, ii1_order, jj1_order, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(vonet, "corr_features_train", record)
    try:
        with torch.no_grad():
            vonet.vo_forward(nets, cfg, images, poses, disps, intr, draws, STEPS=2)
    finally:
        mp.undo()
    assert len(seen) == 2
    for ii1, jj1, ii1_order, jj1_order in seen:
        assert torch.equal(ii1_order, torch.argsort(ii1, stable=True).to(torch.int32))
        assert torch.equal(jj1_order, torch.argsort(jj1, stable=True).to(torch.int32))
