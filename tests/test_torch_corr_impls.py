"""Port parity for every CORR_IMPL: the port's pallas, pallas_sw, pallas_dma
and pallas_fused correlation against their JAX namesakes (the Pallas
kernels in interpret mode), kernel D's plain version against the JAX
epilogue kernel, and the tiny slice tracked with CORR_IMPL=pallas_dma by
both packages, on the CPU.

Rounding. The port rounds where the JAX functions round: the raw dots
once to bf16, v3's row stage to bf16 after every tap. Integer features
make every f32 dot exact in any summation order, so those inputs compare
the rest of the arithmetic: there pallas_dma matches bit for bit. pallas
and pallas_sw differ in rare values by one bf16 ulp of the value: XLA:CPU
contracts their f32 bilinear multiply-adds into FMAs (rounding once where
torch rounds twice), which moves a value that cancels to near zero by an
f32 rounding, enough to land it on the next bf16 value. Gaussian features
add the dots' summation order, which flips the bf16 rounding of a rare
raw dot by one ulp; every variant is held to one bf16 ulp of each value.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_tpu.ops import corr_pallas as jcp
from dpvo_tpu.runtime import DPVO as JDPVO
from dpvo_tpu.runtime import steps as jsteps
from dpvo_tpu.utils.synthetic import PlaneScene
from dpvo_tpu_torch.config import Config as TConfig
from dpvo_tpu_torch.ops import corr_pallas as tcp
from dpvo_tpu_torch.ops.corr_cuda import corr_features
from dpvo_tpu_torch.runtime.dpvo import DPVO as TDPVO
from dpvo_tpu_torch.runtime.steps import StepFunctions
from test_torch_corr import BF16_ULP, assert_bf16_close
from test_torch_models import jax_params_from_npz
from test_tracking_e2e import FIXTURE, HT, WD, tiny_cfg
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)


IMPLS = {
    "pallas": (jcp.corr_features_pallas, tcp.corr_features_pallas),
    "pallas_sw": (jcp.corr_features_pallas_sw, tcp.corr_features_pallas_sw),
    "pallas_dma": (jcp.corr_features_pallas_dma, tcp.corr_features_pallas_dma),
}


def make_inputs(seed, E=64, Np=24, mem=4, C=128, H1=24, W1=32, geometry="patch",
                integer=False):
    """The sizes of tests/test_corr.py. geometry: "patch" (pixels 1 px apart
    plus +-0.8 px jitter: inside every clamp envelope), "spread" (5 px
    apart: the sw and v3 clamps bite) or "far" (coordinates at +-1e9..1e10
    and NaN-free extremes on some pixels, centre pixels included)."""
    rng = np.random.default_rng(seed)
    if integer:
        feat = lambda s: rng.integers(-3, 4, s).astype(np.float32)
    else:
        feat = lambda s: rng.standard_normal(s).astype(np.float32)
    gmap, fmap1, fmap2 = feat((Np, C, 3, 3)), feat((mem, H1, W1, C)), feat(
        (mem, H1 // 4, W1 // 4, C))
    spread = 5.0 if geometry == "spread" else 1.0
    base = rng.uniform(-6, W1 + 6, (E, 1, 1, 2))
    grid = np.stack(np.meshgrid(np.arange(-1, 2), np.arange(-1, 2), indexing="ij"), -1)
    coords = (base + spread * grid[None][..., ::-1]
              + rng.uniform(-0.8, 0.8, (E, 3, 3, 2))).astype(np.float32)
    if geometry == "far":
        coords[:4, 0, 0, 0] = [1e10, -1e10, 3e9, -40.0]
        coords[4:8, 1, 1] = [[1e10, 5.0], [-1e10, 5.0], [5.0, 1e9], [5.0, -1e9]]
    ii1 = rng.integers(0, Np, E).astype(np.int32)
    jj1 = rng.integers(0, mem, E).astype(np.int32)
    valid = rng.uniform(size=E) > 0.2
    return gmap, fmap1, fmap2, coords, ii1, jj1, valid


def _jax(args):
    g, f1, f2, c, ii, jj, v = args
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    return bf(g), bf(f1), bf(f2), jnp.asarray(c), jnp.asarray(ii), jnp.asarray(jj), \
        jnp.asarray(v)


def _torch(args):
    return tuple(torch.as_tensor(a) for a in args)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
@pytest.mark.parametrize("geometry", ["patch", "spread", "far"])
@pytest.mark.parametrize("impl", list(IMPLS))
def test_impl_matches_jax(impl, geometry, integer):
    jfn, tfn = IMPLS[impl]
    args = make_inputs(11, geometry=geometry, integer=integer)
    want = np.asarray(jfn(*_jax(args), interpret=True), np.float32)
    got = tfn(*_torch(args))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (64, 9, 128)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    if impl == "pallas_dma" and integer:
        np.testing.assert_array_equal(got, want)
    else:  # see the module docstring: FMA contraction, summation order
        assert_bf16_close(got, want)
        assert (got != want).mean() < 1e-3


@pytest.mark.parametrize("impl", list(IMPLS))
def test_result_does_not_depend_on_edge_order(impl):
    """Each edge's features are its own: the edges given in another order
    give the same values in that order (the sort undoes the permutation)."""
    args = _torch(make_inputs(12))
    perm = torch.as_tensor(np.random.default_rng(13).permutation(64))
    moved = args[:3] + tuple(a[perm] for a in args[3:])
    torch.testing.assert_close(IMPLS[impl][1](*moved), IMPLS[impl][1](*args)[perm], rtol=0,
                               atol=0)


def test_epilogue_matches_epi_pallas_interpret():
    """Kernel D's plain version against _epi_pallas: the row stage rounds
    each tap's product and running sum to bf16 as the TPU's bf16 scratch
    does (without it ~40% of these values move by up to 0.125). XLA:CPU
    contracts the f32 column taps into FMAs, so a rare value lands one
    bf16 ulp apart (2 of 387072 here)."""
    rng = np.random.default_rng(14)
    E = 256
    s = (8 * rng.standard_normal((E, 9, 384))).astype(np.float32)
    dy = rng.integers(0, 8, (E, 9)).astype(np.int32)
    dxw = rng.integers(0, 16, (E, 9)).astype(np.int32)
    dyf, dxf = (rng.uniform(size=(E, 9)).astype(np.float32) for _ in range(2))
    vf = (rng.uniform(size=(E, 9)) > 0.1).astype(np.float32)
    want = np.asarray(jcp._epi_pallas(jnp.asarray(s, jnp.bfloat16), *(
        jnp.asarray(a) for a in (dy, dxw, dyf, dxf, vf)), interpret=True), np.float32)
    got = tcp.epilogue_v3_plain(torch.as_tensor(s).to(torch.bfloat16), *(
        torch.as_tensor(a) for a in (dy, dxw, dyf, dxf, vf)))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (E, 9, 168)
    got = got.float().numpy()
    assert_bf16_close(got, want)
    assert (got != want).sum() <= 10


@pytest.mark.parametrize("dy,dxw", [(None, None), (0, 0), (0, 15), (7, 0), (7, 15)],
                         ids=["random", "0-0", "0-15", "7-0", "7-15"])
def test_v3_window_is_the_live_region(dy, dxw):
    """The fact kernel C+D rests on: v3's epilogue reads only each pixel's
    8 x 8 window of the superwindow at (dy, dxw) for its kept 7 x 7
    outputs. s zeroed outside that window gives the same kept outputs as
    the full s, at random offsets and at the ends of their ranges, with
    bilinear fractions 0 and 1 among them and masked pixels."""
    rng = np.random.default_rng(17 if dy is None else 10 * dy + dxw)
    E = 96
    s = torch.as_tensor(8 * rng.standard_normal((E, 9, 16, 24)), dtype=torch.float32).to(
        torch.bfloat16)
    full = lambda v, hi: torch.as_tensor(rng.integers(0, hi + 1, (E, 9)) if v is None
                                         else np.full((E, 9), v), dtype=torch.int32)
    dy_t, dxw_t = full(dy, 7), full(dxw, 15)
    frac = lambda: torch.as_tensor(np.where(rng.uniform(size=(E, 9)) < 0.3,
                                            rng.integers(0, 2, (E, 9)),
                                            rng.uniform(size=(E, 9))), dtype=torch.float32)
    dyf, dxf = frac(), frac()
    vf = torch.as_tensor(rng.uniform(size=(E, 9)) > 0.2, dtype=torch.float32)
    r, c = torch.arange(16)[:, None], torch.arange(24)[None, :]
    live = ((r >= dy_t[..., None, None]) & (r < dy_t[..., None, None] + 8)
            & (c >= dxw_t[..., None, None]) & (c < dxw_t[..., None, None] + 8))
    kept = lambda x: tcp.epilogue_v3_plain(x.reshape(E, 9, 384), dy_t, dxw_t, dyf, dxf,
                                           vf).reshape(E, 9, 7, 24)[..., :7]
    want = kept(s)
    assert torch.equal(kept(s * live), want)
    assert (want[vf == 0] == 0).all() and (want != 0).any()


@pytest.mark.parametrize("dy,dxw", [(None, None), (0, 0), (0, 24), (6, 0), (6, 24)],
                         ids=["random", "0-0", "0-24", "6-0", "6-24"])
def test_sw_window_is_the_live_region(dy, dxw):
    """The fact kernel B rests on: corr_sw_fused_plain, the function it
    computes, equals the composition level_sw had before the kernel took
    its epilogue (the 14 x 32 superwindow's dots, _select's gathers, the
    2x2 bilinear), equals it with the superwindow zeroed outside each
    pixel's 8 x 8 window at (dy, dxw), and equals the bilinear of the dots
    of that window alone, which is what the kernel computes: at random
    offsets and at the ends of their ranges, with bilinear fractions 0 and
    1 among them, masked pixels and invalid edges. Integer features make
    every dot exact, so torch.equal."""
    rng = np.random.default_rng(27 if dy is None else 10 * dy + dxw)
    E, C, H, W = 96, 32, 24, 32
    feat = lambda *sh: torch.as_tensor(rng.integers(-3, 4, sh), dtype=torch.bfloat16)
    f1, fmap = feat(E, 9, C), feat(4, H, W, C)
    jj = torch.as_tensor(rng.integers(0, 4, E), dtype=torch.int32)
    valid = torch.as_tensor(rng.uniform(size=E) > 0.2)
    syc = torch.as_tensor(rng.integers(-16, H + 1, E), dtype=torch.int32)
    sxc = torch.as_tensor(rng.integers(-2, W // 8 + 1, E) * 8, dtype=torch.int32)
    full = lambda v, hi: torch.as_tensor(rng.integers(0, hi + 1, (E, 9)) if v is None
                                         else np.full((E, 9), v), dtype=torch.int32)
    dy_t, dxw_t = full(dy, tcp.RS - 8), full(dxw, tcp.CS - 8)
    frac = lambda: torch.as_tensor(np.where(rng.uniform(size=(E, 9)) < 0.3,
                                            rng.integers(0, 2, (E, 9)),
                                            rng.uniform(size=(E, 9))), dtype=torch.float32)
    dyf, dxf = frac(), frac()
    vf = torch.as_tensor(rng.uniform(size=(E, 9)) > 0.2, dtype=torch.float32)

    def composed(s):  # level_sw before the fusion
        sw = tcp._select(s.float().reshape(E, 9, tcp.RS, tcp.CS), dy_t, dxw_t, 8)
        w00, w01, w10, w11 = (w[..., None, None] for w in (((1 - dyf) * (1 - dxf)) * vf,
                                                     ((1 - dyf) * dxf) * vf,
                                                     (dyf * (1 - dxf)) * vf, (dyf * dxf) * vf))
        o = (w00 * sw[..., :7, :7] + w01 * sw[..., :7, 1:] + w10 * sw[..., 1:, :7]
             + w11 * sw[..., 1:, 1:])
        return torch.nn.functional.pad(o, (0, 1, 0, 1)).reshape(E, 9, 64).to(torch.bfloat16)

    s = tcp.superwindow_plain(f1, fmap, jj, valid, syc, sxc, tcp.RS, tcp.CS)
    want = composed(s)
    got = tcp.corr_sw_fused(f1, fmap, jj, valid, syc, sxc, dy_t, dxw_t, dyf, dxf, vf)
    assert torch.equal(got, want)
    r, c = torch.arange(tcp.RS)[:, None], torch.arange(tcp.CS)[None, :]
    live = ((r >= dy_t[..., None, None]) & (r < dy_t[..., None, None] + 8)
            & (c >= dxw_t[..., None, None]) & (c < dxw_t[..., None, None] + 8))
    assert torch.equal(composed(s * live.reshape(E, 9, -1)), want)
    win = tcp.corr_window_plain(f1, fmap, jj, valid, syc[:, None] + dy_t, sxc[:, None] + dxw_t)
    assert torch.equal(tcp.bilinear_sw(win.float().reshape(E, 9, 8, 8), dyf, dxf, vf), want)
    assert (want[vf == 0] == 0).all() and (want[~valid] == 0).all() and (want != 0).any()


@pytest.mark.parametrize("geometry", ["patch", "spread", "far"])
def test_window_union_rule(geometry):
    """Kernel A's union rule (ops/corr_pallas.py:window_union): every
    pixel's window lies in its edge's union; the union is computed from the
    dot grid when it holds at most UNION_POS positions, the kernel's own
    constant; pixels 1 px apart always fit, 5 px apart take both branches,
    and so do coordinates at +-1e10 (window_inputs clips the corners to the
    map's border). Kernel B's union, from its windows clamped into the
    14 x 32 superwindow, lies in that superwindow, and for pixels 1 px
    apart fits the grid."""
    cu = (Path(tcp.__file__).parents[1] / "csrc" / "corr_pallas.cu").read_text()
    assert int(re.search(r"kGridPos = (\d+);", cu).group(1)) == tcp.UNION_POS
    gmap, fmap1, fmap2, coords, ii1, jj1, valid = _torch(make_inputs(18, E=256,
                                                                     geometry=geometry))
    for fmap, scale in ((fmap1, 1.0), (fmap2, 4.0)):
        _, H, W, _ = fmap.shape
        (sy, sx), _ = tcp.window_inputs(coords.reshape(-1, 9, 2) / scale, valid, H, W, 3)
        y0, x0, uh, uw, fits = tcp.window_union(sy, sx)
        sy, sx = sy.long(), sx.long()
        assert ((sy >= y0[:, None]) & (sy + 8 <= (y0 + uh)[:, None])).all()
        assert ((sx >= x0[:, None]) & (sx + 8 <= (x0 + uw)[:, None])).all()
        assert torch.equal(fits, uh * uw <= tcp.UNION_POS)
        if geometry == "patch":
            assert fits.all()
        elif geometry == "spread" and scale == 1.0:
            assert fits.any() and not fits.all()
        elif geometry == "far" and scale == 1.0:
            assert not fits[:8].all()
        (syc, sxc), (dy, dxw, *_) = tcp.sw_inputs(coords.reshape(-1, 9, 2) / scale, valid, H, W,
                                                  3)
        y0, x0, uh, uw, fits = tcp.window_union(syc[:, None] + dy, sxc[:, None] + dxw)
        assert ((y0 >= syc) & (y0 + uh <= syc + tcp.RS)).all()
        assert ((x0 >= sxc) & (x0 + uw <= sxc + tcp.CS)).all()
        assert torch.equal(fits, uh * uw <= tcp.UNION_POS)
        if geometry == "patch":
            assert fits.all()


@pytest.mark.parametrize("impl", list(IMPLS) + ["pallas_fused"])
def test_invalid_edges_are_zero(impl):
    args = _torch(make_inputs(15, E=40))
    if impl == "pallas_fused":
        bf = tuple(a.to(torch.bfloat16) for a in args[:3])
        got = corr_features(*bf, *args[3:], clamp=True)
    else:
        got = IMPLS[impl][1](*args)
    assert (got[~args[6]] == 0).all() and (got[args[6]] != 0).any()
    assert (got.reshape(40, 9, 2, 8, 8)[..., 7, :] == 0).all()
    assert (got.reshape(40, 9, 2, 8, 8)[..., :, 7] == 0).all()


@pytest.mark.parametrize("geometry", ["spread", "far"])
def test_fused_clamp_matches_v4(geometry):
    """CORR_IMPL=pallas_fused: v4's clamped windows, where the clamp bites.
    v4 rounds its bilinear and selection coefficients to bf16, so its
    error scales with the largest value: within one bf16 ulp of max|x|.
    The exact windows are held to the same bound and miss it."""
    args = make_inputs(16, E=128, mem=3, geometry=geometry)
    want = np.asarray(jcp.corr_features_pallas_fused(*_jax(args), interpret=True), np.float32)
    targs = _torch(args)
    bf = tuple(a.to(torch.bfloat16) for a in targs[:3])
    got = corr_features(*bf, *targs[3:], clamp=True).float().numpy()
    exact = corr_features(*bf, *targs[3:]).float().numpy()
    tol = BF16_ULP * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    assert np.abs(exact - want).max() > 4 * tol


def test_unknown_corr_impl_raises():
    with pytest.raises(ValueError, match="CORR_IMPL"):
        StepFunctions(TConfig(CORR_IMPL="pallas_v5"), None, torch.device("cpu"))
    assert StepFunctions(TConfig(CORR_IMPL="auto"), None, torch.device("cpu")).corr_impl == "xla"


N_FRAMES = 24  # tests/test_torch_slice.py's scene; both stop at initialization


def test_pallas_dma_slice_matches_jax(monkeypatch):
    """The tiny slice of tests/test_torch_slice.py with CORR_IMPL=pallas_dma
    in both packages (the JAX step's Pallas kernels in interpret mode, its
    host jj order shipped as on the TPU, the port's sorted on the device),
    the JAX draws injected into the
    port: the init state after 12 updates, held as test_torch_slice.py
    holds the exact path's (f32 summation order elsewhere, and the bf16
    rounding flips of the correlation it causes, amplified by 12 rounds)."""
    monkeypatch.setattr(jsteps, "corr_features_pallas_dma",
                        functools.partial(jcp.corr_features_pallas_dma, interpret=True))
    scene = PlaneScene(ht=HT, wd=WD, n_frames=N_FRAMES, depth=5.0, seed=9002, tstep=0.3,
                       rstep=0.008)
    frames = [scene.render(t) for t in range(N_FRAMES)]
    jcfg = tiny_cfg(E_BUCKETS="off", CORR_IMPL="pallas_dma")
    M = jcfg.PATCHES_PER_FRAME
    jslam = JDPVO(jcfg, jax_params_from_npz(FIXTURE), ht=HT, wd=WD, seed=0)
    assert jslam.steps.corr_impl == "pallas_dma"
    draws, jinit = [], None
    for t in range(N_FRAMES):
        was, n0 = jslam.is_initialized, jslam.n
        jslam(t, frames[t], scene.intrinsics.copy())
        row = n0 if (not was and jslam.n == n0) else jslam.n - 1
        p = np.asarray(jslam.state.patches[row * M:(row + 1) * M])
        draws.append((p[:, :2, 1, 1].copy(), p[:, 2, 1, 1].copy()))
        if jslam.is_initialized and not was:
            jinit = (t, np.asarray(jslam.state.poses[:jslam.n]),
                     np.asarray(jslam.state.dvec[:jslam.m]))
            break

    tcfg = TConfig(**{f: getattr(jcfg, f) for f in TConfig.__dataclass_fields__})
    tslam = TDPVO(tcfg, FIXTURE, ht=HT, wd=WD, device="cpu", draws=lambda f: draws[f])
    assert tslam.steps.corr_impl == "pallas_dma"
    tinit = None
    for t in range(len(draws)):
        was = tslam.is_initialized
        tslam(t, frames[t], scene.intrinsics.copy())
        if tslam.is_initialized and not was:
            tinit = (t, tslam.state.poses[:tslam.n].numpy().copy(),
                     tslam.state.dvec[:tslam.m].numpy().copy())
    assert jinit is not None and tinit is not None and jinit[0] == tinit[0]
    np.testing.assert_allclose(tinit[1], jinit[1], atol=1e-3)
    assert np.median(np.abs(tinit[2] - jinit[2]) / jinit[2]) < 5e-3
    assert np.abs(tinit[2] - jinit[2]).max() < 0.02
