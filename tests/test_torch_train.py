"""Port parity of the training path's pieces against dpvo_tpu on the CPU:
the edge schedule, the correlation's backward pass, the segment sum's
gradient, the loss terms, the median init, the OneCycle schedule and one
optimizer step against optax, the augmentation, the weight mapping and
initialisation, and an overfit check of the port's train step."""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from dpvo_tpu.data import augmentation as j_aug
from dpvo_tpu.lie import se3 as j_se3
from dpvo_tpu.models.vonet import build_schedule as j_build_schedule
from dpvo_tpu.ops.corr import corr_features_xla
from dpvo_tpu.train import loss as j_loss
from dpvo_tpu.train.step import make_optimizer as j_make_optimizer
from dpvo_tpu_torch.ba.segsum import segment_sum, segment_sum_backward
from dpvo_tpu_torch.config import Config
from dpvo_tpu_torch.data import augmentation as t_aug
from dpvo_tpu_torch.models.vonet import build_schedule
from dpvo_tpu_torch.ops.corr import corr_backward_plain, corr_features_plain
from dpvo_tpu_torch.ops.corr_cuda import corr_features_train
from dpvo_tpu_torch.runtime.weights import (init_networks, load_npz, params_from_jax,
                                            params_to_jax)
from dpvo_tpu_torch.train import loss as t_loss
from dpvo_tpu_torch.train.step import make_optimizer
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [(15, 96, 18, 8), (15, 80, 18, 8), (6, 4, 8, 4), (4, 4, 4, 3),
                                   (5, 3, 9, 8)])
def test_build_schedule_matches_jax(shape):
    F, M, S, init = shape
    want = j_build_schedule(F, M, S, init_frames=init)
    got = build_schedule(F, M, S, init_frames=init)
    assert len(got) == len(want) == S
    for a, b in zip(got, want):
        assert a._fields == b._fields
        for name, x, y in zip(a._fields, a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)


def corr_case(seed=0, E=48, Np=10, mem=3, C=16, H=16, W=24, spread=1.0):
    """Features and edges whose windows cross every border of both maps;
    some edges invalid."""
    rng = np.random.default_rng(seed)
    gmap = rng.normal(size=(Np, C, 3, 3)).astype(np.float32)
    f1 = rng.normal(size=(mem, H, W, C)).astype(np.float32)
    f2 = rng.normal(size=(mem, H // 4, W // 4, C)).astype(np.float32)
    ctr = rng.uniform([-4, -4], [W + 4, H + 4], size=(E, 1, 1, 2))
    off = np.stack(np.meshgrid(np.arange(-1.0, 2.0), np.arange(-1.0, 2.0), indexing="ij"),
                   -1)[..., ::-1]
    coords = (ctr + spread * off[None] + 0.3 * rng.normal(size=(E, 3, 3, 2))).astype(np.float32)
    ii = rng.integers(0, Np, E).astype(np.int32)
    jj = rng.integers(0, mem, E).astype(np.int32)
    valid = rng.uniform(size=E) > 0.2
    g = rng.normal(size=(E, 9, 128)).astype(np.float32)
    return gmap, f1, f2, coords, ii, jj, valid, g


def test_corr_backward_plain_matches_jax_vjp():
    """corr_backward_plain against jax.vjp of corr_features_xla's gather
    path (f32 features; the same bf16-rounded cotangent on both sides).
    Tolerance: f32 sums in another order (~1e-6 of the gradients' scale)."""
    gmap, f1, f2, coords, ii, jj, valid, g = corr_case()
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    fn = lambda a, b, c: corr_features_xla(a, b, c, jnp.asarray(coords), jnp.asarray(ii),
                                           jnp.asarray(jj), jnp.asarray(valid), impl="gather")
    _, vjp = jax.vjp(fn, jnp.asarray(gmap), jnp.asarray(f1), jnp.asarray(f2))
    want = vjp(gb)
    t = torch.as_tensor
    got = corr_backward_plain(t(np.array(gb.astype(jnp.float32))).to(torch.bfloat16),
                              t(gmap), t(f1), t(f2), t(coords), t(ii), t(jj), t(valid))
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * np.abs(b).max(), rtol=0)


@pytest.mark.parametrize("spread", [1.0, 5.0])
def test_corr_features_train_grad_matches_autograd_of_plain(spread):
    """CorrFeatures' gradient (through corr_backward on the CPU) against
    autograd of corr_features_plain, patches 1 and 5 px apart; the
    coordinates get no gradient and may not ask for one."""
    gmap, f1, f2, coords, ii, jj, valid, g = corr_case(seed=1, spread=spread)
    ins = [torch.tensor(a, requires_grad=True) for a in (gmap, f1, f2)]
    idx = (torch.as_tensor(coords), torch.as_tensor(ii), torch.as_tensor(jj),
           torch.as_tensor(valid))
    gb = torch.as_tensor(g).to(torch.bfloat16)
    want = torch.autograd.grad(corr_features_plain(*ins, *idx), ins, gb)
    out = corr_features_train(*ins, *idx)
    assert torch.equal(out, corr_features_plain(*ins, *idx))
    got = torch.autograd.grad(out, ins, gb)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5 * b.abs().max().item(), rtol=0)
    with pytest.raises(ValueError, match="coordinates"):
        corr_features_train(*ins, idx[0].clone().requires_grad_(), *idx[1:])


def test_segment_sum_gradcheck():
    """The segment-sum op's gradient by finite differences (f64 payload on
    the plain path; ids past Md dropped), and its backward function, which
    the card path shares, is the gather of the output's gradient."""
    rng = np.random.default_rng(0)
    E, K, Md = 40, 5, 7
    kd = torch.as_tensor(rng.integers(0, Md + 2, E))
    x = torch.tensor(rng.normal(size=(E, K)), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda p: segment_sum(p, kd, None, Md), (x,))
    g = torch.as_tensor(rng.normal(size=(Md, K)), dtype=torch.float32)
    back = segment_sum_backward(g, kd, Md, torch.bfloat16)
    keep = kd < Md
    assert back.dtype == torch.bfloat16
    assert torch.equal(back[keep], g[kd[keep]].to(torch.bfloat16))
    assert not back[~keep].any()
    xf = x.detach().float().requires_grad_()
    (gx,) = torch.autograd.grad(segment_sum(xf, kd, None, Md), xf, g)
    assert torch.equal(gx, segment_sum_backward(g, kd, Md, torch.float32))


def _poses(rng, n, scale=0.3):
    xi = rng.normal(size=(n, 6)).astype(np.float32) * scale
    return np.asarray(j_se3.exp(jnp.asarray(xi)))


def test_pose_error_matches_jax():
    """pose_error and kabsch_scale values, and pose_error's gradient: NaN
    in both (the norm of the i == j pairs' zero errors) where JAX's is."""
    rng = np.random.default_rng(0)
    G, Pg = _poses(rng, 6), _poses(rng, 6)
    A, B = rng.normal(size=(6, 3)).astype(np.float32), rng.normal(size=(6, 3)).astype(np.float32)
    np.testing.assert_allclose(float(t_loss.kabsch_scale(torch.as_tensor(A), torch.as_tensor(B))),
                               float(j_loss.kabsch_scale(jnp.asarray(A), jnp.asarray(B))),
                               rtol=1e-5)
    want = j_loss.pose_error(jnp.asarray(G), jnp.asarray(Pg), 5)
    Gt = torch.tensor(G, requires_grad=True)
    got = t_loss.pose_error(Gt, torch.as_tensor(Pg), 5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-5)
    jg = np.asarray(jax.jit(jax.grad(lambda g: sum(j_loss.pose_error(g, jnp.asarray(Pg), 5))))(
        jnp.asarray(G)))
    (tg,) = torch.autograd.grad(sum(got), Gt)
    np.testing.assert_array_equal(np.isnan(tg.numpy()), np.isnan(jg))


def test_flow_error_matches_jax():
    """Values and gradients (the min's gradient split over ties, as jnp.min)."""
    rng = np.random.default_rng(1)
    c = rng.normal(size=(20, 3, 3, 2)).astype(np.float32)
    cg = rng.normal(size=(20, 3, 3, 2)).astype(np.float32)
    cg[3] = c[3] + 1.0  # a tie: all 9 pixels' errors equal
    v = (rng.uniform(size=20) > 0.3).astype(np.float32)
    f = lambda cc: j_loss.flow_error(jnp.asarray(v), cc, jnp.asarray(cg), 3)[0]
    want, jg = jax.value_and_grad(f)(jnp.asarray(c))
    ct = torch.tensor(c, requires_grad=True)
    got = t_loss.flow_error(torch.as_tensor(v), ct, torch.as_tensor(cg), 3)[0]
    (tg,) = torch.autograd.grad(got, ct)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7)


def test_median_init_is_jnp_median():
    """The depth init's median of an even count: jnp.median averages the
    middle two, torch.median returns the lower; torch.quantile(x, 0.5) (the
    port's) gives JAX's value."""
    x = np.random.default_rng(0).uniform(size=2 * 96 * 9).astype(np.float32)
    want = float(jnp.median(jnp.asarray(x)))
    t = torch.as_tensor(x)
    assert float(torch.quantile(t, 0.5)) == pytest.approx(want, abs=1e-7)
    assert abs(float(torch.median(t)) - want) > 1e-6


def test_onecycle_schedule_matches_optax():
    """optax's linear OneCycle at the recipe's T = 240000, lr 8e-5 (two of
    its boundaries fall on T; the later scale wins)."""
    tx, sched = make_optimizer(lr=8e-5, total_steps=240000)
    _, jsched = j_make_optimizer(lr=8e-5, total_steps=240000)
    for step, value in ((0, 3.2e-6), (2400, 8e-5), (120000, 4.0408e-5), (240000, 8e-9),
                        (300000, 8e-9)):
        assert sched(step) == pytest.approx(value, rel=1e-4)
        assert sched(step) == pytest.approx(float(jsched(step)), rel=1e-6, abs=1e-12)
    for step in (1, 1200, 2399, 2401, 60000, 239999):
        assert sched(step) == pytest.approx(float(jsched(step)), rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("freeze", [False, True])
def test_optimizer_step_matches_optax(freeze):
    """Two optimizer steps from the same gradients against optax's chain
    (zero_nans -> clip_by_global_norm -> adamw) and, frozen, its
    multi_transform with set_to_zero for the encoders; the first step's
    gradients have a NaN and are clipped, the second's are not."""
    rng = np.random.default_rng(2)
    shapes = {"['patchifier']['params']['fnet']['Conv_0']['kernel']": (3, 3, 3, 4),
              "['patchifier']['params']['fnet']['Conv_0']['bias']": (4,),
              "['update']['params']['Dense_0']['kernel']": (6, 5),
              "['update']['params']['Dense_0']['bias']": (5,)}
    flat = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: 3.0 * rng.normal(size=s).astype(np.float32) for k, s in shapes.items()},
             {k: 0.1 * rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}]
    grads[0]["['update']['params']['Dense_0']['kernel']"][1, 2] = np.nan
    tree = lambda d: {"patchifier": {"params": {"fnet": {"Conv_0": {
        "kernel": jnp.asarray(d[next(iter(shapes))]),
        "bias": jnp.asarray(d["['patchifier']['params']['fnet']['Conv_0']['bias']"])}}}},
        "update": {"params": {"Dense_0": {
            "kernel": jnp.asarray(d["['update']['params']['Dense_0']['kernel']"]),
            "bias": jnp.asarray(d["['update']['params']['Dense_0']['bias']"])}}}}
    jtx, _ = j_make_optimizer(lr=1e-3, total_steps=100, clip=1.0)
    if freeze:
        jtx = optax.multi_transform({"train": jtx, "freeze": optax.set_to_zero()},
                                    {"patchifier": "freeze", "update": "train"})
    jp = tree(flat)
    jstate = jtx.init(jp)
    tx, _ = make_optimizer(lr=1e-3, total_steps=100, clip=1.0, freeze_encoders=freeze)
    tp = {k: v.clone() for k, v in params_from_jax(flat).items()}
    tstate = tx.init(tp)
    if freeze:
        assert all(k.startswith("update.") for k in tstate["mu"])
    for g in grads:
        ju, jstate = jtx.update(tree(g), jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tg = params_from_jax(g)
        tu, tstate = tx.update(tg, tstate, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
    want = params_from_jax({jax.tree_util.keystr(k): np.asarray(v)
                            for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]})
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), want[k].numpy(), atol=1e-7, rtol=0, err_msg=k)
        if freeze and k.startswith("patchifier."):
            assert torch.equal(tp[k], params_from_jax(flat)[k])


def test_color_jitter_matches_jax():
    """The same numpy Generator calls in the same order: equal clips."""
    im = np.random.default_rng(3).uniform(0, 255, (3, 12, 16, 3)).astype(np.float32)
    for seed in range(12):  # some seeds take the grayscale / invert branches
        want = j_aug.color_jitter(im, np.random.default_rng(seed))
        got = t_aug.color_jitter(im, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)


def test_resize_matches_opencv():
    """random_scale_crop's bilinear resize (torch, no OpenCV) within 1e-3
    of cv2.resize INTER_LINEAR on float input, and the whole augmentation
    step within that of the JAX package's under the same seed."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    im = rng.uniform(0, 255, (2, 24, 32, 3)).astype(np.float32)
    d = rng.uniform(0.1, 2, (2, 24, 32)).astype(np.float32)
    for nh, nw in ((30, 40), (34, 45), (24, 33)):
        want = np.stack([cv2.resize(x, (nw, nh), interpolation=cv2.INTER_LINEAR) for x in im])
        np.testing.assert_allclose(t_aug.resize_bilinear(im, nh, nw), want, atol=1e-3, rtol=0)
        want = np.stack([cv2.resize(x, (nw, nh), interpolation=cv2.INTER_LINEAR) for x in d])
        np.testing.assert_allclose(t_aug.resize_bilinear(d, nh, nw), want, atol=1e-3, rtol=0)
    intr = np.array([30.0, 30.0, 16.0, 12.0], np.float32)
    for seed in range(4):
        want = j_aug.augment_clip(im, d, intr, np.random.default_rng(seed))
        got = t_aug.augment_clip(im, d, intr, np.random.default_rng(seed))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)


@pytest.mark.parametrize("path", ["weights/vonet_synth.npz", "tests/fixtures/tiny_synth.npz"])
def test_params_to_jax_round_trip(path):
    flat = load_npz(os.path.join(ROOT, path))
    back = params_to_jax(params_from_jax(flat))
    assert set(back) == set(flat)
    for k in flat:
        assert back[k].shape == flat[k].shape and np.array_equal(back[k], flat[k]), k


def test_init_networks_matches_flax_statistics():
    """Each layer's spread against flax's init_params (lecun_normal kernels:
    std 1/sqrt(fan_in), truncated at 2 std; zero biases; LayerNorm one and
    zero): the two stds within the sampling bound of the smaller layer
    (5 standard errors), every value inside the truncation."""
    from dpvo_tpu.config import Config as JConfig
    from dpvo_tpu.runtime.weights import init_params

    kw = dict(DIM=32, FDIM=16, PATCHES_PER_FRAME=4)
    jflat = params_from_jax({jax.tree_util.keystr(k): np.asarray(v) for k, v in
                             jax.tree_util.tree_flatten_with_path(
                                 jax.jit(lambda k: init_params(JConfig(**kw), k))(
                                     jax.random.PRNGKey(0)))[0]})
    nets = init_networks(Config(**kw), torch.Generator().manual_seed(0))
    for k, p in nets.named_parameters():
        want = jflat[k]
        assert p.shape == want.shape, k
        if k.endswith("bias"):
            assert not p.any() and not want.any(), k
        elif p.ndim == 1:
            assert torch.equal(p.detach(), torch.ones_like(p)) and torch.equal(want, p.detach())
        else:
            n, fan_in = p.numel(), p[0].numel()
            sw, sp = float(want.std()), float(p.detach().std())
            assert abs(sp - sw) <= 5 * sw / np.sqrt(2 * n), (k, sp, sw)
            assert float(p.abs().max()) <= 2 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-6


def test_training_learns_on_fixed_batch():
    """Overfit check, as tests/test_train.py's: 25 steps of clip + AdamW
    3e-4 on one fixed tiny clip bring the median loss of the last five
    below 0.7x that of the first five."""
    from dpvo_tpu_torch.train.step import Optimizer, make_train_step
    from dpvo_tpu_torch.utils.synthetic import PlaneScene

    cfg = Config(PATCHES_PER_FRAME=4, DIM=32, FDIM=16, MIXED_PRECISION=False)
    HT, WD, F = 64, 96, 5
    scene = PlaneScene(ht=HT, wd=WD, n_frames=F, depth=4.0, seed=3)
    ys, xs = np.mgrid[0:HT, 0:WD]
    batch = dict(images=np.stack([scene.render(t) for t in range(F)])[None].astype(np.float32),
                 poses=scene.poses[None].astype(np.float32),
                 disps=np.stack([scene.inv_depth(t, xs.astype(np.float64), ys.astype(np.float64))
                                 for t in range(F)])[None].astype(np.float32),
                 intrinsics=scene.intrinsics[None].astype(np.float32))
    nets = init_networks(cfg, torch.Generator().manual_seed(0))
    tx = Optimizer(lambda count: 3e-4, clip=10.0, weight_decay=1e-4)
    opt = tx.init(dict(nets.named_parameters()))
    step = make_train_step(cfg, tx, STEPS=4)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(25):
        nets, opt, m = step(nets, opt, batch, gen)
        losses.append(m["loss"].item())
    first, last = np.median(losses[:5]), np.median(losses[-5:])
    assert np.isfinite(losses).all()
    assert last < 0.7 * first, (first, last, losses[::5])
