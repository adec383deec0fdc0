"""GRADIENT_BIAS centroid selection of the port against the JAX package on
the CPU: the pooled image gradient, the selection on JAX's own candidate
draws (an image built for ties included), the patchify outputs, a tracker
run, the export, the refusal of an unknown strategy, and the Timer port.
The train-step gradient under GRADIENT_BIAS is held to JAX's in
tests/test_torch_train_e2e_gb.py."""

import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dpvo_tpu.eval import ate_rmse
from dpvo_tpu.lie import se3 as jse3
from dpvo_tpu.models import Patchifier as JPatchifier
from dpvo_tpu.runtime import DPVO as JDPVO
from dpvo_tpu.utils.synthetic import PlaneScene
from dpvo_tpu_torch.config import Config as TConfig
from dpvo_tpu_torch.models.patchifier import image_gradient, select_centroids
from dpvo_tpu_torch.runtime.dpvo import DPVO as TDPVO
from dpvo_tpu_torch.runtime.weights import load_networks
from test_torch_models import CKPTS, _close_rel, jax_params_from_npz
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)
from test_tracking_e2e import FIXTURE, HT, WD, tiny_cfg

GB = "GRADIENT_BIAS"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _frame(name):
    """A uint8 frame: the tiny tracker scene's (48x64), the main path's
    (480x640), or vertical stripes 8 px wide in two colours (48x64), whose
    pooled gradient is one value in every other 4x4 cell and zero between,
    so that scores tie at the top and at the bottom."""
    if name == "scene48":
        return PlaneScene(ht=HT, wd=WD, n_frames=1, depth=5.0, seed=9002, tstep=0.3,
                          rstep=0.008).render(0)
    if name == "scene480":
        return PlaneScene(ht=480, wd=640, n_frames=1, depth=4.0, seed=7, tstep=0.06,
                          rstep=0.004).render(0)
    stripes = np.where((np.arange(WD) // 8) % 2 == 0, 0, 1)
    colours = np.array([[30, 60, 90], [200, 180, 160]], np.uint8)
    return np.broadcast_to(colours[stripes][None], (HT, WD, 3)).copy()


def _normalized(frame, jdt):
    """The tracker's normalization of a uint8 frame, cast to jdt (f32
    numpy)."""
    x = 2.0 * (jnp.asarray(frame).astype(jnp.float32) / 255.0) - 0.5
    return np.asarray(x[None].astype(jdt).astype(jnp.float32))


@pytest.mark.parametrize("frame", ["scene48", "scene480"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_image_gradient_matches_jax(dt, frame):
    """The pooled gradient against the JAX patchifier's, compiled as the
    tracker compiles it: bf16 bit for bit (the port follows XLA's roundings),
    f32 within 1e-5 (one ulp where XLA's fused 4x4 sum takes another order;
    equal at 480x640)."""
    jdt, tdt = DTYPES[dt]
    img = _normalized(_frame(frame), jdt)
    want = np.asarray(jax.jit(JPatchifier(dtype=jdt)._image_gradient)(
        jnp.asarray(img).astype(jdt)).astype(jnp.float32))
    got = image_gradient(torch.as_tensor(img).to(tdt))
    assert got.dtype == tdt and got.shape == want.shape
    if dt == "bf16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# (frame, patches a frame M) of the selection cases
SELECT_CASES = {"scene48": 8, "stripes": 16, "scene480": 96}


@pytest.fixture(scope="module")
def jax_selections():
    """Per (dtype, frame): the JAX patchifier's outputs under GRADIENT_BIAS
    (jitted, the tiny checkpoint's weights), its candidates (the 3M points
    its key draws, rebuilt with jax.random) and the normalized image."""
    jparams = jax_params_from_npz(CKPTS["tiny"][0])["patchifier"]
    dims = CKPTS["tiny"][1]
    out = {}
    for dt, (jdt, _) in DTYPES.items():
        jp = JPatchifier(patch_size=3, dim=dims["DIM"], fdim=dims["FDIM"], dtype=jdt)
        for frame, M in SELECT_CASES.items():
            img = _normalized(_frame(frame), jdt)
            key = jax.random.PRNGKey(5)
            apply = jax.jit(lambda p, x, k, M=M, jp=jp: jp.apply(p, x, M, k,
                                                                 centroid_sel_strat=GB))
            want = apply(jparams, jnp.asarray(img).astype(jdt), key)
            h, w = img.shape[1] // 4, img.shape[2] // 4
            kx, ky = jax.random.split(key)
            cand = np.stack([np.asarray(jax.random.randint(kx, (1, 3 * M), 1, w - 1)),
                             np.asarray(jax.random.randint(ky, (1, 3 * M), 1, h - 1))], -1)
            out[dt, frame] = (img, cand.astype(np.float32), want)
    return out


@pytest.mark.parametrize("frame", list(SELECT_CASES))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_selection_matches_jax(jax_selections, dt, frame):
    """The port's selection on JAX's candidates gives JAX's centroids (read
    back from the patch grid's centre pixels) exactly, in JAX's order. On
    the stripes equal scores straddle the cut: the lower candidate index
    wins, as in jax.lax.top_k."""
    img, cand, want = jax_selections[dt, frame]
    M = SELECT_CASES[frame]
    tdt = DTYPES[dt][1]
    images = torch.as_tensor(img).to(tdt)
    got = select_centroids(images, torch.as_tensor(cand), M, GB)[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(want[3])[:, :2, 1, 1])
    if frame == "stripes":
        g = image_gradient(images)[0]
        c = torch.as_tensor(cand[0]).long()
        score = torch.sort(g[c[:, 1], c[:, 0]], descending=True).values
        assert score[M - 1] == score[M] > 0 and (score == 0).sum() > M


def test_patchify_gradient_bias_matches_jax(jax_selections):
    """fmap / gmap / imap / patches / clr of the port's patchifier at its
    selected centroids against the JAX patchifier under GRADIENT_BIAS, f32,
    tiny checkpoint, within test_torch_models.py's tolerance for RANDOM."""
    nets = load_networks(TConfig(**CKPTS["tiny"][1]), CKPTS["tiny"][0]).eval()
    for frame, M in SELECT_CASES.items():
        img, cand, want = jax_selections["f32", frame]
        images = torch.as_tensor(img)
        with torch.no_grad():
            got = nets.patchifier(images, select_centroids(images, torch.as_tensor(cand), M, GB))
        for g, w in zip(got, want):
            _close_rel(g, w, 1e-5)


# the tracker case: tests/test_torch_slice.py's scene and configuration with
# GRADIENT_BIAS at half its motion (tstep 0.15, rstep 0.004): at its 0.3 /
# 0.008 no draw of six passed the well-conditioning check below, RANDOM's no
# more than GRADIENT_BIAS's, at half three of six did. TRACK_SEEDS: every JAX
# tracker seed of 0-14 whose draws pass the check.
TRACK_FRAMES, TRACK_SEEDS = 24, (0, 3, 7, 12)
TRACK_MOTION = dict(tstep=0.15, rstep=0.004)


def _jax_call_draws(jslam, frames, intrinsics):
    """Run the JAX tracker over frames and rebuild the draws of each call
    from the PRNG keys it took: a fused steady frame takes one key and
    splits it into (patchify, ingest) keys, any other frame takes the two
    in turn; the patchify key splits into (kx, ky), which draw the 3M
    candidates x then y, and the ingest key draws the M initial inverse
    depths. Returns [(candidates [3M, 2], depths [M])] per call."""
    M = jslam.cfg.PATCHES_PER_FRAME
    h, w = jslam.ht // jslam.cfg.RES, jslam.wd // jslam.cfg.RES
    keys, take = [], jslam._next_key

    def record():
        k = take()
        keys[-1].append(k)
        return k

    jslam._next_key = record
    for t, image in enumerate(frames):
        keys.append([])
        jslam(t, image, intrinsics.copy())
    draws = []
    for ks in keys:
        kp, kd = jax.random.split(ks[0]) if len(ks) == 1 else ks
        kx, ky = jax.random.split(kp)
        cand = np.stack([np.asarray(jax.random.randint(kx, (1, 3 * M), 1, w - 1))[0],
                         np.asarray(jax.random.randint(ky, (1, 3 * M), 1, h - 1))[0]], -1)
        draws.append((cand.astype(np.float32), np.asarray(jax.random.uniform(kd, (M,)))))
    return draws


def run_jax_tracker(seed, corr_impl="region", monkeypatch=None):
    """The JAX tracker under GRADIENT_BIAS over the tracker case, with its
    correlation's formulation corr_impl ('region', the JAX package's
    default off the TPU, or 'gather', the per-pixel one the port follows:
    the same function summed in another order; needs monkeypatch), its
    per-call draws, and a maker of the port's tracker on those draws."""
    scene = PlaneScene(ht=HT, wd=WD, n_frames=TRACK_FRAMES, depth=5.0, seed=9002,
                       **TRACK_MOTION)
    frames = [scene.render(t) for t in range(TRACK_FRAMES)]
    jcfg = tiny_cfg(E_BUCKETS="off", CENTROID_SEL_STRAT=GB)
    if corr_impl != "region":
        from dpvo_tpu.ops.corr import corr_features_xla
        from dpvo_tpu.runtime import steps as jsteps

        monkeypatch.setattr(jsteps, "corr_features_xla",
                            functools.partial(corr_features_xla, impl=corr_impl))
    jslam = JDPVO(jcfg, jax_params_from_npz(FIXTURE), ht=HT, wd=WD, seed=seed)
    draws = _jax_call_draws(jslam, frames, scene.intrinsics)
    jposes, _ = jslam.terminate()
    if monkeypatch is not None:
        monkeypatch.undo()
    tcfg = TConfig(**{f: getattr(jcfg, f) for f in TConfig.__dataclass_fields__})

    def port():
        return TDPVO(tcfg, FIXTURE, ht=HT, wd=WD, device="cpu", draws=lambda f: draws[f])

    gt = np.asarray(jse3.inv(jnp.asarray(scene.poses[:TRACK_FRAMES])))
    return dict(jslam=jslam, jposes=jposes, draws=draws, port=port, frames=frames,
                intrinsics=scene.intrinsics, gt=gt)


@pytest.mark.parametrize("seed", TRACK_SEEDS)
def test_tracker_gradient_bias_matches_jax(seed, monkeypatch):
    """The port's tracker under GRADIENT_BIAS on the JAX tracker's own
    per-call candidates, on draws that test_torch_slice.py's
    well-conditioning criterion accepts (the port's run with the
    correlation in f64 passes check_free_runs): the JAX tracker's keyframes
    and centroids, and its trajectory within test_torch_slice.py's bounds
    (1% of the path, quaternions 0.01, ATE within 5%) of the JAX tracker
    whose correlation sums as the port's does (impl 'gather'). Against the
    JAX default ('region') the port departs no further than 1% of the path
    beyond where JAX's two correlation orders part from each other.
    Measured (port - gather, port - region, gather - region, share of the
    path): seed 0 0.34%, 12.6%, 12.4%; seed 3 0.45%, 0.16%, 0.29%; seed 7
    0.03%, 0.03%, 0.02%; seed 12 0.48%, 1.00%, 0.85%. Seed 0's gap to
    'region' is the JAX tracker's own sensitivity to the correlation's
    summation order, not the centroid selection: both JAX runs select the
    same centroids and keep the same keyframes."""
    from dpvo_tpu_torch.ops.corr import corr_features_plain
    from dpvo_tpu_torch.runtime import steps

    region = run_jax_tracker(seed)
    gather = run_jax_tracker(seed, "gather", monkeypatch)
    for (ca, da), (cb, db) in zip(region["draws"], gather["draws"], strict=True):
        np.testing.assert_array_equal(ca, cb)
        np.testing.assert_array_equal(da, db)
    tslam = gather["port"]()
    ref = chip_smoke.free_run(tslam, gather["frames"], gather["intrinsics"])
    tp = ref[2]
    assert ref[0] is not None and tslam.is_initialized
    M = tslam.cfg.PATCHES_PER_FRAME
    for jslam in (region["jslam"], gather["jslam"]):
        assert jslam.is_initialized
        assert list(tslam.tstamps) == list(jslam.tstamps)
        assert sorted(tslam.delta) == sorted(jslam.delta)
        # the patches are the JAX tracker's: the live keyframes' centroids equal
        np.testing.assert_array_equal(tslam.state.patches[:tslam.n * M, :2, 1, 1].numpy(),
                                      np.asarray(jslam.state.patches[:jslam.n * M, :2, 1, 1]))
    jp, jr = gather["jposes"], region["jposes"]
    path = np.linalg.norm(np.diff(jp[:, :3], axis=0), axis=1).sum()
    dist = lambda a, b: np.abs(a[:, :3] - b[:, :3]).max()
    assert tp.shape == jp.shape and np.isfinite(tp).all()
    assert dist(tp, jp) < 0.01 * path
    assert np.abs(np.abs(tp[:, 3:]) - np.abs(jp[:, 3:])).max() < 0.01
    gt = gather["gt"][:, :3]
    ate_j, ate_t = ate_rmse(jp[:, :3], gt), ate_rmse(tp[:, :3], gt)
    assert abs(ate_t - ate_j) < 0.05 * ate_j, (ate_t, ate_j)
    assert dist(tp, jr) < dist(jp, jr) + 0.01 * path

    monkeypatch.setattr(steps, "corr_features", lambda g, f1, f2, c, i, j, v, radius=3:
                        corr_features_plain(g.double(), f1.double(), f2.double(), c.double(),
                                            i, j, v, radius))
    alt = chip_smoke.free_run(gather["port"](), gather["frames"], gather["intrinsics"])
    chip_smoke.check_free_runs(ref, alt, who="f64 correlation")


def _gb_draws(n_frames, M, h, w, seed=3):
    rng = np.random.default_rng(seed)
    return [(np.stack([rng.integers(1, w - 1, 3 * M), rng.integers(1, h - 1, 3 * M)], -1)
             .astype(np.float32), rng.uniform(size=M).astype(np.float32))
            for _ in range(n_frames)]


def test_export_gradient_bias(tmp_path):
    """An export made under GRADIENT_BIAS records the strategy, its
    patchify.pt2 takes the 3M candidates, the tracker on it equals the eager
    tracker bit for bit on the CPU (keyframes, poses, point cloud), and a
    RANDOM tracker refuses the directory (and a GRADIENT_BIAS one an export
    whose meta says RANDOM)."""
    from dpvo_tpu_torch.deploy.export import export_network, read_meta

    cfg = TConfig(**dict(chip_smoke.SMALL_CFG, CENTROID_SEL_STRAT=GB))
    nets = load_networks(cfg, FIXTURE)
    out = export_network(nets, cfg, HT, WD, str(tmp_path / "gb"), device="cpu")
    assert read_meta(out)["centroid_sel_strat"] == GB
    _, frames, K = chip_smoke.small_path()
    frames = frames[:16]
    draws = _gb_draws(len(frames), cfg.PATCHES_PER_FRAME, HT // 4, WD // 4)
    eager = TDPVO(cfg, FIXTURE, HT, WD, device="cpu", draws=lambda f: draws[f])
    exp = TDPVO(cfg, out, HT, WD, device="cpu", draws=lambda f: draws[f])
    assert exp.steps.exported is not None
    ra, rb = chip_smoke.free_run(eager, frames, K), chip_smoke.free_run(exp, frames, K)
    assert ra[0] is not None and ra[0][0] == rb[0][0] and ra[1] == rb[1]
    np.testing.assert_array_equal(ra[2], rb[2])
    for x, y in zip(eager.point_cloud(), exp.point_cloud()):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="incompatible"):
        TDPVO(cfg.replace(CENTROID_SEL_STRAT="RANDOM"), out, HT, WD, device="cpu")
    # the same directory, its meta saying RANDOM
    rnd = tmp_path / "random"
    shutil.copytree(out, rnd)
    meta = read_meta(str(rnd))
    (rnd / "meta.json").write_text(json.dumps(dict(meta, centroid_sel_strat="RANDOM")))
    with pytest.raises(ValueError, match="incompatible"):
        TDPVO(cfg, str(rnd), HT, WD, device="cpu")


@pytest.mark.parametrize("where", ["tracker", "draw_inputs", "train_step", "vo_forward"])
def test_unknown_strategy_raises(where):
    """Any CENTROID_SEL_STRAT but RANDOM and GRADIENT_BIAS raises, as the
    JAX patchifier's NotImplementedError does: in the tracker at its first
    frame's patchify (the JAX tracker's is where it traces the patchifier),
    in the unroll's draws, in the train step and in the unroll itself."""
    from dpvo_tpu_torch.models.vonet import draw_inputs, vo_forward
    from dpvo_tpu_torch.runtime.weights import init_networks
    from dpvo_tpu_torch.train import make_optimizer, make_train_step
    import test_torch_train_e2e as e2e

    cfg = TConfig(**dict(e2e.CFG_KW, CENTROID_SEL_STRAT="SOBEL"))
    with pytest.raises(ValueError, match="CENTROID_SEL_STRAT"):
        if where == "tracker":
            slam = TDPVO(cfg, None, 32, 32, device="cpu")
            slam(0, np.zeros((32, 32, 3), np.uint8), np.array([30.0, 30.0, 16.0, 16.0]))
        elif where == "draw_inputs":
            draw_inputs(2, 4, 8, 8, 2, torch.Generator().manual_seed(0), strategy="SOBEL")
        else:
            nets = init_networks(cfg, torch.Generator().manual_seed(0))
            images, poses, disps, intr = e2e.tiny_clip()
            if where == "vo_forward":
                draws = draw_inputs(e2e.F, e2e.M, e2e.HT // 4, e2e.WD // 4, e2e.STEPS,
                                    torch.Generator().manual_seed(0))
                vo_forward(nets, cfg, torch.as_tensor(images), torch.as_tensor(poses),
                           torch.as_tensor(disps), torch.as_tensor(intr), draws, STEPS=e2e.STEPS)
            else:
                tx, _ = make_optimizer(total_steps=10)
                step = make_train_step(cfg, tx, STEPS=e2e.STEPS)
                batch = dict(images=images[None], poses=poses[None], disps=disps[None],
                             intrinsics=intr[None])
                step(nets, tx.init(dict(nets.named_parameters())), batch,
                     torch.Generator().manual_seed(0))


def test_timer_records_and_prints(capsys):
    """Timer as a context manager and as a decorator: each enabled region
    appends its milliseconds to all_times[name] and prints them as
    '{name} {ms:.03f}'; a disabled one records nothing. A CPU tensor or
    device as sync needs no wait; the card's would synchronize it."""
    import time

    from dpvo_tpu_torch.utils import Timer
    from dpvo_tpu_torch.utils import timer as timer_mod

    timer_mod.all_times.pop("region", None)
    timer_mod.all_times.pop("decorated", None)
    with Timer("region", sync=torch.zeros(2)):
        time.sleep(0.01)
    with Timer("region", enabled=False):
        pass

    @Timer("decorated", sync="cpu")
    def work(x):
        return x + 1

    assert work(1) == 2 and work(2) == 3
    assert len(timer_mod.all_times["region"]) == 1 and timer_mod.all_times["region"][0] >= 10.0
    assert len(timer_mod.all_times["decorated"]) == 2
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == ["region", "decorated", "decorated"]
    assert all(len(ln.split()[1].split(".")[1]) == 3 for ln in lines)
