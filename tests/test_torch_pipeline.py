"""PIPELINE_DEPTH and KEYFRAME_SYNC in the port's tracker, on the CPU.

The JAX tracker keeps up to PIPELINE_DEPTH steady frames in flight and
applies each one's keyframe decision when it drains it, with the frame
count of that moment (dpvo_tpu/runtime/dpvo.py:_drain_one). The port
applies the same decisions at the same moments: its bookkeeping as
tests/test_runtime.py::test_fused_pipeline_depth holds the JAX tracker's,
KEYFRAME_SYNC as the inline decision, terminate() draining, and the tiny
slice at depth 3 against the JAX tracker at depth 3.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from dpvo_tpu.eval import ate_rmse
from dpvo_tpu.lie import se3 as jse3
from dpvo_tpu.runtime import DPVO as JDPVO
from dpvo_tpu.utils.synthetic import PlaneScene
from dpvo_tpu_torch.config import Config as TConfig
from dpvo_tpu_torch.runtime.dpvo import DPVO as TDPVO
from test_torch_models import jax_params_from_npz
from test_tracking_e2e import FIXTURE, HT, WD, tiny_cfg
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)


N_FRAMES = 24
# The JAX tracker's seed (its patch draws) for the depth-3 comparison. The
# tiny network amplifies rounding differences on most draws, and more so
# at depth 3: of seeds 0-15, the draws of 6, 11, 13 and 14 pass the
# conditioning check below; 14 passes it with 1, 2, 4 and 8 torch threads
# and tracks the JAX trajectory within 0.1% of the path (seed 0, that of
# test_torch_slice.py, moves 11% of the path under the f64 correlation).
JAX_SEED = 14


def _scene(n_frames=N_FRAMES):
    """tests/test_torch_slice.py's scene and frames."""
    scene = PlaneScene(ht=HT, wd=WD, n_frames=n_frames, depth=5.0, seed=9002, tstep=0.3,
                       rstep=0.008)
    return scene, [scene.render(t) for t in range(n_frames)]


def _forced(slam):
    """Open the probe gate and force every third keyframe decision to a cull
    (the rest keep), as test_fused_pipeline_depth does. Returns the count
    of decisions made."""
    slam._motion_probe = lambda: 1e9
    orig, calls = slam._keyframe_decide, {"i": 0}

    def fixed(m, **kw):
        calls["i"] += 1
        orig(0.0 if calls["i"] % 3 == 0 else 1e9, **kw)

    slam._keyframe_decide = fixed
    return calls


def _random_tracker(depth, **kw):
    cfg = TConfig(**dict(chip_smoke.SMALL_CFG, PIPELINE_DEPTH=depth, **kw))
    return TDPVO(cfg, None, ht=HT, wd=WD, device="cpu", seed=3)


def test_pipeline_depth_bookkeeping():
    """Depth 3: up to 3 decisions pending, each applied with the frame count
    of its drain; the bookkeeping stays consistent through the culls and the
    trajectory is complete and finite."""
    scene, frames = _scene(20)
    slam = _random_tracker(3)
    calls = _forced(slam)
    depth_seen = 0
    for t, image in enumerate(frames):
        slam(t, image, scene.intrinsics.copy())
        depth_seen = max(depth_seen, len(slam._inflights))
    assert depth_seen == 3  # the pipeline really runs deep
    poses, _ = slam.terminate()
    assert poses.shape == (20, 7) and np.isfinite(poses).all()
    assert np.allclose(np.linalg.norm(poses[:, 3:], axis=1), 1.0, atol=1e-3)
    # decisions all consumed: one cull per 3 decides, each applied
    assert calls["i"] == 20 - 8 and not slam._inflights
    assert slam.n == 20 - calls["i"] // 3
    assert len(slam.tstamps) == slam.n and len(slam.delta) == calls["i"] // 3


def test_terminate_drains():
    """terminate() applies the pending decisions before its 12 update rounds,
    and update() outside the steady frame drains, as the JAX tracker's
    _flush_pending: no round runs with a decision pending."""
    scene, frames = _scene(12)
    slam = _random_tracker(3)
    calls = _forced(slam)
    for t, image in enumerate(frames):
        slam(t, image, scene.intrinsics.copy())
    assert len(slam._inflights) == 3 and calls["i"] == 1  # frames 8-10 drained 1 at frame 11
    pending = []
    real = slam._update
    slam._update = lambda: (pending.append(len(slam._inflights)), real())
    slam.terminate()
    assert pending == [0] * 12 and calls["i"] == 4 and not slam._inflights
    assert slam.n == 12 - 1


def test_keyframe_sync_is_the_inline_decision():
    """KEYFRAME_SYNC at depth 3 decides right after each frame: the same bits
    as depth 1, whose decisions wait only until the next call."""
    runs = {}
    for name, kw in (("depth1", {}), ("sync3", dict(PIPELINE_DEPTH=3, KEYFRAME_SYNC=True))):
        tracker, frames, K = chip_smoke.small_path(**kw)
        slam = tracker("cpu")
        seen = []
        for t, image in enumerate(frames):
            slam(t, image, K.copy())
            seen.append(len(slam._inflights))
        poses, _ = slam.terminate()
        runs[name] = (poses, list(slam.tstamps), sorted(slam.delta), max(seen))
    (p1, k1, d1, s1), (p3, k3, d3, s3) = runs["depth1"], runs["sync3"]
    assert s1 == 1 and s3 == 0
    assert k1 == k3 and d1 == d3 and np.array_equal(p1, p3)
    assert len(k1) < N_FRAMES - 1  # keyframes were culled


@pytest.fixture(scope="module")
def depth3():
    """The JAX tracker at PIPELINE_DEPTH=3 on tests/test_torch_slice.py's
    scene, its draws read back from its state, and the port at depth 3 on
    the same draws."""
    scene, frames = _scene()
    jcfg = tiny_cfg(E_BUCKETS="off", PIPELINE_DEPTH=3)
    M = jcfg.PATCHES_PER_FRAME
    jslam = JDPVO(jcfg, jax_params_from_npz(FIXTURE), ht=HT, wd=WD, seed=JAX_SEED)
    draws, jdepth = [], 0
    for t in range(N_FRAMES):
        was, n0 = jslam.is_initialized, jslam.n
        jslam(t, frames[t], scene.intrinsics.copy())
        jdepth = max(jdepth, len(jslam._inflights))
        # the frame's row of state.patches (a pending cull's shift runs in
        # the next frame's step, before its ingest)
        row = n0 if (not was and jslam.n == n0) else jslam.n - 1
        p = np.asarray(jslam.state.patches[row * M:(row + 1) * M])
        draws.append((p[:, :2, 1, 1].copy(), p[:, 2, 1, 1].copy()))
    jposes, jtimes = jslam.terminate()
    tcfg = TConfig(**{f: getattr(jcfg, f) for f in TConfig.__dataclass_fields__})

    def port(**kw):
        slam = TDPVO(tcfg, FIXTURE, ht=HT, wd=WD, device="cpu", draws=lambda f: draws[f], **kw)
        return chip_smoke.free_run(slam, frames, scene.intrinsics), slam

    (tinit, tkf, tposes), tslam = port()
    gt = np.asarray(jse3.inv(jnp.asarray(scene.poses[:N_FRAMES])))
    return dict(j=(jslam, jposes, jtimes, jdepth), t=(tslam, tposes, (tinit, tkf, tposes)),
                port=port, gt=gt)


def test_depth3_draws_are_well_conditioned(depth3, monkeypatch):
    """The draws compared below are ones on which a change of rounding alone
    keeps the port's depth-3 trajectory (test_torch_slice.py::
    test_small_parity_draws_are_well_conditioned's check: the correlation in
    f64 instead of f32)."""
    from dpvo_tpu_torch.ops.corr import corr_features_plain
    from dpvo_tpu_torch.runtime import steps

    monkeypatch.setattr(steps, "corr_features", lambda g, f1, f2, c, i, j, v, radius=3:
                        corr_features_plain(g.double(), f1.double(), f2.double(), c.double(),
                                            i, j, v, radius))
    alt, _ = depth3["port"]()
    chip_smoke.check_free_runs(depth3["t"][2], alt, who="f64 correlation")


def test_depth3_matches_jax(depth3):
    """The tiny slice at PIPELINE_DEPTH=3, held as tests/test_torch_slice.py
    holds depth 1: the same keyframes and culled frames, the trajectory
    within 1% of the path, the ATE within 5%."""
    (jslam, jp, jt, jdepth), (tslam, tp, _), gt = depth3["j"], depth3["t"], depth3["gt"]
    assert jdepth == 3 and tslam.is_initialized and jslam.is_initialized
    assert list(tslam.tstamps) == list(jslam.tstamps)
    assert sorted(tslam.delta) == sorted(jslam.delta) and len(tslam.delta) > 0
    np.testing.assert_array_equal(np.asarray(tslam.tlist), jt)
    assert tp.shape == jp.shape == (N_FRAMES, 7) and np.isfinite(tp).all()
    path = np.linalg.norm(np.diff(jp[:, :3], axis=0), axis=1).sum()
    assert np.abs(tp[:, :3] - jp[:, :3]).max() < 0.01 * path
    assert np.abs(np.abs(tp[:, 3:]) - np.abs(jp[:, 3:])).max() < 0.01
    ate_j = ate_rmse(jp[:, :3], gt[:, :3])
    ate_t = ate_rmse(tp[:, :3], gt[:, :3])
    assert abs(ate_t - ate_j) < 0.05 * ate_j, (ate_t, ate_j)
