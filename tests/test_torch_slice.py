"""Port parity for the whole slice: the JAX DPVO against the port's
DPVO(device="cpu") on the tiny configuration of test_tracking_e2e.py
(tiny_synth.npz, f32, 48x64, 24 frames), with the JAX run's own random
draws injected into the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_tpu.eval import ate_rmse
from dpvo_tpu.runtime import DPVO as JDPVO
from dpvo_tpu.lie import se3 as jse3
from dpvo_tpu.utils.synthetic import PlaneScene
from dpvo_tpu_torch.config import Config as TConfig
from dpvo_tpu_torch.runtime.dpvo import DPVO as TDPVO
from test_torch_models import jax_params_from_npz
from test_tracking_e2e import FIXTURE, HT, WD, tiny_cfg
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)


N_FRAMES = 24


@pytest.fixture(scope="module")
def runs():
    # tstep 0.3 keeps the tracking well conditioned: at 0.45 a change of the
    # correlation's summation order alone (the JAX package's impl='region'
    # vs 'gather') moves the trajectory by a large fraction of its length
    scene = PlaneScene(ht=HT, wd=WD, n_frames=N_FRAMES, depth=5.0, seed=9002, tstep=0.3,
                       rstep=0.008)
    frames = [scene.render(t) for t in range(N_FRAMES)]
    # one fused program instead of one per capacity bucket: padding only
    # (test_runtime.py::test_fused_edge_buckets_match_full_capacity)
    jcfg = tiny_cfg(E_BUCKETS="off")
    M = jcfg.PATCHES_PER_FRAME

    jslam = JDPVO(jcfg, jax_params_from_npz(FIXTURE), ht=HT, wd=WD, seed=0)
    draws, jinit = [], None
    for t in range(N_FRAMES):
        was, n0 = jslam.is_initialized, jslam.n
        jslam(t, frames[t], scene.intrinsics.copy())
        # the frame's row of state.patches holds its centroid at the centre
        # pixel and its ingest-time inverse depth (a probe-rejected frame
        # stays in row n, an accepted one is row n-1)
        row = n0 if (not was and jslam.n == n0) else jslam.n - 1
        p = np.asarray(jslam.state.patches[row * M:(row + 1) * M])
        draws.append((p[:, :2, 1, 1].copy(), p[:, 2, 1, 1].copy()))
        if jslam.is_initialized and not was:
            jinit = (t, np.asarray(jslam.state.poses[:jslam.n]),
                     np.asarray(jslam.state.dvec[:jslam.m]))
    jposes, jtimes = jslam.terminate()

    tcfg = TConfig(**{f: getattr(jcfg, f) for f in TConfig.__dataclass_fields__})
    tslam = TDPVO(tcfg, FIXTURE, ht=HT, wd=WD, device="cpu", draws=lambda f: draws[f])
    tinit = None
    for t in range(N_FRAMES):
        was = tslam.is_initialized
        tslam(t, frames[t], scene.intrinsics.copy())
        if tslam.is_initialized and not was:
            tinit = (t, tslam.state.poses[:tslam.n].numpy().copy(),
                     tslam.state.dvec[:tslam.m].numpy().copy())
    tposes, ttimes = tslam.terminate()
    gt = np.asarray(jse3.inv(jnp.asarray(scene.poses[:N_FRAMES])))
    return dict(j=(jslam, jinit, jposes, jtimes), t=(tslam, tinit, tposes, ttimes), gt=gt)


def test_same_initialization(runs):
    """At the init frame both have run the probe gate and 12 full updates
    (correlation, update operator, BA) from identical inputs. What differs
    is f32 summation order and, through it, bf16 rounding flips of the
    correlation features, which the 12 rounds amplify most in the least
    constrained inverse depths (measured: poses 7e-5, inverse depths 5e-4
    relative at the median, 2.8e-3 at worst)."""
    (_, jinit, _, _), (_, tinit, _, _) = runs["j"], runs["t"]
    assert jinit is not None and tinit is not None
    assert jinit[0] == tinit[0]
    np.testing.assert_allclose(tinit[1], jinit[1], atol=1e-3)
    assert np.median(np.abs(tinit[2] - jinit[2]) / jinit[2]) < 5e-3
    assert np.abs(tinit[2] - jinit[2]).max() < 0.02


def test_same_keyframes(runs):
    (jslam, _, _, jt), (tslam, _, _, tt) = runs["j"], runs["t"]
    assert tslam.is_initialized and jslam.is_initialized
    assert list(tslam.tstamps) == list(jslam.tstamps)
    assert sorted(tslam.delta) == sorted(jslam.delta)
    np.testing.assert_array_equal(tt, jt)


def test_same_trajectory(runs):
    """The 24-frame trajectories after terminate(): measured 0.003 apart on
    a 3.08-long monocular estimate, ATE 0.816 vs 0.817 against the ground
    truth. Held to 1% of the path pose by pose and the ATE within 5%."""
    (_, _, jp, _), (_, _, tp, _), gt = runs["j"], runs["t"], runs["gt"]
    assert tp.shape == jp.shape == (N_FRAMES, 7) and np.isfinite(tp).all()
    path = np.linalg.norm(np.diff(jp[:, :3], axis=0), axis=1).sum()
    assert np.abs(tp[:, :3] - jp[:, :3]).max() < 0.01 * path
    assert np.abs(np.abs(tp[:, 3:]) - np.abs(jp[:, 3:])).max() < 0.01
    ate_j = ate_rmse(jp[:, :3], gt[:, :3])
    ate_t = ate_rmse(tp[:, :3], gt[:, :3])
    assert abs(ate_t - ate_j) < 0.05 * ate_j, (ate_t, ate_j)


def test_small_parity_draws_are_well_conditioned(monkeypatch):
    """chip_smoke.py compares free-running trackers on the card and on the
    CPU with the tiny network, which amplifies rounding differences on most
    random draws of its 8 patches a frame. Its draws must be ones on which
    a change of rounding alone passes its check: here the correlation runs
    in f64 instead of f32, which rounds other features to other bf16
    values, as the card's kernel does with its own summation order."""
    import chip_smoke
    from dpvo_tpu_torch.ops.corr import corr_features_plain
    from dpvo_tpu_torch.runtime import steps

    tracker, frames, K = chip_smoke.small_path()
    ref = chip_smoke.free_run(tracker("cpu"), frames, K)
    monkeypatch.setattr(steps, "corr_features", lambda g, f1, f2, c, i, j, v, radius=3:
                        corr_features_plain(g.double(), f1.double(), f2.double(), c.double(),
                                            i, j, v, radius))
    alt = chip_smoke.free_run(tracker("cpu"), frames, K)
    assert ref[0] is not None and len(ref[1]) >= 6  # initialized, culled and kept keyframes
    chip_smoke.check_free_runs(ref, alt, who="f64 correlation")
