"""Proximity loop closure and the oracle hook of the port against the JAX
package, on the CPU.

The port's oracle tracker runs scripts/lc_ab.py's configuration and noise
(0.25 px) on a 48-frame out-and-back trajectory at 128x160 (with exact
targets the global BA has nothing left to move), recording the state at
each loop-edge proposal and before and after each global-BA round. The JAX
functions then run from those same states: edges_loop must propose the
same (kk, jj), and DPVO._run_global_ba (gauge guard, global edge set,
sparse indices, two Gauss-Newton iterations) must move poses and inverse
depths as the port's did. A whole JAX tracker run of this trajectory is
compile-bound on the CPU and does not fit the file's budget, so each
global-BA round is compared from a shared state instead. The host
pieces (reduce_edges, global_edge_set, gt_targets) are compared on their
own.
"""

import copy
import os
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dpvo_tpu.eval import ate_rmse
from dpvo_tpu.runtime import DPVO as JDPVO
from dpvo_tpu.runtime.state import make_state as jmake_state
from dpvo_tpu.runtime.steps import StepFunctions as JSteps
from dpvo_tpu.runtime.topology import Topology as JTopology
from dpvo_tpu.slam import proximity as jprox
from dpvo_tpu.utils.synthetic import PlaneScene as JScene
from dpvo_tpu_torch.config import Config as TConfig
from dpvo_tpu_torch.lie import se3 as tse3
from dpvo_tpu_torch.runtime import dpvo as tdpvo_mod
from dpvo_tpu_torch.runtime.dpvo import DPVO as TDPVO
from dpvo_tpu_torch.runtime.topology import Topology as TTopology
from dpvo_tpu_torch.slam import proximity as tprox
from dpvo_tpu_torch.utils.synthetic import PlaneScene as TScene
from test_runtime import HT, WD, small_cfg
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from lc_ab import loop_trajectory as jax_loop_trajectory  # noqa: E402

N_FRAMES = 48
NOISE = 0.25  # oracle target noise, px at 1/4 resolution (lc_ab.py's default)
# scripts/lc_ab.py:run's configuration with LOOP_CLOSURE on
LC_KW = dict(BUFFER_SIZE=192, E_MAX=4096, E_INAC_MAX=8192, M_OPT_MAX=1024, MAX_EDGE_AGE=96,
             KEYFRAME_THRESH=0.0, GBA_POSES_MAX=256, GBA_DEPTHS_MAX=4096, GBA_EDGES_MAX=16384,
             GBA_KPAIRS_MAX=1 << 18, LOOP_CLOSURE=True, GLOBAL_OPT_FREQ=10,
             BACKEND_THRESH=64.0, E_BUCKETS="off")
# |port - JAX| after one global-BA round (two Gauss-Newton iterations over
# ~2-3.5k edges) from the same state, over the run's rounds: poses measured
# at most 7.5e-6 (the rounds move them by 5e-3 to 1.8e-2), inverse depths
# 5.4e-5 (moved by up to 2.5); the reductions' and the Cholesky's summation
# orders differ. Doubled.
ROUND_ATOL = dict(poses=1.5e-5, dvec=1.1e-4)
# rounds compared: the run's five and the first two of terminate
ROUNDS_COMPARED = 7
_STATE = ("poses", "patches", "dvec", "intrinsics", "target", "weight", "target_inac",
          "weight_inac")


def _tcfg(jcfg):
    return TConfig(**{f: getattr(jcfg, f) for f in TConfig.__dataclass_fields__})


def _snapshot(slam):
    return dict(state={f: getattr(slam.state, f).clone() for f in _STATE},
                topo=copy.deepcopy(slam.topo), n=slam.n, m=slam.m)


@pytest.fixture(scope="module")
def run():
    """The port's oracle tracker on lc_ab's configuration, with its loop-edge
    proposals and global-BA rounds recorded."""
    jcfg = small_cfg(**LC_KW)
    poses_gt = chip_smoke.loop_trajectory(N_FRAMES)
    scene = TScene(ht=HT, wd=WD, n_frames=N_FRAMES, depth=4.0, seed=5, poses=poses_gt)
    slam = TDPVO(_tcfg(jcfg), None, ht=HT, wd=WD, device="cpu", seed=1)
    slam.oracle = chip_smoke.scene_oracle(scene, NOISE, seed=78)
    slam._motion_probe = lambda: 1e9
    proposals, rounds = [], []
    real_loop, real_gba = tdpvo_mod.edges_loop, slam._run_global_ba

    def loop(s):
        snap = _snapshot(s)
        out = real_loop(s)
        proposals.append((snap, out))
        return out

    def gba():
        snap = _snapshot(slam)
        real_gba()
        rounds.append((snap, slam.state.poses.clone(), slam.state.dvec.clone()))

    tdpvo_mod.edges_loop = loop
    slam._run_global_ba = gba
    try:
        for t in range(N_FRAMES):
            slam(t, scene.render(t), scene.intrinsics.copy())
        in_run = sorted(slam.ran_global_ba)
        poses, _ = slam.terminate()
    finally:
        tdpvo_mod.edges_loop = real_loop
    return dict(jcfg=jcfg, slam=slam, poses=poses, in_run=in_run, proposals=proposals,
                rounds=rounds, poses_gt=poses_gt)


def test_loop_trajectory_is_lc_abs():
    """chip_smoke.py's copy of lc_ab's trajectory, and its phase 5 cell on
    this file's configuration."""
    np.testing.assert_array_equal(chip_smoke.loop_trajectory(N_FRAMES),
                                  jax_loop_trajectory(N_FRAMES))
    assert TConfig(**chip_smoke.LC_SMALL_CFG) == _tcfg(small_cfg(**LC_KW)).replace(
        E_BUCKETS=TConfig.E_BUCKETS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reduce_edges_matches_jax(seed):
    """The NMS on random candidate pairs (ties, pairs closer than
    MIN_SEPARATION, flows past 1000): the same pairs in the same order."""
    rng = np.random.default_rng(seed)
    n = 400
    ii = rng.integers(0, 60, n)
    jj = ii + rng.integers(0, 60, n)
    flow = np.round(rng.uniform(0, 1200, n), 0)
    for kw in (dict(max_num_edges=1000, nms=1), dict(max_num_edges=7, nms=2)):
        want = jprox.reduce_edges(flow, ii, jj, **kw)
        got = tprox.reduce_edges(flow, ii, jj, **kw)
        assert len(got) > 0
        np.testing.assert_array_equal(got, want)


def test_edges_loop_matches_jax(run):
    """Every proposal of the port's run, repeated by the JAX edges_loop from
    the same state: the same loop edges (kk, jj)."""
    jcfg = run["jcfg"]
    found = 0
    for snap, (kk, jj) in run["proposals"]:
        st = SimpleNamespace(**{f: jnp.asarray(v.numpy()) for f, v in snap["state"].items()})
        jkk, jjj = jprox.edges_loop(SimpleNamespace(cfg=jcfg, n=snap["n"], state=st))
        np.testing.assert_array_equal(kk, jkk)
        np.testing.assert_array_equal(jj, jjj)
        found += len(kk) > 0
    assert found >= 2 and len(run["proposals"]) > found  # batches, and empty proposals


def test_global_edge_set_matches_jax():
    """After appends and stored removals that wrap the inactive ring: the
    JAX edge set's live part (inactive ring from its oldest slot, then the
    active edges), the same ring slots and depth variables."""
    jcfg = small_cfg(E_MAX=512, E_INAC_MAX=300, GBA_EDGES_MAX=1024, GBA_DEPTHS_MAX=512)
    rng = np.random.default_rng(4)
    topos = [JTopology(jcfg), TTopology(_tcfg(jcfg))]
    for step in range(14):
        kk = rng.integers(0, 8 * (step + 2), 60)
        jj = rng.integers(0, step + 2, 60)
        rm = rng.uniform(size=len(topos[0].ii) + 60) < 0.4
        for topo in topos:
            topo.add_frame()
            topo.append(kk, jj)
            topo.remove(rm, store=True)
    assert topos[1].inac_count == jcfg.E_INAC_MAX and topos[1].inac_head > 0  # wrapped
    (jes, jpos, jn), (tes, tpos, tn) = (t.global_edge_set() for t in topos)
    E = jes["count"]
    assert (tn, tes["count"], tes["n_depths"]) == (jn, E, jes["n_depths"])
    np.testing.assert_array_equal(tpos, jpos)
    for k in ("ii", "jj", "kk", "kd"):
        np.testing.assert_array_equal(tes[k], jes[k][:E])
    np.testing.assert_array_equal(tes["dense2patch"], jes["dense2patch"][:jes["n_depths"]])


def test_gt_targets_matches_jax():
    """The oracle's reprojection targets of random patches into random frames."""
    poses = chip_smoke.loop_trajectory(20)
    jscene = JScene(ht=HT, wd=WD, n_frames=20, depth=4.0, seed=5, poses=poses)
    tscene = TScene(ht=HT, wd=WD, n_frames=20, depth=4.0, seed=5, poses=poses)
    rng = np.random.default_rng(2)
    xy = np.stack([rng.uniform(1, WD / 4 - 1, 160), rng.uniform(1, HT / 4 - 1, 160)], -1)
    kk = rng.integers(0, 160, 300)
    ii, jj = kk // 8, rng.integers(0, 20, 300)
    want = jscene.gt_targets(poses, xy.astype(np.float32), ii, jj, kk)
    got = tscene.gt_targets(poses, xy.astype(np.float32), ii, jj, kk)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_global_ba_rounds_match_jax(run):
    """Each global-BA round of the port's run, repeated by the JAX tracker's
    _run_global_ba from the same state and topology: the same poses and
    inverse depths within ROUND_ATOL."""
    jcfg = run["jcfg"]
    # the JAX tracker's members that _run_global_ba reads (its networks,
    # which the round does not use, are left out: their random init costs
    # more than the rounds)
    jslam = JDPVO.__new__(JDPVO)
    jslam.cfg, jslam.params, jslam.ran_global_ba = jcfg, None, set()
    jslam.steps = JSteps(jcfg, HT, WD)
    jslam.state = jmake_state(jcfg, HT, WD)
    worst = dict(poses=0.0, dvec=0.0)
    for snap, tposes, tdvec in run["rounds"][:ROUNDS_COMPARED]:
        jslam.state = jslam.state._replace(
            **{f: jnp.asarray(v.numpy()) for f, v in snap["state"].items()})
        jtopo = JTopology(jcfg)
        for a in ("ii", "jj", "kk", "ii_inac", "jj_inac", "kk_inac", "inac_head",
                  "inac_count", "n", "m"):
            setattr(jtopo, a, copy.deepcopy(getattr(snap["topo"], a)))
        jslam.topo = jtopo
        jslam._run_global_ba()
        m = snap["m"]
        d = dict(poses=np.abs(np.asarray(jslam.state.poses) - tposes.numpy()).max(),
                 dvec=np.abs(np.asarray(jslam.state.dvec)[:m] - tdvec.numpy()[:m]).max())
        for k in worst:
            worst[k] = max(worst[k], d[k])
        moved = np.abs(tposes.numpy() - snap["state"]["poses"].numpy()).max()
        assert moved > 100 * ROUND_ATOL["poses"]  # the round moved the poses
    assert worst["poses"] < ROUND_ATOL["poses"] and worst["dvec"] < ROUND_ATOL["dvec"], worst


def test_oracle_loop_closure_tracker(run):
    """The port's tracker with the oracle and LOOP_CLOSURE: loop edges are
    proposed and appended, a global BA runs at most once per frame count
    while they are active (and in every round of terminate), and the
    trajectory is the ground truth's up to the monocular gauge and the
    oracle's noise (ATE measured at 0.94% of the path)."""
    slam, poses = run["slam"], run["poses"]
    batches = [out for _, out in run["proposals"] if len(out[0])]
    assert len(batches) >= 2 and slam.last_global_ba == 43
    assert run["in_run"] == [33, 43, 44, 45, 46]
    assert len(run["rounds"]) == len(run["in_run"]) + 12  # terminate: every round
    assert poses.shape == (N_FRAMES, 7) and np.isfinite(poses).all()
    gt_c2w = tse3.inv(torch.as_tensor(run["poses_gt"])).numpy()
    path = np.linalg.norm(np.diff(gt_c2w[:, :3], axis=0), axis=1).sum()
    assert ate_rmse(poses[:, :3], gt_c2w[:, :3], align_scale=True) < 0.02 * path


def _oracle_run(scene, cfg, n_frames):
    slam = TDPVO(cfg, None, ht=HT, wd=WD, device="cpu", seed=1)
    slam.oracle = chip_smoke.scene_oracle(scene)
    slam._motion_probe = lambda: 1e9  # the oracle needs no network-based init gate
    pending = []
    for t in range(n_frames):
        slam(t, scene.render(t), scene.intrinsics.copy())
        pending.append(len(slam._inflights))
    return slam, pending


def test_oracle_recovers_trajectory():
    """tests/test_runtime.py::test_oracle_recovers_trajectory on the port:
    ground-truth targets through the sliding-window BA recover the
    trajectory within 5% of the motion; every frame takes the non-steady
    branch, whose keyframe decision is made inline (none pending)."""
    scene = TScene(ht=HT, wd=WD, n_frames=24, depth=4.0, seed=3)
    slam, pending = _oracle_run(scene, _tcfg(small_cfg()), 20)
    poses, _ = slam.terminate()
    assert poses.shape == (20, 7) and pending == [0] * 20
    gt_c2w = tse3.inv(torch.as_tensor(scene.poses[:20])).numpy()
    motion = np.linalg.norm(np.diff(gt_c2w[:, :3], axis=0), axis=1).sum()
    assert motion > 0.3
    assert ate_rmse(poses[:, :3], gt_c2w[:, :3], align_scale=True) < 0.05 * motion


def test_oracle_with_keyframe_culling():
    """tests/test_runtime.py::test_oracle_with_keyframe_culling on the port:
    a slow segment culls keyframes, and the bookkeeping and the interpolated
    trajectory stay complete."""
    slow = TScene(ht=HT, wd=WD, n_frames=20, depth=4.0, seed=5, tstep=0.012, rstep=0.001)
    slam, _ = _oracle_run(slow, _tcfg(small_cfg(KEYFRAME_THRESH=3.0)), 20)
    kept = slam.n
    poses, _ = slam.terminate()
    assert poses.shape == (20, 7) and np.isfinite(poses).all()
    assert kept < 20 and len(slam.delta) == 20 - kept


def test_depth_variables_past_m_opt_max():
    """Loop edges on old patches can hold more than M_OPT_MAX depth
    variables in a non-steady round: the JAX edge set asserts there, the
    port's sizes them by the live count. The steady frame keeps the JAX
    fused frame's guard: edges on the oldest patches past M_OPT_MAX are
    retired into the inactive store before its edges are appended."""
    jcfg = small_cfg(M_OPT_MAX=32)
    kk = np.arange(40) * 2
    jj = np.full(40, 9)
    jtopo, ttopo = JTopology(jcfg), TTopology(_tcfg(jcfg))
    for topo in (jtopo, ttopo):
        topo.n, topo.m = 10, 80
        topo.append(kk, jj)
    with pytest.raises(AssertionError, match="M_OPT_MAX"):
        jtopo.edge_set()
    es = ttopo.edge_set()
    assert es.n_depths == 40 and len(es.dense2patch) == 40
    np.testing.assert_array_equal(es.dense2patch, kk)

    slam = TDPVO(_tcfg(jcfg), None, ht=HT, wd=WD, device="cpu")
    slam.topo = ttopo
    slam._cap_depths(np.array([78, 79]))  # 41 distinct with the new ones
    assert len(np.unique(slam.topo.kk)) + 1 == jcfg.M_OPT_MAX  # 31 old + 1 new = 32
    assert slam.topo.inac_count == 9 and slam.topo.kk.min() == 18  # 0, 2, .., 16 retired
