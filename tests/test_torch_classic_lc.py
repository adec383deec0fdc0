"""Classic loop closure of the port (retrieval, triplet BA, RANSAC-Umeyama,
the chain to the Sim(3) PGO, the tracker's hooks) against the JAX package,
on the CPU: the same numpy inputs through the JAX function and its port.
The PGO itself is held to JAX's in tests/test_torch_sim3.py. The retrieval
tests need OpenCV (ORB), as the JAX package's do.
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dpvo_tpu.eval import ate as jate
from dpvo_tpu.lie import se3 as jse3
from dpvo_tpu.slam import long_term as JLT
from dpvo_tpu.slam import pgo as jpgo
from dpvo_tpu.slam import retrieval as JR
from dpvo_tpu_torch.config import Config as TConfig
from dpvo_tpu_torch.eval import ate as tate
from dpvo_tpu_torch.lie import se3 as tse3
from dpvo_tpu_torch.lie import sim3 as tsim3
from dpvo_tpu_torch.slam import long_term as TLT
from dpvo_tpu_torch.slam import pgo as tpgo
from dpvo_tpu_torch.slam import retrieval as TR
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)


# ---------------- geometry ----------------

def _ransac_data():
    """tests/test_loop_closure.py:test_ransac_umeyama_with_outliers's data."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((120, 3))
    th = 0.4
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    Y = 1.4 * X @ R.T + np.array([0.5, -0.2, 1.0])
    Y[::4] += rng.standard_normal((30, 3)) * 5
    return X, Y


def test_ransac_umeyama_matches_jax():
    """The same numpy code and seed: the same fit and inliers, exactly."""
    X, Y = _ransac_data()
    got, want = TLT.ransac_umeyama(X, Y), JLT.ransac_umeyama(X, Y)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert abs(got[2] - 1.4) < 0.02 and got[3].sum() >= 80


def test_umeyama_and_ate_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((50, 3))
    y = 0.7 * x @ np.linalg.qr(rng.standard_normal((3, 3)))[0].T + 0.1 * rng.standard_normal(
        (50, 3))
    for a, b in zip(tate.umeyama_alignment(x.T, y.T), jate.umeyama_alignment(x.T, y.T)):
        np.testing.assert_array_equal(a, b)
    for scale in (True, False):
        assert tate.ate_rmse(x, y, scale) == jate.ate_rmse(x, y, scale)


def _triplet(seed=5):
    """A keyframe triplet looking at a plane ~4 m away: 512 keypoint slots,
    400 of them filled, each matched in one or both neighbours (0.3 px
    noise), a few gross mismatches; full-resolution intrinsics."""
    rng = np.random.default_rng(seed)
    intr = np.array([256.0, 256.0, 160.0, 120.0], np.float32)
    xi = np.array([[-0.15, 0.01, 0.0, 0.0, 0.01, 0.0], [0.0] * 6,
                   [0.15, -0.01, 0.02, 0.0, -0.01, 0.0]], np.float32)
    poses = np.asarray(jse3.exp(jnp.asarray(xi)))
    n, live = JLT.N_LC, 400
    xy = np.zeros((n, 2), np.float32)
    xy[:live] = rng.uniform([10, 10], [310, 230], (live, 2))
    depth = rng.uniform(3.0, 5.0, n)
    X = np.stack([(xy[:, 0] - intr[2]) / intr[0] * depth, (xy[:, 1] - intr[3]) / intr[1] * depth,
                  depth], 1)
    targets = np.zeros((2, n, 2), np.float32)
    for e, f in enumerate((0, 2)):
        Xw = np.asarray(jse3.act(jse3.inv(jnp.asarray(poses[1])), jnp.asarray(X, jnp.float32)))
        Xc = np.asarray(jse3.act(jnp.asarray(poses[f]), jnp.asarray(Xw)))
        targets[e] = np.stack([intr[0] * Xc[:, 0] / Xc[:, 2] + intr[2],
                               intr[1] * Xc[:, 1] / Xc[:, 2] + intr[3]], 1)
    targets += 0.3 * rng.standard_normal(targets.shape).astype(np.float32)
    tvalid = np.zeros((2, n), bool)
    tvalid[:, :live] = rng.uniform(size=(2, live)) < 0.8
    bad = rng.choice(live, 10, replace=False)
    targets[0, bad] += 25.0
    return poses, intr, xy, targets, tvalid


def test_triplet_structure_ba_matches_jax():
    """The structure-only triplet BA (6 iterations, no free pose) on the same
    triplet: the same keep mask, the kept points within 1e-4 m (measured
    8.8e-6; the points sit 3-5 m away), finite everywhere."""
    poses, intr, xy, targets, tvalid = _triplet()
    Xj, kj = JLT._triplet_structure_ba(poses, intr, xy, targets, tvalid, 0.25)
    Xt, kt = TLT._triplet_structure_ba(poses, intr, xy, targets, tvalid, 0.25)
    np.testing.assert_array_equal(kt, kj)
    assert 300 < kt.sum() < 400 and np.isfinite(Xt).all()
    assert np.abs(Xt[kt] - Xj[kj]).max() <= 1e-4


def test_schur_solve_without_free_poses_is_a_zero_pose_step():
    """The triplet BA frees no pose (nfree = 0 at W = 4): the reduced system
    is the identity with a zero right-hand side, so the pose step is zero
    exactly and the depth step is u / (C + lambda)."""
    from dpvo_tpu_torch.ba.solver import schur_solve

    g = torch.Generator().manual_seed(8)
    B6, E6 = torch.randn(24, 24, generator=g), torch.randn(24, 512, generator=g)
    C, u, v6 = torch.rand(512, generator=g) + 0.5, torch.randn(512, generator=g), torch.randn(24)
    dX, dZ = schur_solve(B6 @ B6.T, E6, C, u, v6, 1e-3, 0, W=4)
    assert torch.equal(dX, torch.zeros(4, 6))
    torch.testing.assert_close(dZ, u / (C + 1e-3))


def test_apply_pgo_matches_jax():
    """steps._apply_pgo on tests/test_loop_closure.py:
    test_apply_pgo_rescales_depths's state, against StepFunctions.apply_pgo."""
    from dpvo_tpu.config import Config as JConfig
    from dpvo_tpu.runtime.state import make_state as jmake_state
    from dpvo_tpu.runtime.steps import StepFunctions as JSteps
    from dpvo_tpu_torch.runtime.state import make_state as tmake_state
    from dpvo_tpu_torch.runtime.steps import StepFunctions as TSteps

    kw = dict(BUFFER_SIZE=16, E_MAX=256, E_INAC_MAX=256, PMEM=4, MEM=4, M_OPT_MAX=128,
              GBA_POSES_MAX=16, GBA_DEPTHS_MAX=256, GBA_EDGES_MAX=512)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    N, M = tcfg.BUFFER_SIZE, tcfg.PATCHES_PER_FRAME
    rng = np.random.default_rng(4)
    poses_new = np.tile(np.array([1, 2, 3, 0, 0, 0, 1.0], np.float32), (N, 1))
    poses_new[:, :3] += rng.standard_normal((N, 3)).astype(np.float32)
    scales = rng.uniform(0.5, 2.0, N).astype(np.float32)
    dvec = rng.uniform(0.1, 1.0, N * M).astype(np.float32)

    js = jmake_state(jcfg, 64, 96)
    js = js._replace(dvec=jnp.asarray(dvec))
    js = JSteps(jcfg, 64, 96).apply_pgo(js, jnp.asarray(poses_new), jnp.asarray(scales),
                                        jnp.int32(4))
    ts = tmake_state(tcfg, 64, 96, "cpu")
    ts.dvec.copy_(torch.as_tensor(dvec))
    TSteps(tcfg, None, torch.device("cpu"))._apply_pgo(ts, torch.as_tensor(poses_new),
                                                       torch.as_tensor(scales), 4)
    np.testing.assert_array_equal(ts.dvec.numpy(), np.asarray(js.dvec))
    np.testing.assert_array_equal(ts.poses.numpy(), np.asarray(js.poses))


# ---------------- retrieval ----------------

def _textured_image(cv2, seed, shift=0):
    """tests/test_loop_closure.py:textured_image."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.uniform(0, 255, (280, 360, 3)).astype(np.uint8), (5, 5), 1.2)
    big = cv2.resize(base, (720, 560), interpolation=cv2.INTER_CUBIC)
    return cv2.warpAffine(big, np.float32([[1, 0, shift], [0, 1, 0]]), (640, 480))


def _revisit_images(cv2, n_mid=57):
    """Scene A (3 frames), n_mid distinct scenes, scene A again (4 frames)."""
    return ([_textured_image(cv2, 0, k) for k in range(3)]
            + [_textured_image(cv2, 100 + k) for k in range(3, 3 + n_mid)]
            + [_textured_image(cv2, 0, k) for k in range(4)])


def test_retrieval_matches_jax():
    """tests/test_loop_closure.py:test_retrieval_query_and_loop_detection's
    sequence through both classes (OpenCV's ORB on both sides): the same
    keypoints, scores (every query, exactly), loop candidate and matches."""
    cv2 = pytest.importorskip("cv2")
    images = _revisit_images(cv2)
    rj, rt = JR.OrbRetrieval(thresh=0.02, window=2), TR.OrbRetrieval(thresh=0.02, window=2)
    hits = []
    for k, image in enumerate(images):
        rj.insert_image(image)
        rt.insert_image(image)
        np.testing.assert_array_equal(rt.descs[k], rj.descs[k])
        np.testing.assert_array_equal(rt.kps[k], rj.kps[k])
        assert rt.query(k) == rj.query(k)
        if k >= 60:
            got, want = rt.detect_loop(k), rj.detect_loop(k)
            assert got == want
            hits += [got] if got else []
    assert hits and hits[0][0] >= 60 and hits[0][1] <= 2
    for a, b in zip(rt.match(60, 0), rj.match(60, 0)):
        np.testing.assert_array_equal(a, b)
    assert len(rt.match(60, 0)[0]) > 50


def _descriptors(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, 32), dtype=np.uint8)


def test_native_matches_plain():
    """The native core against its numpy version: every frame's score of a
    query (f32 of a double mean: to 1e-6), and the k = 2 hamming search
    (best index, best and second distance: equal), with exact and near
    copies planted, an empty frame and a one-row frame."""
    descs = [_descriptors(s, n) for s, n in ((1, 40), (2, 70), (3, 0), (4, 1), (5, 120))]
    q = _descriptors(6, 50)
    q[:5] = descs[1][10:15]
    q[5:10] = descs[4][:5] ^ np.uint8(3)
    r = TR.OrbRetrieval(detect=lambda image: None)
    for d in descs:
        r.lib.retrieval_insert(r.db, d.tobytes(), len(d))
    import ctypes

    for max_index in (4, 2):
        scores = (ctypes.c_float * len(descs))()
        r.lib.retrieval_query(r.db, q.tobytes(), len(q), max_index, scores)
        got = np.frombuffer(scores, np.float32, len(descs))
        np.testing.assert_allclose(got, TR.score_plain(q, descs, max_index), atol=1e-6)
    for b in (descs[1], descs[3], descs[4]):
        out = [(ctypes.c_int32 * len(q))() for _ in range(3)]
        r.lib.retrieval_match(q.tobytes(), len(q), b.tobytes(), len(b), *out)
        for a, p in zip(out, TR.match_plain(q, b)):
            np.testing.assert_array_equal(np.frombuffer(a, np.int32, len(q)), p)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A native core that does not compile raises; nothing falls back."""
    src = tmp_path / "retrieval.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(TR, "SOURCE", src)
    monkeypatch.setattr(TR, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(TR, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TR.OrbRetrieval(detect=lambda image: None)


# ---------------- the chain ----------------

LC_CFG = dict(PATCHES_PER_FRAME=8, LOOP_RETR_THRESH=0.95, LOOP_CLOSE_WINDOW_SIZE=3)


def test_bookkeeping_matches_jax(monkeypatch):
    """Both classes (asynchronous=False) fed the same (image, n) and
    keyframe(k) calls: the same retrieval frames, closures (renumbered by
    the removals), hits and candidate packages."""
    cv2 = pytest.importorskip("cv2")
    from dpvo_tpu.config import Config as JConfig

    for mod in (JR, TR):
        monkeypatch.setattr(mod, "RADIUS", 12)
    images = _revisit_images(cv2, n_mid=16)
    # a threshold between the distinct scenes' scores and the revisits'
    kw = dict(LC_CFG, LOOP_RETR_THRESH=0.8, LOOP_CLOSE_WINDOW_SIZE=2)
    lj = JLT.LongTermLoopClosure(JConfig(**kw), None, asynchronous=False)
    lt = TLT.LongTermLoopClosure(TConfig(**kw), None, asynchronous=False)
    n = 0
    for k, image in enumerate(images):
        for lc in (lj, lt):
            lc(image, n)
        n += 1
        if k in (6, 9, 21):  # cull keyframe n - 3, as a tracker would
            for lc in (lj, lt):
                lc.keyframe(n - 3)
            n -= 1
        rj, rt = lj.retrieval, lt.retrieval
        assert rt.n_frames() == rj.n_frames() == n
        assert rt.closures == rj.closures and rt.hits == rj.hits
    packages = [list(lc._cands.queue) for lc in (lj, lt)]
    assert len(packages[0]) == len(packages[1]) >= 1 and lt.retrieval.closures
    for pj, pt in zip(*packages):
        assert (pt["gen"], pt["q"], pt["rr"]) == (pj["gen"], pj["q"], pj["rr"])
        for a, b in zip(pt["m_qr"], pj["m_qr"]):
            np.testing.assert_array_equal(a, b)
        for key in ("nbs_q", "nbs_r"):
            assert [nb for nb, _ in pt[key]] == [nb for nb, _ in pj[key]]
    lt.close()


def test_package_renumbered_past_removals():
    pkg = dict(gen=0, q=40, rr=5, m_qr=None, nbs_q=[(39, "a")], nbs_r=[(4, "b"), (6, "c")])
    out = TLT._remap(pkg, [20, 30])
    assert (out["q"], out["rr"], out["nbs_q"], out["nbs_r"]) == (38, 5, [(37, "a")],
                                                                 [(4, "b"), (6, "c")])
    assert TLT._remap(pkg, [2]) == dict(pkg, q=39, rr=4, nbs_q=[(38, "a")],
                                        nbs_r=[(3, "b"), (5, "c")])
    assert TLT._remap(pkg, [39]) is None and TLT._remap(pkg, [6]) is None


def _loop_scene(ht=128, wd=160, n=34):
    """tests/test_loop_closure.py:test_classic_lc_end_to_end's scene: a
    circular path of period 28 over sharp 8 px blocks."""
    from dpvo_tpu_torch.utils.synthetic import PlaneScene

    scene = PlaneScene(ht=ht, wd=wd, n_frames=n, depth=4.0, seed=7)
    trng = np.random.default_rng(11)
    scene.tex = np.kron(trng.integers(0, 255, (128, 128, 3)).astype(np.uint8),
                        np.ones((8, 8, 1), np.uint8))
    th = 2 * np.pi * np.arange(n) / 28
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0], np.float32), (n, 1))
    poses[:, :3] = -np.stack([0.35 * np.sin(th), 0.35 * (1 - np.cos(th)), np.zeros(n)], -1)
    scene.poses = poses
    return scene, [scene.render(t) for t in range(n)]


def _fake_tracker(poses, intr, dvec, torch_state):
    """What attempt_loop_closure reads of a tracker, and where its
    correction lands."""
    to = (lambda x: torch.as_tensor(x)) if torch_state else (lambda x: x)
    got = {}
    slam = SimpleNamespace(n=len(poses), poses_np=lambda: poses.copy(), device=torch.device("cpu"),
                           state=SimpleNamespace(intrinsics=to(intr), dvec=to(dvec)),
                           apply_pgo_result=lambda c: got.setdefault("corrected", c))
    return slam, got


def test_chain_matches_jax(monkeypatch):
    """One candidate package (the port's retrieval on chip_smoke.
    SceneKeypoints of the end-to-end test's scene) fed to both packages'
    attempt_loop_closure (asynchronous=False), each over a fake tracker with
    the same drifted poses, intrinsics and inverse depths: the same Sim(3)
    constant C (within 1e-5, measured 1.9e-6) and the same corrected poses
    (within 1e-5, measured 1.6e-6)."""
    pytest.importorskip("cv2")  # the JAX class builds OpenCV's ORB
    from dpvo_tpu.config import Config as JConfig

    monkeypatch.setattr(TR, "RADIUS", 12)
    scene, frames = _loop_scene(n=40)  # the PGO at n = 40, as the tests above
    lt = TLT.LongTermLoopClosure(TConfig(**LC_CFG), None, asynchronous=False,
                                 detect=chip_smoke.SceneKeypoints(scene, frames, per_view=200))
    for t, image in enumerate(frames):
        lt(image, t)
    pkg = lt._cands.get_nowait()  # the first revisit (a second one follows)
    lt._cands.queue.clear()
    assert pkg["rr"] < pkg["q"] - 12 and len(pkg["m_qr"][2]) >= TLT.MIN_INLIERS

    # the ground truth with a growing SE(3) drift (rotation and translation)
    n = len(frames)
    drift = np.stack([np.asarray(jse3.exp(jnp.asarray(
        [0.02 * a, -0.01 * a, 0.005 * a, 0.0, 0.004 * a, 0.002 * a], jnp.float32)))
        for a in np.arange(n)])
    poses = np.asarray(jse3.mul(jnp.asarray(drift), jnp.asarray(scene.poses)))
    intr = np.tile(scene.intrinsics / 4.0, (n, 1)).astype(np.float32)
    dvec = np.full(n * 8, 0.25, np.float32)

    caught = {}
    for name, mod in (("jax", jpgo), ("port", tpgo)):
        real = mod.apply_loop_closure

        def wrap(*a, real=real, name=name, **k):
            caught[name] = a[1]
            return real(*a, **k)

        monkeypatch.setattr(mod, "apply_loop_closure", wrap)
    js, jgot = _fake_tracker(poses, intr, dvec, torch_state=False)
    ts, tgot = _fake_tracker(poses, intr, dvec, torch_state=True)
    lj = JLT.LongTermLoopClosure(JConfig(**LC_CFG), js, asynchronous=False)
    lt.slam = ts
    for lc, slam in ((lj, js), (lt, ts)):
        lc._cands.put(copy.deepcopy(pkg))
        lc.attempt_loop_closure(slam.n)
        assert lc.lc_callback(wait=True)
    assert np.abs(caught["port"] - caught["jax"]).max() <= 1e-5
    assert tgot["corrected"].shape == jgot["corrected"].shape == (pkg["q"] + 1, 8)
    assert np.abs(tgot["corrected"] - jgot["corrected"]).max() <= 1e-5
    lj.terminate(js.n)
    lt.close()


def _jax_oracle_draws(seed, n_frames, M, h, w):
    """The patch draws of the JAX tracker DPVO(seed=seed) when every frame
    takes its non-fused branch (an oracle set, no probe rejection): per frame
    one key for patchify's centroids and one for ingest's random depths,
    split from PRNGKey(seed) in turn."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(n_frames):
        rng, kp = jax.random.split(rng)
        rng, ki = jax.random.split(rng)
        kx, ky = jax.random.split(kp)
        x = jax.random.randint(kx, (1, M), 1, w - 1)[0]
        y = jax.random.randint(ky, (1, M), 1, h - 1)[0]
        out.append((np.stack([x, y], -1).astype(np.float32),
                    np.asarray(jax.random.uniform(ki, (M,)))))
    return out


def test_classic_lc_end_to_end(monkeypatch):
    """tests/test_loop_closure.py:test_classic_lc_end_to_end on the port:
    the port's oracle tracker with the JAX test's patch draws (its tracker's
    PRNG sequence, replayed), the retrieval worker hashing every frame,
    progressive Sim(3) drift injected into the keyframes, then terminate:
    the loop gap at least halves and the ATE falls. (How far the gap falls
    depends on the tracker's patch draws, so the analog replays the JAX
    test's rather than drawing its own.)"""
    pytest.importorskip("cv2")
    from dpvo_tpu_torch.runtime.dpvo import DPVO

    monkeypatch.setattr(TR, "RADIUS", 12)
    monkeypatch.setattr(TLT, "MIN_INLIERS", 12)
    scene, frames = _loop_scene()
    n = len(frames)
    cfg = TConfig(**{**chip_smoke.SMALL_CFG, "KEYFRAME_THRESH": 0.0, "LOOP_RETR_THRESH": 0.95})
    draws = _jax_oracle_draws(1, n, cfg.PATCHES_PER_FRAME, 128 // 4, 160 // 4)
    slam = DPVO(cfg, None, 128, 160, device="cpu", seed=1, draws=lambda f: draws[f])
    slam.oracle = chip_smoke.scene_oracle(scene)
    slam._motion_probe = lambda: 1e9
    lc = TLT.LongTermLoopClosure(cfg, slam, asynchronous=True)
    for t, image in enumerate(frames):
        lc(image, slam.n)
        slam(t, image, scene.intrinsics.copy())
    lc._ops.join()
    assert not lc._cands.empty(), "revisit not detected by the worker"

    m = slam.n
    kf = slam.poses_np()
    span = np.linalg.norm(kf[:, :3] - kf[:, :3].mean(0), axis=1).mean()
    drifted = np.zeros((m, 8), np.float32)
    for i in range(m):
        a = i / (m - 1)
        D = torch.tensor([span * a, 0.4 * span * a, 0.0, 0.0, 0.0, np.sin(0.02 * a),
                          np.cos(0.02 * a), 1.0 + 0.25 * a], dtype=torch.float32)
        drifted[i] = tsim3.mul(D, tsim3.from_se3(torch.as_tensor(kf[i]))).numpy()
    slam.apply_pgo_result(drifted)
    gt_c = tse3.inv(torch.as_tensor(scene.poses[:m])).numpy()[:, :3]

    def metrics():
        est_c = tse3.inv(torch.as_tensor(slam.poses_np())).numpy()[:, :3]
        spread = np.linalg.norm(est_c - est_c.mean(0), axis=1).mean()
        gap = np.linalg.norm(est_c[28:m] - est_c[0:m - 28], axis=1).mean()
        return tate.ate_rmse(est_c, gt_c), gap / max(spread, 1e-9)

    e_before, gap_before = metrics()
    lc.terminate(slam.n)
    e_after, gap_after = metrics()
    assert lc.applied, "no loop closure was applied"
    assert gap_after < 0.5 * gap_before, (gap_before, gap_after)
    assert e_after < e_before, (e_before, e_after)


@pytest.mark.parametrize("asynchronous", [False, True])
def test_classic_lc_through_the_tracker(asynchronous):
    """CLASSIC_LOOP_CLOSURE on the tracker's own hooks (hashing before each
    frame, attempt + callback after, terminate's flush), OpenCV's ORB on the
    end-to-end test's scene with RADIUS 12: a correction is applied and the
    trajectory stays finite, inline and with the worker thread and the PGO
    executor; terminate stops both."""
    pytest.importorskip("cv2")
    from dpvo_tpu_torch.runtime.dpvo import DPVO

    scene, frames = _loop_scene()
    cfg = TConfig(**{**chip_smoke.SMALL_CFG, "KEYFRAME_THRESH": 0.0, "LOOP_RETR_THRESH": 0.95,
                     "CLASSIC_LOOP_CLOSURE": True})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TR, "RADIUS", 12)
        mp.setattr(TLT, "MIN_INLIERS", 12)
        slam = DPVO(cfg, None, 128, 160, device="cpu", seed=1)
        if not asynchronous:
            slam.long_term_lc.close()
            slam.long_term_lc = TLT.LongTermLoopClosure(cfg, slam, asynchronous=False)
        lc = slam.long_term_lc
        slam.oracle = chip_smoke.scene_oracle(scene)
        slam._motion_probe = lambda: 1e9
        for t, image in enumerate(frames):
            slam(t, image, scene.intrinsics.copy())
        poses, _ = slam.terminate()
    assert lc.applied and np.isfinite(poses).all() and poses.shape == (len(frames), 7)
    assert lc._worker is None or not lc._worker.is_alive()


def test_failures_propagate():
    """A retrieval-worker error is raised at the next attempt; a PGO that
    raised raises at its callback; a non-finite PGO result is skipped."""
    from concurrent.futures import Future

    slam, got = _fake_tracker(np.zeros((4, 7), np.float32), np.zeros((4, 4), np.float32),
                              np.ones(32, np.float32), torch_state=True)

    def broken(image):
        raise ValueError("detector broke")

    lc = TLT.LongTermLoopClosure(TConfig(**LC_CFG), slam, asynchronous=True, detect=broken)
    lc(np.zeros((8, 8, 3), np.uint8), 0)
    lc._ops.join()
    with pytest.raises(RuntimeError, match="worker failed"):
        lc.attempt_loop_closure(4)
    lc.close()

    lc = TLT.LongTermLoopClosure(TConfig(**LC_CFG), slam, asynchronous=False,
                                 detect=lambda image: None)
    lc._pgo_future, lc._pgo_pair = Future(), (3, 0)
    lc._pgo_future.set_exception(RuntimeError("CUDA launch failed"))
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        lc.lc_callback()
    lc._pgo_future, lc._pgo_pair = Future(), (3, 0)
    lc._pgo_future.set_result(np.full((3, 8), np.nan, np.float32))
    assert lc.lc_callback() is False and "corrected" not in got and lc.applied == []
