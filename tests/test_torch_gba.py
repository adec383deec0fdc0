"""The port's global BA (dpvo_tpu_torch/ba/gba_sparse.py) and scale-gauge
guard (runtime/steps.py:_normalize) against the JAX package's, on the CPU.

The same inputs, from one seed, go through both: the host sparsity
enumeration must give equal arrays; the sparse Gauss-Newton solve and the
gauge guard must agree within f32 rounding; and the port's sparse solve
must agree with its own sliding-window solver, as
tests/test_gba_sparse.py::test_sparse_matches_dense holds the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_tpu.ba import gba_sparse as jgs
from dpvo_tpu.config import Config as JConfig
from dpvo_tpu.runtime.state import make_state as jmake_state
from dpvo_tpu.runtime.steps import StepFunctions as JSteps
from dpvo_tpu_torch.ba import gba_sparse as tgs
from dpvo_tpu_torch.ba import solver as tsolver
from dpvo_tpu_torch.config import Config as TConfig
from dpvo_tpu_torch.runtime.state import make_state as tmake_state
from dpvo_tpu_torch.runtime.steps import StepFunctions as TSteps
from test_ba import synthetic_problem
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)

# poses, inverse depths: |port - JAX| after two Gauss-Newton iterations from
# the same f32 inputs, measured at most 4.3e-5 and 5.4e-5 (with every
# coupling; 1.8e-7 with most depth groups frozen), doubled. The reduced
# system S = B - E Q E^T cancels most of B here, so f32 summation order
# alone moves the step that far (tests/test_gba_sparse.py allows 2e-4
# between JAX's own sparse and dense solvers on it).
GBA_ATOL = 1.1e-4


def _random_topology(seed, n_frames=24, M=6, n_edges=900, t0=3, nfree=18):
    rng = np.random.default_rng(seed)
    kk = rng.integers(0, n_frames * M, n_edges)
    ii = kk // M
    jj = rng.integers(0, n_frames, n_edges)
    _, kd = np.unique(kk, return_inverse=True)
    return ii, jj, kd, t0, nfree


@pytest.mark.parametrize("seed,kp_max", [(0, 1 << 16), (1, 1 << 16), (2, 1 << 16),
                                         (3, 3000)])
def test_build_sparse_indices_matches_jax(seed, kp_max):
    """Rows, entries and kpairs equal to the JAX function's live arrays, on
    random topologies (edges on fixed and free poses alike); kp_max 3000
    overflows and freezes depth groups, as in JAX. The sort orders are
    stable argsorts of their ids."""
    ii, jj, kd, t0, nfree = _random_topology(seed)
    W = 20
    j = jgs.build_sparse_indices(ii, jj, kd, t0, nfree, W=W, R_MAX=4096, KP_MAX=kp_max)
    t = tgs.build_sparse_indices(ii, jj, kd, t0, nfree, W=W, R_MAX=4096, KP_MAX=kp_max)
    R, F, KP = len(t["re"]), len(t["fk"]), len(t["p1"])
    assert R == int(j["rmask"].sum()) and F == int(j["fmask"].sum())
    assert KP == int(j["kpmask"].sum())
    for k in ("re", "ra", "rs", "r2f"):
        np.testing.assert_array_equal(t[k], j[k][:R])
    for k in ("fk", "fa", "fkeep"):
        np.testing.assert_array_equal(t[k], j[k][:F])
    for k in ("p1", "p2"):
        np.testing.assert_array_equal(t[k], j[k][:KP])
    if kp_max == 3000:
        assert not t["fkeep"].all() and KP <= kp_max
    else:
        assert t["fkeep"].all()
    for seg, order in (("r2f", "r2f_order"), ("fa", "fa_order"), ("fk", "fk_order"),
                       ("blk_seg", "blk_order"), ("v_seg", "v_order"),
                       ("pair_seg", "pair_order")):
        np.testing.assert_array_equal(t[order], np.argsort(t[seg], kind="stable"))
    np.testing.assert_array_equal(t["kd_order"], np.argsort(kd, kind="stable"))
    fa = t["fa"]
    np.testing.assert_array_equal(t["pair_seg"], fa[t["p1"]] * W + fa[t["p2"]])


def _problem(key, pad=37, noise=0.5):
    """tests/test_gba_sparse.py's problem: perturbed poses and depths, the
    edges padded with invalid ones."""
    poses_gt, ctr_gt, intr, target, ii, jj, kd = synthetic_problem(key, noise=noise)
    n = poses_gt.shape[0]
    Md = ctr_gt.shape[0]
    E = ii.shape[0]
    kp, kdd = jax.random.split(jax.random.PRNGKey(7))
    poses0 = jnp.asarray(poses_gt).at[1:, :3].add(0.05 * jax.random.normal(kp, (n - 1, 3)))
    poses0 = jnp.concatenate(
        [poses0[:, :3], poses0[:, 3:] / jnp.linalg.norm(poses0[:, 3:], axis=-1, keepdims=True)], -1)
    ctr0 = ctr_gt.at[:, 2].mul(1.0 + 0.15 * jax.random.normal(kdd, (Md,)))

    def padE(a):
        return jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])

    arrays = dict(poses=poses0, ctr=ctr0, intr=intr, target=padE(target),
                  weight=jnp.concatenate([jnp.ones((E, 2)), jnp.zeros((pad, 2))]),
                  valid=jnp.concatenate([jnp.ones((E,), bool), jnp.zeros((pad,), bool)]),
                  ii=padE(ii), jj=padE(jj), kd=padE(kd))
    return {k: np.asarray(v) for k, v in arrays.items()}, (np.asarray(ii), np.asarray(jj),
                                                            np.asarray(kd)), n, Md


BOUNDS = (-64.0, -64.0, 2 * 80.0 + 64.0, 2 * 60.0 + 64.0)


def _both(key, kp_max, W=8, t0=1, ep=1.0, iterations=2):
    p, (ii, jj, kd), n, Md = _problem(key)
    nfree = n - 1
    jidx = jgs.build_sparse_indices(ii, jj, kd, t0, nfree, W=W, R_MAX=4096, KP_MAX=kp_max)
    jout = jgs.gba(*(jnp.asarray(p[k]) for k in ("poses", "ctr", "intr", "target", "weight",
                                                  "valid", "ii", "jj", "kd")),
                   jnp.int32(t0), jnp.int32(nfree), jnp.asarray(BOUNDS), jnp.float32(1e-4),
                   {k: jnp.asarray(v) for k, v in jidx.items()}, W=W, Md=Md,
                   iterations=iterations, ep=ep)
    tidx = tgs.index_tensors(
        tgs.build_sparse_indices(ii, jj, kd, t0, nfree, W=W, R_MAX=4096, KP_MAX=kp_max), "cpu")
    t = {k: torch.as_tensor(v.copy()) for k, v in p.items()}
    tout = tgs.gba(t["poses"], t["ctr"], t["intr"], t["target"], t["weight"], t["valid"],
                   t["ii"].long(), t["jj"].long(), t["kd"], t0, nfree, torch.tensor(BOUNDS),
                   1e-4, tidx, W=W, Md=Md, iterations=iterations, ep=ep)
    return [np.asarray(x) for x in jout], [x.numpy() for x in tout], p


@pytest.mark.parametrize("kp_max", [1 << 14, 64])
def test_gba_matches_jax(kp_max):
    """The port's sparse global BA against the JAX one on test_gba_sparse.py's
    problem (padded invalid edges), with every coupling (kp_max 2^14) and
    with most depth groups frozen (kp_max 64)."""
    (jp, jd), (tp, td), p = _both(jax.random.PRNGKey(3), kp_max)
    assert np.abs(tp - p["poses"]).max() > 1e-3  # the solve moved the poses
    np.testing.assert_allclose(tp, jp, atol=GBA_ATOL, rtol=0)
    np.testing.assert_allclose(td, jd, atol=GBA_ATOL, rtol=0)


def test_gba_matches_window_ba():
    """The sparse assembly solves the same damped system as the port's
    sliding-window solver (its dense pose blocks and depth reduction):
    the tolerance of tests/test_gba_sparse.py::test_sparse_matches_dense."""
    p, (ii, jj, kd), n, Md = _problem(jax.random.PRNGKey(3))
    t0, nfree, W = 1, n - 1, 8
    t = {k: torch.as_tensor(v.copy()) for k, v in p.items()}
    idx = tgs.index_tensors(
        tgs.build_sparse_indices(ii, jj, kd, t0, nfree, W=W, R_MAX=4096, KP_MAX=1 << 14), "cpu")
    args = (t["poses"], t["ctr"], t["intr"], t["target"], t["weight"], t["valid"],
            t["ii"].long(), t["jj"].long(), t["kd"], t0, nfree, torch.tensor(BOUNDS), 1e-4)
    sp, sd = tgs.gba(*args, idx, W=W, Md=Md, iterations=2)
    dp, dd = tsolver.ba(*args, W=W, Md=Md, iterations=2, clamp_mode="runtime")
    np.testing.assert_allclose(sp.numpy(), dp.numpy(), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(sd.numpy(), dd.numpy(), atol=2e-4, rtol=1e-3)


def test_nonpositive_system_is_a_zero_step():
    """A damping that makes S indefinite (ep = -1e6): the factorization fails,
    and both packages take a zero step (poses kept, depths only clamped)
    without raising."""
    (jp, jd), (tp, td), p = _both(jax.random.PRNGKey(4), 1 << 14, ep=-1e6, iterations=1)
    np.testing.assert_array_equal(tp, p["poses"])
    np.testing.assert_array_equal(jp, p["poses"])
    np.testing.assert_array_equal(td, np.maximum(p["ctr"][:, 2], 1e-4))
    np.testing.assert_array_equal(jd, td)


@pytest.mark.parametrize("scale", [300.0, 1e-3, 1.0])
def test_normalize_matches_jax(scale):
    """The gauge guard on a state whose mean inverse depth is > 1e2 (clamped
    rescale to s = 4), < 1e-2 (s = 0.25) and healthy (s = 1, nothing moves):
    the same s, poses and inverse depths as the JAX step."""
    kw = dict(BUFFER_SIZE=16, PATCHES_PER_FRAME=4, DIM=32, FDIM=16, E_MAX=64, E_INAC_MAX=64,
              M_OPT_MAX=32, W_OPT_MAX=8, MIXED_PRECISION=False, PMEM=4, MEM=4)
    rng = np.random.default_rng(11)
    n, m = 10, 40
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0], np.float32), (16, 1))
    poses[:, :3] = rng.normal(size=(16, 3))
    q = rng.normal(size=(16, 4))
    poses[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    dvec = (scale * rng.uniform(0.5, 1.5, 64)).astype(np.float32)

    jcfg = JConfig(**kw)
    jst = jmake_state(jcfg, 32, 32)._replace(poses=jnp.asarray(poses), dvec=jnp.asarray(dvec))
    jst, js = JSteps(jcfg, 32, 32).normalize(jst, jnp.int32(n), jnp.int32(m))

    tcfg = TConfig(**kw)
    tst = tmake_state(tcfg, 32, 32, "cpu")
    tst.poses.copy_(torch.as_tensor(poses))
    tst.dvec.copy_(torch.as_tensor(dvec))
    ts = TSteps(tcfg, None, torch.device("cpu"))._normalize(tst, n, m)
    want_s = {300.0: 4.0, 1e-3: 0.25, 1.0: 1.0}[scale]
    assert float(ts) == float(js) == want_s
    np.testing.assert_allclose(tst.poses.numpy(), np.asarray(jst.poses), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tst.dvec.numpy(), np.asarray(jst.dvec), rtol=1e-6)
    if scale == 1.0:
        np.testing.assert_array_equal(tst.poses.numpy(), poses)
        np.testing.assert_array_equal(tst.dvec.numpy(), dvec)
