"""Port parity: dpvo_tpu_torch.lie.sim3, the Sim(3) branch of the
projective transform and the Sim(3) pose-graph optimizer (slam/pgo.py)
against dpvo_tpu.lie.sim3 / dpvo_tpu.geom / dpvo_tpu.slam.pgo on the same
random numpy inputs (f32 on both sides): elements below and above the 0.03
series switch in angle and in scale, the batched forward-mode Jacobians the
PGO takes through them, and the PGO on tests/test_pgo.py's drift problem.

The PGO's system is ill-conditioned in f32 (every node free, the 7-dof
gauge held only by the 1e-6 LM damping), so one step is
compared through its assembled system and the residual it reaches, and a
whole run by its poses after a Sim(3) alignment and the drift it removes;
the anchored ``apply_loop_closure`` is compared directly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_tpu.eval import ate as jate
from dpvo_tpu.geom import projective as jpops
from dpvo_tpu.lie import sim3 as jsim3
from dpvo_tpu.slam import pgo as jpgo
from dpvo_tpu_torch.eval import ate as tate
from dpvo_tpu_torch.geom import projective as tpops
from dpvo_tpu_torch.lie import sim3 as tsim3
from dpvo_tpu_torch.slam import pgo as tpgo
from test_pgo import loop_constraint, make_drifty_loop, traj_positions
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)

# f32 rounding of the same closed forms: the group operations agree to a few
# ulps of O(1) values; log's 3x3 solve (LU in JAX, an explicit inverse in the
# port) to ~1e-6 at these conditionings
RTOL, ATOL = 1e-5, 2e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _tangents(seed, n, angle, sigma):
    """Tangents (tau, phi, sigma) with |phi| = angle and |sigma| = sigma in
    random directions and signs (a scale of 0 left as 0)."""
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((n, 3))
    phi *= angle / np.linalg.norm(phi, axis=1, keepdims=True)
    sg = sigma * rng.choice([-1.0, 1.0], (n, 1))
    return np.concatenate([0.5 * rng.standard_normal((n, 3)), phi, sg], 1).astype(np.float32)


# angles and scales on both sides of _EPS = 0.03 (series / closed form), and 0
REGIMES = [(0.0, 0.0), (0.01, 0.01), (0.01, 0.4), (0.7, 0.01), (0.7, 0.4), (2.5, 0.3),
           (0.029, 0.031), (0.031, 0.029)]


def _elements(seed, n=32, angle=0.7, sigma=0.4):
    return np.asarray(jsim3.exp(jnp.asarray(_tangents(seed, n, angle, sigma))))


@pytest.mark.parametrize("angle,sigma", REGIMES)
def test_sim3_exp_log(angle, sigma):
    xi = _tangents(1, 64, angle, sigma)
    _close(tsim3.exp(torch.as_tensor(xi)), jsim3.exp(jnp.asarray(xi)))
    g = np.asarray(jsim3.exp(jnp.asarray(xi)))
    _close(tsim3.log(torch.as_tensor(g)), jsim3.log(jnp.asarray(g)), atol=5e-6)


@pytest.mark.parametrize("fn", ["mul", "inv", "act", "act4", "adjT", "to_matrix", "retr",
                                "from_se3"])
def test_sim3_ops(fn):
    a, b = _elements(2), _elements(3)
    p = np.random.default_rng(4).standard_normal((32, 7)).astype(np.float32)
    ta, tb, tp = (torch.as_tensor(x) for x in (a, b, p))
    ja, jb, jp = (jnp.asarray(x) for x in (a, b, p))
    got, want = {
        "mul": lambda: (tsim3.mul(ta, tb), jsim3.mul(ja, jb)),
        "inv": lambda: (tsim3.inv(ta), jsim3.inv(ja)),
        "act": lambda: (tsim3.act(ta, tp[:, :3]), jsim3.act(ja, jp[:, :3])),
        "act4": lambda: (tsim3.act4(ta, tp[:, :4]), jsim3.act4(ja, jp[:, :4])),
        "adjT": lambda: (tsim3.adjT(ta, tp), jsim3.adjT(ja, jp)),
        "to_matrix": lambda: (tsim3.to_matrix(ta), jsim3.to_matrix(ja)),
        "retr": lambda: (tsim3.retr(ta, 0.1 * tp), jsim3.retr(ja, 0.1 * jp)),
        "from_se3": lambda: (tsim3.from_se3(ta[:, :7]), jsim3.from_se3(ja[:, :7])),
    }[fn]()
    _close(got, want)


def test_sim3_identity_and_to_se3():
    _close(tsim3.identity((5,)), jsim3.identity((5,)))
    g = _elements(5)
    _close(tsim3.to_se3(torch.as_tensor(g)), jsim3.to_se3(jnp.asarray(g)))


@pytest.fixture(scope="module")
def _jax_jac():
    return jax.jit(jpgo._jac_vmap)


@pytest.mark.parametrize("angle,sigma", [(0.0, 0.0), (0.01, 0.01), (0.7, 0.4)])
def test_sim3_batched_jacobians(angle, sigma, _jax_jac):
    """vmap(jacfwd) through exp, mul, inv and log (the PGO's residual), per
    row against jacfwd of one row and against jax.jacfwd; finite and f32 at
    the identity, where the PGO's consistent constraints sit."""
    C = _elements(6, 8, angle, sigma)
    gi, gj = _tangents(7, 8, angle, sigma), _tangents(8, 8, angle, sigma)
    batched = tpgo._jac_vmap(*(torch.as_tensor(x) for x in (C, gi, gj)))
    one = torch.func.jacfwd(tpgo._residual_one, argnums=(1, 2))
    for k in range(2):
        assert batched[k].dtype == torch.float32 and torch.isfinite(batched[k]).all()
        rows = torch.stack([one(*(torch.as_tensor(x[r]) for x in (C, gi, gj)))[k]
                            for r in range(8)])
        _close(batched[k], rows, atol=1e-6)
        _close(batched[k], _jax_jac(*(jnp.asarray(x) for x in (C, gi, gj)))[k], atol=2e-5)


# one compiled program each (op by op, JAX compiles every primitive anew)
_jax_transform = jax.jit(jpops.transform, static_argnames=("jacobian", "valid", "tonly"))


def _scene(seed=4):
    """tests/test_geom.py:make_scene's layout in numpy: 5 frames of small
    random motion, 12 patches of 3x3 pixels at inverse depth 0.5."""
    from dpvo_tpu.lie import se3 as jse3

    rng = np.random.default_rng(seed)
    xs = (0.05 * rng.standard_normal((5, 6))).astype(np.float32)
    poses = [np.asarray(jse3.identity())]
    for i in range(1, 5):
        poses.append(np.asarray(jse3.mul(jse3.exp(jnp.asarray(xs[i])), jnp.asarray(poses[-1]))))
    intr = np.tile(np.array([[120.0, 120.0, 80.0, 60.0]], np.float32), (5, 1))
    c = np.stack([rng.uniform(20, 140, 12), rng.uniform(20, 100, 12)], 1).astype(np.float32)
    off = np.arange(3) - 1
    gx = np.broadcast_to(c[:, 0, None, None] + off[None, None, :], (12, 3, 3))
    gy = np.broadcast_to(c[:, 1, None, None] + off[None, :, None], (12, 3, 3))
    patches = np.stack([gx, gy, np.full((12, 3, 3), 0.5)], 1).astype(np.float32)
    return np.stack(poses).astype(np.float32), patches, intr


# scale 1 (Sim(3) poses that are SE(3) ones) and test_geom.py:116's scales
@pytest.mark.parametrize("scales", [[1.0] * 5, [1.0, 1.1, 0.9, 1.2, 0.8]])
@pytest.mark.parametrize("tonly", [False, True])
def test_transform_sim3_matches_jax(scales, tonly):
    poses, patches, intr = _scene()
    poses8 = np.concatenate([poses, np.asarray(scales, np.float32)[:, None]], 1)
    E = patches.shape[0]
    ii, jj, kk = np.zeros(E, np.int64), np.full(E, 2, np.int64), np.arange(E)
    targs = (poses8, patches, intr, ii, jj, kk)
    if tonly:
        got = tpops.transform(*(torch.as_tensor(x) for x in targs), tonly=True)
        want = _jax_transform(*(jnp.asarray(x) for x in targs), tonly=True)
        _close(got, want, atol=1e-4)
        return
    got = tpops.transform(*(torch.as_tensor(x) for x in targs), jacobian=True)
    want = _jax_transform(*(jnp.asarray(x) for x in targs), jacobian=True)
    _close(got[0], want[0], atol=1e-4)  # pixels ~1e2
    _close(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        assert a.shape == b.shape
        _close(a, b, atol=1e-4)
    assert got[2][0].shape == (E, 2, 7)
    if scales[1] == 1.0:  # scale 1: the SE(3) transform's pixels
        _close(got[0], tpops.transform(*(torch.as_tensor(x) for x in (poses,) + targs[1:])),
               atol=1e-4)


def test_transform_sim3_jacobians_match_autodiff():
    """The port's analytic Sim(3) Jacobians against torch's own forward-mode
    differentiation through sim3.retr (test_geom.py:116's check, on the
    port)."""
    poses, patches, intr = _scene()
    scales = torch.tensor([1.0, 1.1, 0.9, 1.2, 0.8])
    poses8 = torch.cat([torch.as_tensor(poses), scales[:, None]], 1)
    E = patches.shape[0]
    ii, jj, kk = torch.zeros(E, dtype=torch.long), torch.full((E,), 2), torch.arange(E)
    P, K = torch.as_tensor(patches), torch.as_tensor(intr)
    _, _, (Ji, Jj, _) = tpops.transform(poses8, P, K, ii, jj, kk, jacobian=True)

    def at(frame):
        def f(xi):
            moved = tsim3.retr(poses8[frame], xi)
            p2 = torch.cat([poses8[:frame], moved[None], poses8[frame + 1:]])
            return tpops.transform(p2, P, K, ii, jj, kk)[:, 1, 1, :]
        return torch.func.jacfwd(f)(torch.zeros(7))

    _close(Jj, at(2), rtol=1e-3, atol=1e-3)
    _close(Ji, at(0), rtol=1e-3, atol=1e-3)


# ---------------- the Sim(3) PGO ----------------

def _positions(out):
    """Camera positions of Sim(3) PGO poses (scale folded into t)."""
    return traj_positions(np.concatenate([out[:, :3] / out[:, 7:8], out[:, 3:7]], 1))


def _drifty_problem():
    """tests/test_pgo.py's drift problem: n = 40, two loop constraints."""
    gt, est = make_drifty_loop()
    n = gt.shape[0]
    ii, jj = np.array([n - 2, n - 3]), np.array([1, 2])
    C = np.stack([loop_constraint(gt, i, j) for i, j in zip(ii, jj)])
    return gt, est, C, ii, jj


def _step_inputs(est, C, ii, jj):
    """run_pgo's first-step inputs (JAX's construction): Ginv, constants,
    iii, jjj."""
    n = est.shape[0]
    pred = jnp.asarray(est)
    Ginv = jsim3.log(jsim3.inv(jsim3.from_se3(pred)))
    kk = np.arange(1, n)
    ll = kk - 1
    dS = jsim3.mul(jsim3.inv(jsim3.from_se3(pred[ll])), jsim3.from_se3(pred[kk]))
    consts = np.concatenate([np.asarray(dS), C]).astype(np.float32)
    iii = np.concatenate([kk, ii]).astype(np.int32)
    jjj = np.concatenate([ll, jj]).astype(np.int32)
    return np.asarray(Ginv), consts, iii, jjj


def _jax_step(Ginv, consts, iii, jjj, n, ep=0.0, lmbda=1e-6):
    valid = jnp.ones(len(iii))
    d, r = jpgo._pgo_step(jnp.asarray(Ginv), jnp.asarray(consts), jnp.asarray(iii),
                          jnp.asarray(jjj), valid, jnp.float32(lmbda), jnp.float32(ep),
                          jnp.int32(n), n=n)
    return np.asarray(d), float(r)


def _port_step(Ginv, consts, iii, jjj, n, ep=0.0, lmbda=1e-6):
    d, r = tpgo._pgo_step(torch.as_tensor(Ginv), torch.as_tensor(consts), iii, jjj,
                          torch.ones(len(iii)), lmbda, ep, n, n=n)
    return d.numpy(), float(r)


def _mean_sq_residual(G, consts, iii, jjj):
    """The PGO's mean squared residual at G, in float64 (the port's residual)."""
    G, K = torch.as_tensor(G, dtype=torch.float64), torch.as_tensor(consts, dtype=torch.float64)
    return float(torch.mean(tpgo._residual_one(K, G[iii], G[jjj]) ** 2))


def test_pgo_step_matches_jax():
    """One LM step from the same Ginv: the mean squared residual agrees to
    f32 rounding; the steps part by the f32 Cholesky's conditioning
    (measured 1.45e-3 of |delta| <= 0.10), so they are held to 3e-3 and
    by the residual they reach: within 1% of each other (the assembled
    system itself is held bit for bit to a dense sum below, and the
    Jacobians to JAX's in tests/test_torch_sim3.py)."""
    gt, est, C, ii, jj = _drifty_problem()
    n = est.shape[0]
    Ginv, consts, iii, jjj = _step_inputs(est, C, ii, jj)
    dj, rj = _jax_step(Ginv, consts, iii, jjj, n)
    dt, rt = _port_step(Ginv, consts, iii, jjj, n)
    assert abs(rt - rj) <= 1e-6 * rj
    assert np.abs(dt - dj).max() <= 3e-3
    res_j = _mean_sq_residual(Ginv + dj, consts, iii, jjj)
    res_t = _mean_sq_residual(Ginv + dt, consts, iii, jjj)
    assert res_j < rj and abs(res_t - res_j) <= 0.01 * res_j


@pytest.mark.parametrize("free", ["all", "some"])
def test_normal_eqs_equal_a_dense_accumulation(free):
    """The segment-sum H and g are the dense per-pair sums of the four block
    products and two gradient terms, bit for bit when the dense sum adds in
    the same order (the blocks in turn, constraints in order); poses past
    freen add nothing."""
    gt, est, C, ii, jj = _drifty_problem()
    n = est.shape[0]
    freen = n if free == "all" else n - 5
    Ginv, consts, iii, jjj = _step_inputs(est, C, ii, jj)
    G, K = torch.as_tensor(Ginv), torch.as_tensor(consts)
    graph = tpgo.pgo_graph(iii, jjj, freen, n, "cpu")
    H, g, r = tpgo.normal_eqs(G, K, torch.ones(len(iii)), graph, n)
    Ji, Jj = tpgo._jac_vmap(K, G[graph["iii"]], G[graph["jjj"]])
    Hd = torch.zeros(n, n, 7, 7)
    gd = torch.zeros(n, 7)
    # the products as normal_eqs forms them; their sums here, pair by pair
    for a_of, b_of, Ja, Jb in (("i", "i", Ji, Ji), ("i", "j", Ji, Jj), ("j", "i", Jj, Ji),
                               ("j", "j", Jj, Jj)):
        blk = torch.einsum("rki,rkj->rij", Ja, Jb)
        for k in range(len(iii)):
            a = iii[k] if a_of == "i" else jjj[k]
            b = iii[k] if b_of == "i" else jjj[k]
            if a < freen and b < freen:
                Hd[a, b] += blk[k]
    for J, idx in ((Ji, iii), (Jj, jjj)):
        Jr = torch.einsum("rki,rk->ri", J, r)
        for k in range(len(iii)):
            if idx[k] < freen:
                gd[idx[k]] += Jr[k]
    assert torch.equal(H, Hd.permute(0, 2, 1, 3).reshape(7 * n, 7 * n))
    assert torch.equal(g, gd.reshape(-1))


def test_pgo_step_not_positive_definite_is_zero():
    """Where the damped system is not positive definite (here a negative
    ep), JAX's cho_factor gives NaNs and its guard a zero step; the port's
    failed factorization gives the same zero step."""
    gt, est, C, ii, jj = _drifty_problem()
    Ginv, consts, iii, jjj = _step_inputs(est, C, ii, jj)
    dj, _ = _jax_step(Ginv, consts, iii, jjj, est.shape[0], ep=-10.0)
    dt, _ = _port_step(Ginv, consts, iii, jjj, est.shape[0], ep=-10.0)
    assert not dj.any() and not dt.any()


def test_run_pgo_matches_jax():
    """The LM loop on the drift problem: the poses after a Sim(3) alignment
    of the port's to JAX's (the gauge is free: the unaligned poses part by
    1.6e-2, a gauge move) within 1.3e-3 on a 4.26 path (measured 6.2e-4),
    and the drift removed: ATE 0.0455 -> 0.01148 (JAX) and 0.01162 (port),
    held within 3% of JAX's."""
    gt, est, C, ii, jj = _drifty_problem()
    pj = _positions(jpgo.run_pgo(est, C, ii, jj))
    pt = _positions(tpgo.run_pgo(est, C, ii, jj, device="cpu"))
    R, t, s = tate.umeyama_alignment(pt.T, pj.T)
    assert np.abs((s * (R @ pt.T)).T + t - pj).max() <= 1.3e-3
    g = traj_positions(gt)
    ate_j, ate_t = jate.ate_rmse(pj, g), tate.ate_rmse(pt, g)
    assert ate_j < 0.3 * jate.ate_rmse(traj_positions(est), g)
    assert abs(ate_t - ate_j) <= 0.03 * ate_j


def test_apply_loop_closure_matches_jax():
    """Re-anchored at the frame past the loop, the gauge is fixed: on the
    n = 40 drift problem with one loop (38 -> 1) the corrected poses agree
    within 1.5e-5 (measured 6.5e-6 of |x| <= 1.40)."""
    gt, est = make_drifty_loop()
    C = np.stack([loop_constraint(gt, 38, 1)])
    args = (est, C, np.array([38]), np.array([1]))
    want = jpgo.apply_loop_closure(*args)
    got = tpgo.apply_loop_closure(*args, device="cpu")
    assert got.shape == want.shape == (39, 8)
    assert np.abs(got - want).max() <= 1.5e-5


def test_pgo_corrects_drift():
    """tests/test_pgo.py:test_pgo_corrects_drift on the port."""
    gt, est, C, ii, jj = _drifty_problem()
    out = tpgo.run_pgo(est, C, ii, jj, device="cpu")
    assert out.shape == (est.shape[0], 8)
    g = traj_positions(gt)
    assert tate.ate_rmse(_positions(out), g) < 0.6 * tate.ate_rmse(traj_positions(est), g)


def test_apply_loop_closure_anchors():
    """tests/test_pgo.py:test_apply_loop_closure_anchors on the port."""
    gt, est = make_drifty_loop(n=30, seed=1)
    C = np.stack([loop_constraint(gt, 28, 1)])
    out = tpgo.apply_loop_closure(est, C, np.array([28]), np.array([1]), device="cpu")
    assert out.shape == (29, 8) and np.all(np.isfinite(out))


def test_pgo_noop_when_consistent():
    """tests/test_pgo.py:test_pgo_noop_when_consistent on the port: its
    constraints sit at the identity, where the Jacobians must stay finite."""
    gt, _ = make_drifty_loop(n=20, seed=2)
    C = np.stack([loop_constraint(gt, 18, 1)])
    out = tpgo.run_pgo(gt, C, np.array([18]), np.array([1]), device="cpu")
    assert np.allclose(out[:, 7], 1.0, atol=1e-3)
    assert np.allclose(out[:, :3], gt[:, :3], atol=2e-3)
    assert np.allclose(np.abs(np.sum(out[:, 3:7] * gt[:, 3:7], axis=1)), 1.0, atol=1e-4)
