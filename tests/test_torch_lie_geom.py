"""Port parity: dpvo_tpu_torch.lie and .geom against dpvo_tpu.lie and
.geom on random numpy inputs (f32 on both sides; tolerances cover f32
rounding of the same closed forms)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_tpu.geom import projective as jpops
from dpvo_tpu.lie import se3 as jse3
from dpvo_tpu.lie import so3 as jso3
from dpvo_tpu_torch.geom import projective as tpops
from dpvo_tpu_torch.lie import se3 as tse3
from dpvo_tpu_torch.lie import so3 as tso3
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)


RTOL, ATOL = 1e-5, 1e-5


def _twists(seed, n, scale):
    return (scale * np.random.default_rng(seed).standard_normal((n, 6))).astype(np.float32)


def _poses(seed, n, scale=0.5):
    return np.asarray(jse3.exp(jnp.asarray(_twists(seed, n, scale))))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# scales cover both sides of the 0.05 rad small-angle switch and theta = 0
@pytest.mark.parametrize("scale", [0.0, 1e-3, 0.03, 0.8])
def test_se3_exp_log(scale):
    xi = _twists(1, 64, scale)
    _close(tse3.exp(torch.as_tensor(xi)), jse3.exp(jnp.asarray(xi)))
    g = np.asarray(jse3.exp(jnp.asarray(xi)))
    _close(tse3.log(torch.as_tensor(g)), jse3.log(jnp.asarray(g)), atol=2e-5)


@pytest.mark.parametrize("fn", ["mul", "inv_mul", "act", "act4", "adjT", "to_matrix", "retr"])
def test_se3_ops(fn):
    a, b = _poses(2, 32), _poses(3, 32)
    p = np.random.default_rng(4).standard_normal((32, 4)).astype(np.float32)
    ta, tb, tp = (torch.as_tensor(x) for x in (a, b, p))
    ja, jb, jp = (jnp.asarray(x) for x in (a, b, p))
    if fn == "mul":
        _close(tse3.mul(ta, tb), jse3.mul(ja, jb))
    elif fn == "inv_mul":
        _close(tse3.mul(tse3.inv(ta), tb), jse3.mul(jse3.inv(ja), jb))
    elif fn == "act":
        _close(tse3.act(ta, tp[:, :3]), jse3.act(ja, jp[:, :3]))
    elif fn == "act4":
        _close(tse3.act4(ta, tp), jse3.act4(ja, jp))
    elif fn == "adjT":
        _close(tse3.adjT(ta, torch.cat([tp, tp[:, :2]], -1)),
               jse3.adjT(ja, jnp.concatenate([jp, jp[:, :2]], -1)))
    elif fn == "to_matrix":
        _close(tse3.to_matrix(ta), jse3.to_matrix(ja))
    else:
        xi = _twists(5, 32, 0.1)
        _close(tse3.retr(ta, torch.as_tensor(xi)), jse3.retr(ja, jnp.asarray(xi)))


@pytest.mark.parametrize("scale", [0.0, 1e-5, 0.5])
def test_so3_exp_log_hat(scale):
    phi = (scale * np.random.default_rng(6).standard_normal((40, 3))).astype(np.float32)
    q = tso3.exp(torch.as_tensor(phi))
    _close(q, jso3.exp(jnp.asarray(phi)))
    _close(tso3.log(q), jso3.log(jnp.asarray(q.numpy())), atol=2e-5)
    _close(tso3.hat(torch.as_tensor(phi)), jso3.hat(jnp.asarray(phi)))
    _close(tso3.to_matrix(q), jso3.to_matrix(jnp.asarray(q.numpy())))


def _geom_problem(seed, E=40, N=5, Mtot=30):
    rng = np.random.default_rng(seed)
    poses = _poses(seed, N, 0.1)
    x = rng.uniform(5, 60, (Mtot, 1, 1)) + np.arange(3)[None, None, :] - 1
    y = rng.uniform(5, 40, (Mtot, 1, 1)) + np.arange(3)[None, :, None] - 1
    d = rng.uniform(0.1, 1.0, (Mtot, 1, 1))
    patches = np.stack(np.broadcast_arrays(x, y, d), 1).astype(np.float32)
    intr = np.tile(np.array([[50.0, 52.0, 32.0, 24.0]], np.float32), (N, 1))
    ii = rng.integers(0, N, E)
    jj = rng.integers(0, N, E)
    kk = rng.integers(0, Mtot, E)
    depth = rng.uniform(0.05, 1.5, Mtot).astype(np.float32)
    return poses, patches, intr, ii, jj, kk, depth


def _both(args):
    return ([jnp.asarray(a) for a in args],
            [torch.as_tensor(np.array(a)) for a in args])


@pytest.mark.parametrize("variant", ["plain", "valid", "tonly", "depth", "jacobian"])
def test_transform(variant):
    poses, patches, intr, ii, jj, kk, depth = _geom_problem(7)
    (jargs, targs) = _both((poses, patches, intr, ii, jj, kk))
    jdep, tdep = jnp.asarray(depth), torch.as_tensor(depth)
    if variant == "plain":
        _close(tpops.transform(*targs), jpops.transform(*jargs), atol=1e-4)
    elif variant == "valid":
        tc, tv = tpops.transform(*targs, valid=True)
        jc, jv = jpops.transform(*jargs, valid=True)
        _close(tc, jc, atol=1e-4)
        _close(tv, jv)
    elif variant == "tonly":
        _close(tpops.transform(*targs, tonly=True), jpops.transform(*jargs, tonly=True),
               atol=1e-4)
    elif variant == "depth":
        _close(tpops.transform(*targs, depth=tdep), jpops.transform(*jargs, depth=jdep),
               atol=1e-4)
    else:
        got = tpops.transform(*targs, jacobian=True, depth=tdep)
        want = jpops.transform(*jargs, jacobian=True, depth=jdep)
        _close(got[0], want[0], atol=1e-4)
        _close(got[1], want[1])
        for g, w in zip(got[2], want[2]):
            _close(g, w, rtol=1e-4, atol=1e-3)


def test_iproj_proj_flow_mag():
    poses, patches, intr, ii, jj, kk, depth = _geom_problem(8)
    (jargs, targs) = _both((poses, patches, intr, ii, jj, kk))
    X = tpops.iproj(targs[1][targs[5]], targs[2][targs[3]])
    _close(X, jpops.iproj(jargs[1][jargs[5]], jargs[2][jargs[3]]))
    _close(tpops.proj(X, targs[2][targs[4]], depth=True),
           jpops.proj(jnp.asarray(X.numpy()), jargs[2][jargs[4]], depth=True), atol=1e-4)
    tm, tv = tpops.flow_mag(*targs, beta=0.5, depth=torch.as_tensor(depth))
    jm, jv = jpops.flow_mag(*jargs, beta=0.5, depth=jnp.asarray(depth))
    _close(tm, jm, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
