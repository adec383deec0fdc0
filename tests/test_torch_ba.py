"""Port parity: the sliding-window BA of dpvo_tpu_torch against
dpvo_tpu.ba on the CPU — the segment-sum and SPD-solve plain versions
against the Pallas kernels in interpret mode, and the whole solver on
the tests/test_ba.py problems."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_tpu.ba import solver as jsolver
from dpvo_tpu.ba.segsum_pallas import EB, segment_sum_sorted
from dpvo_tpu.ba.spd_solve import spd_solve as j_spd_solve
from dpvo_tpu.lie import se3 as jse3
from dpvo_tpu_torch.ba import solver as tsolver
from dpvo_tpu_torch.ba.segsum import CHUNK, segment_sum
from dpvo_tpu_torch.ba.spd_solve import spd_solve
from test_ba import synthetic_problem
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)


def _t(x, dtype=None):
    t = torch.as_tensor(np.array(x))
    return t.to(dtype) if dtype is not None else t


@pytest.mark.parametrize("K,Md,E,run", [pytest.param(20, 40, 2 * EB, 0, id="20-40"),
                                        pytest.param(98, 300, 2 * EB, 0, id="98-300"),
                                        pytest.param(36, 50, 4 * EB, 2 * CHUNK + 37,
                                                     id="36-50-long-run")])
def test_segment_sum_matches_pallas_interpret(K, Md, E, run):
    """Sorted dense ids through a stable argsort: f32 sums of <= E rows,
    tolerance for summation order only. The third case has one segment of
    more than 2 * CHUNK rows, which the port sums in three pieces."""
    rng = np.random.default_rng(K)
    assert run < E - Md
    kd = np.concatenate([np.arange(min(Md, E)), np.full(run, 7),
                         rng.integers(0, Md, E - min(Md, E) - run)])
    rng.shuffle(kd)
    payload = rng.standard_normal((E, K)).astype(np.float32)
    order = np.argsort(kd, kind="stable")
    want = np.asarray(segment_sum_sorted(jnp.asarray(payload[order]),
                                         jnp.asarray(kd[order], jnp.int32), Md=Md,
                                         interpret=True))
    got = segment_sum(_t(payload), _t(kd), _t(order), Md).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _sequential_sums(payload, kd, Md):
    """Row after row in edge order (np.add.at is unbuffered): f32 sums, ids
    outside [0, Md) dropped."""
    keep = (kd >= 0) & (kd < Md)
    out = np.zeros((Md, payload.shape[1]), np.float32)
    np.add.at(out, kd[keep], payload[keep].astype(np.float32))
    return out


def _chunked_sums(payload, kd, Md, chunk=CHUNK):
    """The kernel's function: each segment's rows in edge order cut into
    pieces of `chunk` rows from its first, each piece summed row after row
    from 0 in f32, then the pieces' sums added in piece order; ids outside
    [0, Md) dropped."""
    out = np.zeros((Md, payload.shape[1]), np.float32)
    for s in range(Md):
        rows = payload[kd == s].astype(np.float32)
        for a in range(0, len(rows), chunk):
            piece = np.zeros(payload.shape[1], np.float32)
            for row in rows[a:a + chunk]:
                piece += row
            out[s] += piece
    return out


def _plain_sums(payload, kd, Md, threads):
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        got = segment_sum(_t(payload), _t(kd, torch.int32), None, Md)
    finally:
        torch.set_num_threads(before)
    assert got.dtype == torch.float32 and got.shape == (Md, payload.shape[1])
    return got


@pytest.mark.parametrize("threads", [1, 4])
def test_segment_sum_plain_is_sequential(threads):
    """The plain version gives the bits of the kernel's order, CHUNK-row
    pieces summed row after row and then in piece order, with any torch
    thread count, on a run of ~600 rows (three pieces), empty segments
    and ids outside [0, Md), which are dropped."""
    rng = np.random.default_rng(11)
    E, K, Md = 4000, 98, 300
    kd = rng.integers(-3, Md + 5, E)
    kd[rng.uniform(size=E) < 0.15] = 7  # a run of ~600 rows
    kd[(kd > 100) & (kd < 120)] = 121   # empty segments
    payload = (rng.standard_normal((E, K)) * rng.uniform(0.01, 100, (E, 1))).astype(np.float32)
    assert (kd == 7).sum() > 2 * CHUNK
    got = _plain_sums(payload, kd, Md, threads)
    assert np.array_equal(got.numpy(), _chunked_sums(payload, kd, Md))
    assert not np.array_equal(got.numpy()[7], _sequential_sums(payload, kd, Md)[7])
    assert (got[101:120] == 0).all()


@pytest.mark.parametrize("threads", [1, 4])
def test_segment_sum_plain_short_runs_are_sequential(threads):
    """Where no run is longer than CHUNK rows (one of exactly CHUNK), the
    order is the sequential sum in edge order: the bits of index_add_ row
    after row, as at the tracker's, training's and classic loop closure's
    call sites."""
    rng = np.random.default_rng(13)
    E, K, Md = 3000, 36, 300
    kd = np.concatenate([np.full(CHUNK, 5), rng.integers(-3, Md + 5, E - CHUNK)])
    kd[kd == 5] = 6
    kd[:CHUNK] = 5
    rng.shuffle(kd)
    payload = (rng.standard_normal((E, K)) * rng.uniform(0.01, 100, (E, 1))).astype(np.float32)
    assert np.bincount(kd[(kd >= 0) & (kd < Md)]).max() == CHUNK
    got = _plain_sums(payload, kd, Md, threads)
    assert np.array_equal(got.numpy(), _sequential_sums(payload, kd, Md))


def test_segment_sum_plain_bf16_equals_its_f32_cast():
    """A bf16 payload (SoftAgg's) sums as its f32 cast does, bit for bit: a
    bf16 value converts to f32 exactly."""
    rng = np.random.default_rng(12)
    E, K, Md = 3000, 128, 200
    kd = _t(rng.integers(0, Md + 3, E), torch.int32)
    payload = torch.as_tensor(rng.standard_normal((E, K)).astype(np.float32)).to(torch.bfloat16)
    got = segment_sum(payload, kd, None, Md)
    assert got.dtype == torch.float32
    assert torch.equal(got, segment_sum(payload.float(), kd, None, Md))


def _spd_system(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    S = (A @ A.T + n * np.eye(n)).astype(np.float32)
    return S, rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("n", [48, 96])
def test_spd_solve_matches_pallas_interpret(n):
    """The port's Cholesky plain version against the JAX Gauss-Jordan, both
    f32: two factorizations of one system differ by rounding only. The
    systems are well conditioned (A A^T + n I: condition number ~5), so
    each solution's f32 error is ~1e-6 of its scale; 1e-4 relative holds
    that with room and would catch any error in the algorithm."""
    S, y = _spd_system(n, n)
    want = np.asarray(j_spd_solve(jnp.asarray(S), jnp.asarray(y), True))
    got = spd_solve(_t(S), _t(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_spd_solve_gradient_matches_custom_vjp():
    """The autograd Function's backward (another solve, Cholesky; S_bar =
    -y_bar x^T) against the JAX custom VJP (Gauss-Jordan), for a loss
    touching x nonlinearly: rounding of the two factorizations only."""
    S, y = _spd_system(48, 7)
    w = np.random.default_rng(8).standard_normal(48).astype(np.float32)

    def jloss(S, y):
        x = j_spd_solve(S, y, True)
        return jnp.sum(jnp.asarray(w) * x ** 2)

    gS_want, gy_want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(S), jnp.asarray(y))
    St, yt = _t(S).requires_grad_(), _t(y).requires_grad_()
    (torch.as_tensor(w) * spd_solve(St, yt) ** 2).sum().backward()
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gy_want), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(St.grad.numpy(), np.asarray(gS_want), rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("case", ["nan", "indefinite", "singular"])
def test_spd_solve_nonpositive_pivot_is_nonfinite(case):
    """A NaN in S, or an S that is not positive definite, gives a
    non-finite x (Cholesky takes 1/sqrt of each pivot), which
    schur_solve turns into a zero update."""
    S, y = _spd_system(12, 3)
    k = 5
    if case == "nan":
        S[k, k] = np.nan
    else:  # a pivot < 0, or exactly 0, at step k
        S[k, :] = S[:, k] = 0.0
        S[k, k] = -1.0 if case == "indefinite" else 0.0
    x = spd_solve(_t(S), _t(y))
    assert not torch.isfinite(x).all()


def _ba_both(poses, ctr, intr, target, ii, jj, kd, t0, nfree, W, iters, weight=None,
             valid=None, lmbda=1e-6):
    E = ii.shape[0]
    Md = ctr.shape[0]
    weight = np.ones((E, 2), np.float32) if weight is None else weight
    valid = np.ones(E, bool) if valid is None else valid
    bounds = np.array([-64.0, -64.0, 2 * 80.0 + 64.0, 2 * 60.0 + 64.0], np.float32)
    jp, jd = jsolver.ba(jnp.asarray(poses), jnp.asarray(ctr), jnp.asarray(intr),
                        jnp.asarray(target), jnp.asarray(weight), jnp.asarray(valid),
                        jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(kd), jnp.int32(t0),
                        jnp.int32(nfree), jnp.asarray(bounds), jnp.float32(lmbda), W=W, Md=Md,
                        iterations=iters, clamp_mode="train")
    tp, td = tsolver.ba(_t(poses), _t(ctr), _t(intr), _t(target), _t(weight), _t(valid),
                        _t(ii).long(), _t(jj).long(), _t(kd).long(), t0, nfree, _t(bounds),
                        lmbda, W=W, Md=Md, iterations=iters, clamp_mode="train")
    return (np.asarray(jp), np.asarray(jd)), (tp.numpy(), td.numpy())


@pytest.mark.parametrize("case", ["perturbed", "structure_only"])
def test_ba_matches_jax_solver(case):
    """The test_ba.py problems: the port's solver (Gauss-Jordan plain
    version) against the JAX solver (Cholesky on the CPU). Both converge;
    differences are f32 summation order and the two factorizations."""
    poses_gt, ctr_gt, intr, target, ii, jj, kd = (np.asarray(x) for x in
                                                   synthetic_problem(jax.random.PRNGKey(0)))
    n = poses_gt.shape[0]
    if case == "perturbed":
        kp, kd2 = jax.random.split(jax.random.PRNGKey(1))
        dxi = 0.02 * jax.random.normal(kp, (n, 6)).at[0].set(0.0)
        poses0 = np.asarray(jse3.retr(jnp.asarray(poses_gt), dxi))
        ctr0 = ctr_gt.copy()
        ctr0[:, 2] *= 1.0 + 0.2 * np.asarray(jax.random.normal(kd2, (ctr_gt.shape[0],)))
        t0, nfree = 1, n - 1
    else:
        poses0, ctr0 = poses_gt, ctr_gt.copy()
        ctr0[:, 2] *= 1.3
        t0, nfree = 0, 0
    (jp, jd), (tp, td) = _ba_both(poses0, ctr0, intr, target, ii, jj, kd, t0, nfree, W=8,
                                  iters=8)
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    np.testing.assert_allclose(td, jd, rtol=1e-3, atol=1e-4)


def test_ba_invalid_edges_and_runtime_window():
    """Masked garbage edges and a runtime-style window (t0 > 1, fewer free
    poses than W), two iterations, runtime clamp."""
    poses_gt, ctr_gt, intr, target, ii, jj, kd = (np.asarray(x) for x in
                                                   synthetic_problem(jax.random.PRNGKey(3)))
    n = poses_gt.shape[0]
    dxi = 0.02 * jax.random.normal(jax.random.PRNGKey(4), (n, 6)).at[0].set(0.0)
    poses0 = np.asarray(jse3.retr(jnp.asarray(poses_gt), dxi))
    pad = 100
    ii_p = np.concatenate([ii, np.zeros(pad, np.int32)])
    jj_p = np.concatenate([jj, np.ones(pad, np.int32)])
    kd_p = np.concatenate([kd, np.zeros(pad, np.int32)])
    target_p = np.concatenate([target, 1e6 * np.ones((pad, 2), np.float32)])
    weight = np.concatenate([np.ones((len(ii), 2)), 7.0 * np.ones((pad, 2))]).astype(np.float32)
    valid = np.concatenate([np.ones(len(ii), bool), np.zeros(pad, bool)])
    (jp, jd), (tp, td) = _ba_both(poses0, ctr_gt, intr, target_p, ii_p, jj_p, kd_p, 2, 3,
                                  W=8, iters=2, weight=weight, valid=valid, lmbda=1e-4)
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    np.testing.assert_allclose(td, jd, rtol=1e-3, atol=1e-4)


def test_assemble_normal_eqs_matches():
    poses, ctr, intr, target, ii, jj, kd = (np.asarray(x) for x in
                                            synthetic_problem(jax.random.PRNGKey(5)))
    E, Md, W = len(ii), ctr.shape[0], 8
    w = np.random.default_rng(9).uniform(0.1, 1.0, (E, 2)).astype(np.float32)
    bounds = np.array([-64.0, -64.0, 224.0, 184.0], np.float32)
    jprob = jsolver.BAProblem(*(jnp.asarray(x) for x in (poses, ctr, intr, target, w)),
                              jnp.ones(E, bool), jnp.asarray(ii), jnp.asarray(jj),
                              jnp.asarray(kd), jnp.int32(1), jnp.int32(5))
    want = jsolver.assemble_normal_eqs(jprob, jnp.asarray(bounds), W=W, Md=Md)
    tprob = tsolver.BAProblem(_t(poses), _t(ctr), _t(intr), _t(target), _t(w),
                              torch.ones(E, dtype=torch.bool), _t(ii).long(), _t(jj).long(),
                              _t(kd).long(), 1, 5)
    got = tsolver.assemble_normal_eqs(tprob, _t(bounds), W=W, Md=Md)
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)
        np.testing.assert_allclose(g.numpy(), wnt, rtol=1e-4, atol=1e-4 * np.abs(wnt).max())


def test_schur_solve_nonfinite_gives_zero_update():
    """A NaN in the system makes the whole update zero (ref ba.py:17-27)."""
    W, Md = 2, 5
    B6 = torch.eye(6 * W)
    E6 = torch.zeros(6 * W, Md)
    C = torch.ones(Md)
    C[0] = float("nan")
    u = torch.ones(Md)
    v6 = torch.ones(6 * W)
    B6[0, 0] = float("nan")
    dX, dZ = tsolver.schur_solve(B6, E6, C, u, v6, 1e-4, 2, W=W)
    assert (dX == 0).all() and (dZ == 0).all()
