"""Port parity of a structure-only training step (the first 1000 steps of
a fresh start: every pose held at the ground truth, BA solves depths
only): vo_forward's outputs, the clip loss and the gradients against
dpvo_tpu's, and the port's train step on the same clip. The setup and
tolerances are test_torch_train_e2e.py's; this file is apart so that the
two JAX compilations run side by side."""

import copy

import numpy as np
import pytest
import torch

from dpvo_tpu_torch.config import Config
from dpvo_tpu_torch.train import make_optimizer, make_train_step
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_train_e2e import (CFG_KW, COORDS_ATOL, GRAD_FLOOR, GRAD_REL, KEY, LOSS_RTOL,
                                  POSES_ATOL, STEPS, grad_errors, init_frames_3, jax_draws,
                                  run_both, tiny_clip)

import jax


@pytest.fixture(scope="module")
def both():
    mp = pytest.MonkeyPatch()
    init_frames_3(mp)
    try:
        yield run_both(structure_only=True)
    finally:
        mp.undo()


def test_structure_only_holds_the_poses(both):
    """Every step's poses are the ground truth, in both packages."""
    jx, port = both
    poses = tiny_clip()[1]
    for (*_, jG, _), (*_, tG, _) in zip(jx["traj"], port["traj"]):
        np.testing.assert_allclose(np.asarray(jG), poses, atol=1e-6)
        np.testing.assert_allclose(tG.detach().numpy(), poses, atol=1e-6)


def test_structure_only_matches_jax(both):
    jx, port = both
    for (jv, jc, _, jG, jn), (tv, tc, _, tG, tn) in zip(jx["traj"], port["traj"]):
        assert tn == jn
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), atol=COORDS_ATOL, rtol=0)
        np.testing.assert_allclose(tG.detach().numpy(), np.asarray(jG), atol=POSES_ATOL, rtol=0)
    np.testing.assert_allclose(port["loss"], jx["loss"], rtol=LOSS_RTOL)
    for k in port["metrics"]:
        np.testing.assert_allclose(port["metrics"][k], jx["metrics"][k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)


def test_structure_only_gradients_match_jax(both):
    jx, port = both
    errs = grad_errors(jx["grads"], port["nets"])
    bad = {k: (d, n) for k, (d, n) in errs.items() if d > GRAD_REL * n + GRAD_FLOOR}
    assert not bad, bad


def test_train_step_structure_only(both, monkeypatch):
    """The port's train step on the same clip and draws: its loss is the
    unroll's above, its gradient norm positive, and the parameters move by
    the optimizer's first update."""
    jx, port = both
    init_frames_3(monkeypatch)
    nets = copy.deepcopy(port["nets"])
    before = {k: p.detach().clone() for k, p in nets.named_parameters()}
    tx, _ = make_optimizer(lr=1e-4, total_steps=100)
    opt = tx.init(before)
    images, poses, disps, intr = tiny_clip()
    batch = dict(images=images[None], poses=poses[None], disps=disps[None],
                 intrinsics=intr[None])
    step = make_train_step(Config(**CFG_KW), tx, STEPS=STEPS)
    nets, opt, m = step(nets, opt, batch, [jax_draws(jax.random.PRNGKey(KEY))],
                        structure_only=True)
    assert set(m) == {"loss", "gnorm", "flow", "tr", "ro", "px1"}
    np.testing.assert_allclose(float(m["loss"]), port["loss"], rtol=1e-6)
    assert np.isfinite(float(m["gnorm"])) and float(m["gnorm"]) > 0
    assert opt["count"] == 1
    moved = [k for k, p in nets.named_parameters() if not torch.equal(p, before[k])]
    assert len(moved) > 0.9 * len(before)
