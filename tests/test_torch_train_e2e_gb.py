"""tests/test_torch_train_e2e.py's parity of the training unroll under
CENTROID_SEL_STRAT GRADIENT_BIAS: the port's unroll selects its patches
from JAX's candidate draws as the JAX patchifier does, and its loss, each
step's supervision and every gradient leaf match JAX's. (Before the port
had the strategy, a GRADIENT_BIAS configuration trained on RANDOM patches
without a word.)"""

import numpy as np
import pytest

import test_torch_train_e2e as e2e
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)

GB = "GRADIENT_BIAS"


@pytest.fixture(scope="module")
def train_runs():
    """tests/test_torch_train_e2e.py's clip, weights and key under
    GRADIENT_BIAS: JAX's value_and_grad and the port's backward pass."""
    mp = pytest.MonkeyPatch()
    e2e.init_frames_3(mp)
    try:
        yield e2e.run_both(structure_only=False, strategy=GB)
    finally:
        mp.undo()


def test_train_step_gradient_bias_matches_jax(train_runs):
    """A GRADIENT_BIAS configuration trains on gradient-selected patches:
    the loss and every gradient leaf of the port's unroll against JAX's
    (whose patchifier selects from the same candidates), and each step's
    supervision (valid, coords) within tests/test_torch_train_e2e.py's
    tolerances."""
    jx, port = train_runs
    assert np.isfinite(port["loss"])
    np.testing.assert_allclose(port["loss"], jx["loss"], rtol=e2e.LOSS_RTOL)
    errs = e2e.grad_errors(jx["grads"], port["nets"])
    bad = {k: (d, n) for k, (d, n) in errs.items() if d > e2e.GRAD_REL * n + e2e.GRAD_FLOOR}
    assert not bad, bad
    assert sum(n for _, n in errs.values()) > 0
    for (jv, jc, _, _, _), (tv, tc, _, _, _) in zip(jx["traj"], port["traj"]):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), atol=e2e.COORDS_ATOL,
                                   rtol=0)
