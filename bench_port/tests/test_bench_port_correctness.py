"""``correct`` on the CPU at a small size: a sound run of the tiny cell is
correct; the control (the reference in fp8 in the port's place) and each
fault the cell can have, planted under the timed path, are not. The
tiny cell keeps the dpvo cell's limits."""

from __future__ import annotations

import pytest

from bench_port.tests import tiny

SECONDS = 26.0


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _port(fault=None):
    def make(config, weights, device, seq):
        from dpvo_tpu_torch.config import Config
        from dpvo_tpu_torch.runtime.dpvo import DPVO

        slam = DPVO(Config(**config["config"]), weights, config["ht"], config["wd"],
                    device=device, draws=seq.draws)
        if fault is not None:
            fault(slam)
        return slam
    return make


def unchanged(slam):
    """The update round returns the state it was given."""
    slam.steps._update = lambda *a, **k: None


def half_the_edges(slam):
    """The window BA leaves out the second half of the edges (their
    weights zero), solving over the rest."""
    real = slam.steps._window_ba

    def ba(state, es, target, weight, t0, nfree):
        w = weight.clone()
        w[w.shape[0] // 2:] = 0
        return real(state, es, target, w, t0, nfree)

    slam.steps._window_ba = ba


def altered_pose(slam):
    """The newest pose the window BA produces is moved by 1 cm."""
    real = slam.steps._window_ba

    def ba(state, es, target, weight, t0, nfree):
        real(state, es, target, weight, t0, nfree)
        state.poses[slam.n - 1, 0] += 0.01

    slam.steps._window_ba = ba


def test_a_sound_run_is_correct(root):
    result, lines = tiny.run(root, SECONDS, tracker=_port())
    assert result["checks"]["checks"]["value"] == 2, lines
    assert result["correct"], lines


@pytest.mark.parametrize("fault", [unchanged, half_the_edges, altered_pose],
                         ids=lambda f: f.__name__)
def test_a_fault_is_not_correct(root, fault):
    result, lines = tiny.run(root, SECONDS, tracker=_port(fault))
    assert not result["correct"], lines


def test_the_control_is_not_correct(root):
    """The control: the plain reference in fp8, the step below the
    configuration's bf16, in the port's place."""
    def make(config, weights, device, seq):
        from bench_port.reference.config import Config
        from bench_port.reference.runtime.dpvo import DPVO

        return DPVO(Config(**config["config"]), weights, config["ht"], config["wd"], device,
                    draws=seq.draws, precision="fp8")

    result, lines = tiny.run(root, SECONDS, tracker=make)
    assert result["checks"]["checks"]["value"] == 2, lines
    assert not result["correct"], lines
