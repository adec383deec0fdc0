"""The training runner (``runners/train.py``) on the CPU at a small size:
a sound run of the tiny training cell is correct; the control (the
reference in fp8 in the port's place) and each fault planted in the
program are not; the comparison's arithmetic on fixed readings."""

from __future__ import annotations

import math

import pytest

from bench_port.tests import tiny

SECONDS = 1.0


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def test_a_sound_run_is_correct(root):
    result, lines = tiny.run(root, SECONDS, cell=tiny.TRAIN)
    assert result["correct"], lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == {"grad_gap", "fnet_grad", "param_gap"}
    assert list(result)[-1] == "checks"
    # the window's frames: 4-frame clips, batch 1, whole steps
    m = result["metrics"]["frames_per_s"]["value"]
    assert m > 0 and "setup_s" in result["metrics"]


@pytest.mark.parametrize("fault", ["unchanged", "zero_update_grads", "no_clip", "corr_bwd_scale",
                                   "corr_bwd_shift"])
def test_a_fault_is_not_correct(root, fault):
    result, lines = tiny.run(root, SECONDS, cell=tiny.TRAIN, fault=fault)
    assert not result["correct"], lines


def test_the_control_is_not_correct(root):
    """The control: the plain reference in fp8, the step below the
    configuration's precision, in the program's place."""
    result, lines = tiny.run(root, SECONDS, cell=tiny.TRAIN, control=True)
    assert not result["correct"], lines


def test_the_comparison_by_the_worst_leaf():
    import torch

    from bench_port.runners.train import compare, verdict

    T = lambda *v: torch.tensor(v, dtype=torch.float64)
    ref = dict(loss=[10.0, 8.0, 6.0],
               grad={"update.a": T(1.0), "update.b": T(2.0), "update.c": T(4.0),
                     "patchifier.fnet.z": T(1e-6), "patchifier.fnet.w": T(3.0, 4.0),
                     "patchifier.inet.y": T(3.0)},
               change={"update.a": T(1.0), "update.b": T(1.0), "update.c": T(1.0),
                       "patchifier.fnet.z": T(5.0), "patchifier.fnet.w": T(0.0, 1.0),
                       "patchifier.inet.y": T(1.0)})
    prog = dict(loss=[10.0, 8.4, 6.0],
                grad={"update.a": T(1.5), "update.b": T(2.0), "update.c": T(4.4),
                      "patchifier.fnet.z": T(0.0), "patchifier.fnet.w": T(4.0, 3.0),
                      "patchifier.inet.y": T(6.0)},
                change={"update.a": T(1.0), "update.b": T(0.9), "update.c": T(1.0),
                        "patchifier.fnet.z": T(0.0), "patchifier.fnet.w": T(1.0, 0.0),
                        "patchifier.inet.y": T(1.0)})
    row = compare(prog, ref)
    assert row["loss_gaps"] == pytest.approx([0.0, 0.05, 0.0]) and row["losses_finite"]
    # update.a: 0.5 over the median leaf's 2.5; update.c: 0.4 over its own 4;
    # the encoders' worst leaf (inet.y: 3 over 3) is logged, not compared
    assert row["grad_gap"] == pytest.approx(0.2) and row["grad_leaf"] == "update.a"
    assert row["inet_worst"] == pytest.approx(1.0)
    # fnet.w's gradient has its norm and points elsewhere: no gap of norms
    # sees it, the encoder's difference does (sqrt(2) over 5)
    assert row["fnet_worst"] == pytest.approx(0.0, abs=1e-6)
    assert row["fnet_grad"] == pytest.approx(2 ** 0.5 / 5)
    # fnet.z's gradient is under a thousandth of the median leaf's: out of the change
    assert row["left_out"] == ["patchifier.fnet.z"] and row["param_gap"] == pytest.approx(0.1)
    limits = {"grad_gap": 0.3, "fnet_grad": 0.3, "param_gap": 0.2}
    ok, numbers = verdict(row, limits)
    assert ok and numbers == {"grad_gap": {"value": pytest.approx(0.2), "limit": 0.3},
                              "fnet_grad": {"value": pytest.approx(0.2828, abs=1e-4),
                                            "limit": 0.3},
                              "param_gap": {"value": pytest.approx(0.1), "limit": 0.2}}
    assert not verdict(row, dict(limits, grad_gap=0.15))[0]
    assert not verdict(row, dict(limits, fnet_grad=0.25))[0]
    assert not verdict(row, {"grad_gap": 0.3, "param_gap": 0.2})[0]   # a limit missing
    prog["loss"][1] = math.nan
    assert not verdict(compare(prog, ref), limits)[0]
    prog["loss"][1] = 8.4
    prog["change"]["update.b"] = T(math.nan)   # a NaN leaf reads inf, whatever the others read
    row = compare(prog, ref)
    assert row["param_gap"] == math.inf and row["param_leaf"] == "update.b"
    assert not verdict(row, dict(limits, param_gap=1))[0]
