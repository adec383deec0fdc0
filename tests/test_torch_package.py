"""Package rules of dpvo_tpu_torch: it imports neither JAX nor the JAX
package, its entry point asks for the card unless told otherwise, and a
kernel wrapper handed a non-CPU request launches its kernel or raises —
it never falls back to the plain version."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import dpvo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dpvo_tpu_torch.__path__, "dpvo_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "dpvo_tpu"))
print(len(names), bad)
"""


def test_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 25 and bad == "[]", out.stdout


def test_dpvo_without_device_needs_a_card(monkeypatch):
    from dpvo_tpu_torch import DPVO
    from dpvo_tpu_torch.config import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(BUFFER_SIZE=16, PATCHES_PER_FRAME=4, DIM=32, FDIM=16, E_MAX=64,
                 E_INAC_MAX=64, M_OPT_MAX=32, W_OPT_MAX=8, MIXED_PRECISION=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DPVO(cfg, None, 32, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        DPVO(cfg, None, 32, 32, device="cuda")
    assert DPVO(cfg, None, 32, 32, device="cpu").device.type == "cpu"


def _requests(device):
    """One request per wrapper, on the given device."""
    from dpvo_tpu_torch.ba.segsum import segment_sum
    from dpvo_tpu_torch.ba.spd_solve import spd_solve
    from dpvo_tpu_torch.ops import corr_pallas as cp
    from dpvo_tpu_torch.ops.corr_cuda import corr_features

    t = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype, device=device)
    i = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    bf = torch.bfloat16
    return {
        "corr": lambda: corr_features(t(4, 8, 3, 3), t(2, 8, 8, 8), t(2, 2, 2, 8),
                                      t(5, 3, 3, 2), i(5), i(5), t(5, dtype=torch.bool)),
        "segsum": lambda: segment_sum(t(6, 3), i(6), i(6), 4),
        "spd_solve": lambda: spd_solve(torch.eye(4, device=device), t(4)),
        "corr_window": lambda: cp.corr_window(t(5, 9, 32, dtype=bf), t(2, 8, 8, 32, dtype=bf),
                                              i(5), t(5, dtype=torch.bool), i(5, 9), i(5, 9)),
        "corr_sw": lambda: cp.superwindow_sw(t(5, 9, 32, dtype=bf), t(2, 8, 8, 32, dtype=bf),
                                             i(5), t(5, dtype=torch.bool), i(5), i(5)),
        "corr_v3": lambda: cp.superwindow_v3(t(5, 9, 32, dtype=bf), t(2, 8, 8, 32, dtype=bf),
                                             i(5), t(5, dtype=torch.bool), i(5), i(5)),
        "corr_v3_epi": lambda: cp.epilogue_v3(t(5, 9, 384, dtype=bf), i(5, 9), i(5, 9),
                                              t(5, 9), t(5, 9), t(5, 9)),
    }


KERNELS = ["corr", "segsum", "spd_solve", "corr_window", "corr_sw", "corr_v3", "corr_v3_epi"]


@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_never_falls_back(name, monkeypatch):
    """A request on a non-CPU device (the meta device stands in for a card
    here) raises, and the plain version is not run."""
    import dpvo_tpu_torch.ba.segsum as segsum
    import dpvo_tpu_torch.ba.spd_solve as spd
    import dpvo_tpu_torch.ops.corr_cuda as corr_cuda
    import dpvo_tpu_torch.ops.corr_pallas as corr_pallas

    def forbidden(*a, **k):
        raise AssertionError("plain version ran for a non-CPU request")

    monkeypatch.setattr(corr_cuda, "corr_features_plain", forbidden)
    monkeypatch.setattr(segsum, "segment_sum_plain", forbidden)
    monkeypatch.setattr(spd, "spd_solve_plain", forbidden)
    for plain in ("corr_window_plain", "superwindow_plain", "epilogue_v3_plain"):
        monkeypatch.setattr(corr_pallas, plain, forbidden)
    with pytest.raises((ValueError, RuntimeError)):
        _requests("meta")[name]()


@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_runs_plain_on_cpu(name):
    from dpvo_tpu_torch import kernels

    before = dict(kernels.LAUNCHES)
    out = _requests("cpu")[name]()
    assert out.device.type == "cpu"
    assert kernels.LAUNCHES == before  # CPU requests launch nothing


def test_kernel_library_needs_a_card(monkeypatch):
    from dpvo_tpu_torch import kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(kernels, "_lib", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.load()
