"""Package rules of dpvo_tpu_torch: it imports neither JAX nor the JAX
package, its entry point asks for the card unless told otherwise, and a
kernel wrapper handed a non-CPU request launches its kernel or raises —
it never falls back to the plain version."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread on the CPU for a module's tests: the suite
    runs in parallel workers, and a default pool of one thread per core in
    each of them oversubscribes the host. Every tests/test_torch_*.py that
    runs torch on the CPU imports it, which makes it autouse there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import dpvo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dpvo_tpu_torch.__path__, "dpvo_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "dpvo_tpu"))
print(len(names), bad, all(m in names for m in REQUIRED))
"""
# modules the import check must reach (each slice's since the loop closures')
REQUIRED = ("dpvo_tpu_torch.slam.proximity", "dpvo_tpu_torch.ba.gba_sparse",
            "dpvo_tpu_torch.runtime.dpvo", "dpvo_tpu_torch.lie.sim3", "dpvo_tpu_torch.slam.pgo",
            "dpvo_tpu_torch.slam.retrieval", "dpvo_tpu_torch.slam.long_term",
            "dpvo_tpu_torch.eval.ate", "dpvo_tpu_torch.models.vonet", "dpvo_tpu_torch.train",
            "dpvo_tpu_torch.train.step", "dpvo_tpu_torch.train.loss", "dpvo_tpu_torch.train.logger",
            "dpvo_tpu_torch.data.augmentation", "dpvo_tpu_torch.data.factory",
            "dpvo_tpu_torch.apps.train", "dpvo_tpu_torch.utils.npse3",
            "dpvo_tpu_torch.utils.optional", "dpvo_tpu_torch.eval.export",
            "dpvo_tpu_torch.eval.protocol", "dpvo_tpu_torch.deploy.export",
            "dpvo_tpu_torch.runtime.torch_port", "dpvo_tpu_torch.data.stream",
            "dpvo_tpu_torch.data.frame_utils", "dpvo_tpu_torch.data.rgbd_utils",
            "dpvo_tpu_torch.data.tartan", "dpvo_tpu_torch.apps.viewer",
            "dpvo_tpu_torch.apps.common", "dpvo_tpu_torch.apps.demo",
            "dpvo_tpu_torch.apps.eval_synthetic", "dpvo_tpu_torch.apps.evaluate_tartan",
            "dpvo_tpu_torch.apps.evaluate_euroc", "dpvo_tpu_torch.apps.evaluate_tum",
            "dpvo_tpu_torch.apps.evaluate_kitti", "dpvo_tpu_torch.apps.evaluate_icl_nuim",
            "dpvo_tpu_torch.apps.export_network", "dpvo_tpu_torch.apps.extract_frames")


def test_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    code = f"REQUIRED = {REQUIRED!r}\n" + _IMPORT_ALL
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad, required = out.stdout.strip().split(" ", 2)
    assert int(count) >= 69 and bad == "[]" and required == "True", out.stdout


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


_LC_KW = dict(BUFFER_SIZE=16, PATCHES_PER_FRAME=4, DIM=32, FDIM=16, E_MAX=64, E_INAC_MAX=64,
              M_OPT_MAX=32, W_OPT_MAX=8, MAX_EDGE_AGE=8, MIXED_PRECISION=False)


def test_loop_closure_is_ported_classic_is_not():
    """Both loop-closure backends build a tracker: LOOP_CLOSURE (proximity,
    config/slam.yaml) and, with OpenCV for its ORB detector,
    CLASSIC_LOOP_CLOSURE (retrieval, Sim(3), PGO), which now is ported too
    (the name is the test's from before that port)."""
    pytest.importorskip("cv2")
    from dpvo_tpu_torch import DPVO, load_config
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.slam.long_term import LongTermLoopClosure

    assert load_config(os.path.join(ROOT, "config", "slam.yaml")).LOOP_CLOSURE
    slam = DPVO(Config(LOOP_CLOSURE=True, **_LC_KW), None, 32, 32, device="cpu")
    assert slam.ran_global_ba == set() and slam.oracle is None and slam.long_term_lc is None
    slam = DPVO(Config(CLASSIC_LOOP_CLOSURE=True, **_LC_KW), None, 32, 32, device="cpu")
    assert isinstance(slam.long_term_lc, LongTermLoopClosure)
    assert slam.long_term_lc.retrieval.detect is None  # OpenCV's ORB, made at the first image
    slam.long_term_lc.close()


def test_classic_loop_closure_without_opencv_needs_a_detector(monkeypatch):
    """Without OpenCV and without a detector a CLASSIC_LOOP_CLOSURE tracker
    raises (it never disables itself); a detector the caller gives is
    enough."""
    import sys

    from dpvo_tpu_torch import DPVO
    from dpvo_tpu_torch.config import Config

    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 fails
    cfg = Config(CLASSIC_LOOP_CLOSURE=True, **_LC_KW)
    with pytest.raises(RuntimeError, match="OpenCV"):
        DPVO(cfg, None, 32, 32, device="cpu")
    detect = lambda image: (np.zeros((0, 2), np.float32), np.zeros((0, 32), np.uint8))
    slam = DPVO(cfg, None, 32, 32, device="cpu", detect=detect)
    assert slam.long_term_lc.retrieval.detect is detect
    slam.long_term_lc.close()


def test_card_tracker_rejects_a_window_beyond_the_pose_solve(monkeypatch):
    """The card's SPD kernel solves at most MAX_N unknowns: a configuration
    with more is refused when the tracker is built, not at its first BA."""
    from dpvo_tpu_torch import DPVO
    from dpvo_tpu_torch.ba.spd_solve import MAX_N
    from dpvo_tpu_torch.config import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)  # no card is touched
    cfg = Config(BUFFER_SIZE=16, PATCHES_PER_FRAME=4, DIM=32, FDIM=16, E_MAX=64,
                 E_INAC_MAX=64, M_OPT_MAX=32, W_OPT_MAX=MAX_N // 6 + 1, MIXED_PRECISION=False)
    with pytest.raises(ValueError, match="W_OPT_MAX"):
        DPVO(cfg, None, 32, 32, device="cuda")
    assert DPVO(cfg, None, 32, 32, device="cpu").device.type == "cpu"


def test_train_entry_point_needs_a_card(monkeypatch):
    """python -m dpvo_tpu_torch.apps.train runs on the card unless --device
    cpu; without a card it raises."""
    from dpvo_tpu_torch.apps import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--dataset", "synthetic", "--steps", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.resolve_device("cuda")
    assert train.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("flags, item", [(["--mesh", "2,4"], "item 8")])
def test_train_entry_point_unported_options_raise(flags, item):
    """The options whose pieces are not ported name their ROADMAP item
    (--init_encoders and --dataset tartan are ported: tests/test_torch_deploy.py
    and tests/test_torch_data.py run them)."""
    from dpvo_tpu_torch.apps import train

    args = ["--device", "cpu", "--steps", "0"] + flags
    if "--dataset" not in flags:
        args += ["--dataset", "synthetic"]
    with pytest.raises(NotImplementedError, match=item):
        train.main(args)


def _requests(device):
    """One request per wrapper, on the given device."""
    from dpvo_tpu_torch.ba.segsum import segment_sum
    from dpvo_tpu_torch.ba.spd_solve import spd_solve
    from dpvo_tpu_torch.ops import corr_pallas as cp
    from dpvo_tpu_torch.ops.corr_cuda import corr_backward, corr_features

    t = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype, device=device)
    i = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    bf = torch.bfloat16
    return {
        "corr": lambda: corr_features(t(4, 8, 3, 3), t(2, 8, 8, 8), t(2, 2, 2, 8),
                                      t(5, 3, 3, 2), i(5), i(5), t(5, dtype=torch.bool)),
        "corr_bwd": lambda: corr_backward(t(5, 9, 128, dtype=bf), t(4, 8, 3, 3), t(2, 8, 8, 8),
                                          t(2, 2, 2, 8), t(5, 3, 3, 2), i(5), i(5),
                                          t(5, dtype=torch.bool))[0],
        "segsum": lambda: segment_sum(t(6, 3), i(6), i(6), 4),
        "segsum_bf16": lambda: segment_sum(t(6, 8, dtype=bf), i(6), i(6), 4),
        "spd_solve": lambda: spd_solve(torch.eye(4, device=device), t(4)),
        "corr_window": lambda: cp.corr_window(t(5, 9, 32, dtype=bf), t(2, 8, 8, 32, dtype=bf),
                                              i(5), t(5, dtype=torch.bool), i(5, 9), i(5, 9)),
        "corr_sw_fused": lambda: cp.corr_sw_fused(
            t(5, 9, 32, dtype=bf), t(2, 8, 8, 32, dtype=bf), i(5), t(5, dtype=torch.bool), i(5),
            i(5), i(5, 9), i(5, 9), t(5, 9), t(5, 9), t(5, 9)),
        "corr_v3_fused": lambda: cp.corr_v3_fused(
            t(5, 9, 32, dtype=bf), t(2, 8, 8, 32, dtype=bf), i(5), t(5, dtype=torch.bool), i(5),
            i(5), i(5, 9), i(5, 9), t(5, 9), t(5, 9), t(5, 9)),
    }


KERNELS = ["corr", "segsum", "segsum_bf16", "spd_solve", "corr_window", "corr_sw_fused",
           "corr_v3_fused", "corr_bwd"]


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
    monkeypatch.setattr(corr_cuda, "corr_backward_plain", forbidden)
    monkeypatch.setattr(segsum, "segment_sum_plain", forbidden)
    monkeypatch.setattr(spd, "spd_solve_plain", forbidden)
    for plain in ("corr_window_plain", "superwindow_plain", "epilogue_sw_plain",
                  "epilogue_v3_plain", "corr_sw_fused_plain", "corr_v3_fused_plain"):
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


def test_launch_counts_survive_threads():
    """Launches counted from several threads at once (the PGO executor beside
    the tracking thread) are all kept, with a tiny switch interval; the
    count is a read-modify-write, which the interpreter does not promise to
    keep whole without the lock."""
    import threading

    from dpvo_tpu_torch import kernels

    before = kernels.LAUNCHES["segsum"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [kernels.count("segsum") for _ in range(2000)])
                   for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert kernels.LAUNCHES["segsum"] - before == 16 * 2000
    kernels.LAUNCHES["segsum"] = before


def test_kernel_library_needs_a_card(monkeypatch):
    from dpvo_tpu_torch import kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(kernels, "_lib", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.load()
