"""The port's evaluation layer against the JAX package's: timestamp
association and ATE, the protocol's medians, AVG and AUC, the TUM, PLY
and COLMAP writers (byte for byte), and the colours through a keyframe
removal (the colours and the point cloud against the JAX tracker are in
tests/test_torch_slice.py, on its runs)."""

import contextlib
import io

import numpy as np
import pytest
import torch

from dpvo_tpu.eval import ate as j_ate
from dpvo_tpu.eval import export as j_export
from dpvo_tpu.eval import protocol as j_protocol
from dpvo_tpu_torch.eval import ate as t_ate
from dpvo_tpu_torch.eval import export as t_export
from dpvo_tpu_torch.eval import protocol as t_protocol
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)


def _poses(rng, n):
    p = np.zeros((n, 7), np.float32)
    p[:, :3] = rng.normal(size=(n, 3))
    q = rng.normal(size=(n, 4))
    p[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    return p


def test_associate_and_ate_match_jax():
    rng = np.random.default_rng(0)
    t_gt = np.sort(rng.uniform(0, 10, 200))
    t_est = np.sort(np.concatenate([t_gt[::3] + rng.normal(0, 0.01, 67), [20.0, -3.0]]))
    for max_dt in (0.005, 0.02, 0.1):
        got, want = t_ate.associate(t_est, t_gt, max_dt), j_ate.associate(t_est, t_gt, max_dt)
        assert len(got[0]) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    est, gt = rng.normal(size=(50, 3)), rng.normal(size=(50, 3))
    for scale in (True, False):
        assert t_ate.ate_rmse(est, gt, scale) == j_ate.ate_rmse(est, gt, scale)
    assert t_ate.ate_rmse(np.zeros((5, 3)), gt[:5]) == j_ate.ate_rmse(np.zeros((5, 3)), gt[:5])


def test_protocol_scores_match_jax(monkeypatch):
    """The same trial trajectories scored by both protocols: the same
    printed report (trials, medians, AVG, AUC), the same medians, and the
    port's AVG and AUC are what the JAX report prints."""
    rng = np.random.default_rng(1)
    gt = {}
    for seq, n in (("a", 40), ("b", 25), ("c", 30)):
        gt[seq] = (np.arange(n) * 0.1, np.cumsum(rng.normal(size=(n, 3)), 0))
    runs_ = {seq: [(np.concatenate([g[1] + rng.normal(0, s, g[1].shape),
                                    _poses(rng, len(g[0]))[:, 3:]], 1), g[0])
                    for s in (0.05, 0.3, 0.9)] for seq, g in gt.items()}
    del gt["c"]  # a sequence without ground truth is skipped

    def fake(calls):
        def run_stream(cfg, network, frames, **kw):
            seq = frames
            return runs_[seq][calls.setdefault(seq, iter(range(3))).__next__()]
        return run_stream

    seqs = {seq: (lambda s=seq: s) for seq in runs_}
    reports = []
    for mod in (j_protocol, t_protocol):
        monkeypatch.setattr(mod, "run_stream", fake({}))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = mod.evaluate_sequences(None, None, seqs, gt, trials=3, max_dt=0.05, title="t")
        reports.append((buf.getvalue(), out))
    (j_txt, j_med), (t_txt, t_out) = reports
    assert t_txt == j_txt
    assert t_out["median"] == j_med
    printed = {ln.split()[0]: float(ln.split()[1]) for ln in j_txt.splitlines()
               if ln.startswith(("AVG", "AUC"))}
    assert f"{t_out['avg']:.6f}" == f"{printed['AVG']:.6f}"
    assert f"{t_out['auc']:.6f}" == f"{printed['AUC']:.6f}"
    medians, avg, auc = t_protocol.summarize(t_out["trials"])
    assert (medians, avg, auc) == (t_out["median"], t_out["avg"], t_out["auc"])


def test_writers_are_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(2)
    poses = _poses(rng, 7)
    ts = np.arange(7) * 0.05 + 1e9
    pts = rng.normal(size=(40, 3)).astype(np.float32) * 3
    pts[3] = np.nan
    pts[5, 1] = 1e7
    clr = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    intr = np.array([100.5, 101.0, 60.25, 40.0], np.float32)
    for side, mod in (("j", j_export), ("t", t_export)):
        mod.save_trajectory_tum(str(tmp_path / side / "traj.txt"), poses, ts)
        mod.save_ply(str(tmp_path / side / "cloud.ply"), pts, clr)
        mod.save_colmap(str(tmp_path / side / "colmap"), poses, intr, pts, clr, ht=80, wd=120)
    for rel in ("traj.txt", "cloud.ply", "colmap/cameras.txt", "colmap/images.txt",
                "colmap/points3D.txt"):
        got, want = (tmp_path / "t" / rel).read_bytes(), (tmp_path / "j" / rel).read_bytes()
        assert got == want and len(got) > 0, rel


def test_plot_needs_matplotlib(tmp_path, monkeypatch):
    import sys

    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(3)
    t_export.plot_trajectory(str(tmp_path / "p.pdf"), _poses(rng, 5), gt=_poses(rng, 5))
    assert (tmp_path / "p.pdf").stat().st_size > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        t_export.plot_trajectory(str(tmp_path / "q.pdf"), _poses(rng, 5))


def test_colors_follow_a_keyframe_removal():
    """A keyframe cull moves each later frame's colours down one row, with
    its pose."""
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.runtime.dpvo import DPVO

    cfg = Config(BUFFER_SIZE=16, PATCHES_PER_FRAME=4, DIM=32, FDIM=16, E_MAX=64,
                 E_INAC_MAX=64, M_OPT_MAX=32, W_OPT_MAX=8, PMEM=8, MEM=8,
                 MIXED_PRECISION=False)
    slam = DPVO(cfg, None, 32, 32, device="cpu")
    st = slam.state
    st.colors.copy_(torch.arange(st.colors.numel()).reshape(st.colors.shape) % 251)
    st.poses[:, 0] = torch.arange(16.0)
    before_c, before_p = st.colors.clone(), st.poses.clone()
    slam.steps._keyframe_shift(st, 3, 9)
    assert torch.equal(st.colors[:3], before_c[:3]) and torch.equal(st.colors[3:9], before_c[4:10])
    assert torch.equal(st.poses[3:9], before_p[4:10])
