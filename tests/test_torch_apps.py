"""The port's entry points on the CPU at the tiny configuration: the
evaluate_* scripts on generated dataset layouts (the analogs of
tests/test_dataset_fixtures.py, plus ICL-NUIM and TartanAir), the demo
with every writer, eval_synthetic, extract_frames, the viewer (the analogs of tests/test_viewer.py), and every entry point's
refusal to run without a card unless --device cpu."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_package import ROOT, one_torch_thread  # noqa: F401 (autouse fixture)

cv2 = pytest.importorskip("cv2")
sys.path.insert(0, os.path.join(ROOT, "apps"))  # the JAX package's entry points

WEIGHTS = os.path.join(ROOT, "tests", "fixtures", "tiny_synth.npz")
TINY = [str(x) for kv in chip_smoke.SMALL_CFG.items() for x in kv]
COMMON = ["--device", "cpu", "--network", WEIGHTS, "--config", "none", "--opts", *TINY]


def _frames(n, hw=(48, 64), seed=0):
    """A textured pan: n RGB uint8 frames."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.uniform(0, 255, (hw[0] + 64, hw[1] + 64, 3)).astype(np.uint8),
                            (7, 7), 2.0)
    for i in range(n):
        M = np.float32([[1, 0, 3.0 * i], [0, 1, 1.5 * i]])
        yield cv2.warpAffine(base, M, (hw[1], hw[0]))


def _gt_rows(n, t):
    rows = np.zeros((n, 8))
    rows[:, 0] = t
    rows[:, 1] = np.arange(n) * 0.1
    rows[:, 7] = 1.0
    return rows


def _euroc(tmp_path, n):
    seq = tmp_path / "data" / "MH_01_easy" / "mav0" / "cam0" / "data"
    seq.mkdir(parents=True)
    t0 = 1403636579763555584
    for i, img in enumerate(_frames(n)):
        cv2.imwrite(str(seq / f"{t0 + i * 50_000_000}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    (tmp_path / "gt").mkdir()
    np.savetxt(tmp_path / "gt" / "MH_01_easy.txt", _gt_rows(n, (t0 + np.arange(n) * 5e7) / 1e9))
    return ["--gtdir", str(tmp_path / "gt"), "--stride", "1"], str(seq), ()


def _tum(tmp_path, n):
    seq = tmp_path / "data" / "rgbd_dataset_freiburg1_desk"
    (seq / "rgb").mkdir(parents=True)
    lines = ["# color images", "# timestamp filename"]
    for i, img in enumerate(_frames(n)):
        rel = f"rgb/{1305031452.79 + i * 0.033:.6f}.png"
        cv2.imwrite(str(seq / rel), img[..., ::-1])
        lines.append(f"{1305031452.79 + i * 0.033:.6f} {rel}")
    (seq / "rgb.txt").write_text("\n".join(lines) + "\n")
    np.savetxt(seq / "groundtruth.txt", _gt_rows(n, 1305031452.79 + np.arange(n) * 0.033))
    return [], str(seq), ()


def _kitti(tmp_path, n):
    seq = tmp_path / "data" / "00"
    (seq / "image_0").mkdir(parents=True)
    for i, img in enumerate(_frames(n)):
        cv2.imwrite(str(seq / "image_0" / f"{i:06d}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    (seq / "calib.txt").write_text("P0: 60.0 0 32.0 0 0 60.0 24.0 0 0 0 1 0\n"
                                   "P1: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    (tmp_path / "gt").mkdir()
    P = np.tile(np.eye(3, 4), (n, 1, 1))
    P[:, 0, 3] = np.arange(n) * 0.1
    np.savetxt(tmp_path / "gt" / "00.txt", P.reshape(n, 12))
    return ["--gtdir", str(tmp_path / "gt")], str(seq), (np.array([60.0, 60.0, 32.0, 24.0],
                                                                  np.float32),)


def _icl(tmp_path, n):
    seq = tmp_path / "data" / "living_room_traj0_frei_png"
    (seq / "rgb").mkdir(parents=True)
    for i, img in enumerate(_frames(n)):
        cv2.imwrite(str(seq / "rgb" / f"{i}.png"), img[..., ::-1])
    np.savetxt(seq / "groundtruth.txt", _gt_rows(n, np.arange(n, dtype=np.float64)))
    return [], str(seq), ()


def _tartan(tmp_path, n):
    seq = tmp_path / "data" / "MH000"
    (seq / "image_left").mkdir(parents=True)
    for i, img in enumerate(_frames(n)):
        cv2.imwrite(str(seq / "image_left" / f"{i:06d}_left.png"), img[..., ::-1])
    ned = np.zeros((n, 7))
    ned[:, 0] = np.arange(n) * 0.1
    ned[:, 6] = 1.0
    np.savetxt(seq / "pose_left.txt", ned)
    return [], str(seq), ()


LAYOUTS = {"euroc": _euroc, "tum": _tum, "kitti": _kitti, "icl_nuim": _icl, "tartan": _tartan}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_evaluate_on_dataset_layout(name, tmp_path):
    """The port's evaluate_<name> on a generated layout: its frame iterator
    gives the JAX script's frames, and one trial of the tiny tracker on the
    CPU scores the sequence with a finite ATE."""
    n = 10
    extra, seqdir, iter_args = LAYOUTS[name](tmp_path, n)
    port = importlib.import_module(f"dpvo_tpu_torch.apps.evaluate_{name}")
    jax_app = importlib.import_module(f"evaluate_{name}")
    kw = {"euroc": dict(stride=1)}.get(name, {})
    got = list(port.frame_iter(seqdir, *iter_args, **kw))
    if name == "euroc":  # the JAX script reads its frames inside run_sequence
        gt = tmp_path / "gt" / "MH_01_easy.txt"
        for a, b in zip(port.load_euroc_gt(gt), jax_app.load_euroc_gt(gt)):
            np.testing.assert_array_equal(a, b)
        assert got[0][0] == pytest.approx(1403636579763555584 / 1e9)
    else:
        want = list(jax_app.frame_iter(seqdir, *iter_args, **kw))
        if name == "kitti":
            np.testing.assert_array_equal(port.load_calib(seqdir), jax_app.load_calib(seqdir))
        for (ta, ia, ka), (tb, ib, kb) in zip(got, want):
            assert ta == tb
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(ka, kb)
    assert len(got) == n and got[0][1].shape == (48, 64, 3)
    out = port.main(["--datadir", str(tmp_path / "data"), "--trials", "1", *extra, *COMMON])
    (seq,) = out["median"]
    assert len(out["trials"][seq]) == 1 and np.isfinite(out["median"][seq])
    assert out["avg"] == out["median"][seq]


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    from dpvo_tpu_torch.utils.synthetic import PlaneScene

    d = tmp_path_factory.mktemp("demo")
    scene = PlaneScene(ht=48, wd=64, n_frames=16, depth=5.0, seed=9002, tstep=0.3, rstep=0.008)
    (d / "frames").mkdir()
    for i in range(16):
        cv2.imwrite(str(d / "frames" / f"{i:04d}.png"),
                    cv2.cvtColor(scene.render(i), cv2.COLOR_RGB2BGR))
    (d / "calib.txt").write_text(" ".join(str(v) for v in scene.intrinsics) + "\n")
    return d


def test_demo_main_with_every_writer(png_dir, tmp_path, monkeypatch):
    """demo.main on a PNG directory with --viz and every save flag: its
    reader feeds the frames iter_images reads, and it writes the TUM trajectory (a row
    per frame), the PLY (the finite points of point_cloud(), coloured), the
    COLMAP model, the plot and the viewer's frames."""
    pytest.importorskip("matplotlib")
    from dpvo_tpu_torch.apps import demo
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.data.stream import iter_images

    monkeypatch.chdir(tmp_path)  # the viewer writes viewer_out/ here
    fed, run = [], demo.run
    monkeypatch.setattr(demo, "run", lambda args, frames: run(args, (fed.append(f) or f
                                                                     for f in frames)))
    out = demo.main(["--imagedir", str(png_dir / "frames"), "--calib", str(png_dir / "calib.txt"),
                     "--stride", "1", "--buffer", "64", "--viz", "--plot", "--save_ply",
                     "--save_colmap", "--save_trajectory", "--name", "t", "--outdir", "res",
                     *COMMON])
    slam = out["slam"]
    assert out["n_frames"] == 16 and out["fps"] > 0 and out["peak_mib"] is None
    assert slam.is_initialized and slam.viewer is not None and not slam.viewer.proc.is_alive()
    assert list((tmp_path / "viewer_out").glob("viewer_*.png"))
    assert (tmp_path / "res" / "trajectory_plots" / "t.pdf").stat().st_size > 0
    tum = np.loadtxt(tmp_path / "res" / "saved_trajectories" / "t.txt")
    assert tum.shape == (16, 8)
    np.testing.assert_allclose(tum[:, 1:], out["poses"], atol=1e-8)

    # the reader process fed the tracker the frames iter_images reads, and
    # the tracker ran the configuration the command line asks for
    want = list(iter_images(str(png_dir / "frames"), str(png_dir / "calib.txt")))
    assert len(fed) == len(want)
    for (ta, ia, ka), (tb, ib, kb) in zip(fed, want):
        assert ta == tb
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ka, kb)
    assert slam.cfg == Config(**chip_smoke.SMALL_CFG)  # whose BUFFER_SIZE is --buffer

    pts, clr = slam.point_cloud()
    ok = np.isfinite(pts).all(1) & (np.abs(pts) < 1e6).all(1)
    head, body = (tmp_path / "res" / "t.ply").read_text().split("end_header\n")
    assert f"element vertex {ok.sum()}\n" in head and len(body.splitlines()) == ok.sum() > 0
    assert clr.any()
    cdir = tmp_path / "res" / "colmap_saves" / "t"
    assert (cdir / "cameras.txt").read_text().split()[1:4] == ["PINHOLE", "64", "48"]
    images = [ln for ln in (cdir / "images.txt").read_text().splitlines() if ln.strip()]
    assert len(images) == slam.n
    assert np.loadtxt(cdir / "points3D.txt", ndmin=2).shape == (ok.sum(), 8)


def test_eval_synthetic_main():
    from dpvo_tpu_torch.apps import eval_synthetic

    out = eval_synthetic.main(["--scenes", "2", "--trials", "1", "--n_frames", "12", "--ht", "48",
                               "--wd", "64", "--tstep", "0.3", "--depth", "5.0", *COMMON])
    assert sorted(out["scenes"]) == ["scene0", "scene1"]
    assert all(np.isfinite(v["trials"]).all() for v in out["scenes"].values())
    assert out["summary"]["metric"] == "synthetic_ate_rel"


def test_extract_frames_matches_jax(tmp_path):
    """extract_frames and the video reader on a short MJPG clip: the JAX
    script's files and the JAX reader's frames."""
    import extract_frames as j_extract

    from dpvo_tpu.data import stream as j_stream
    from dpvo_tpu_torch.apps.extract_frames import extract_frames
    from dpvo_tpu_torch.data import stream as t_stream

    video = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    for img in _frames(6):
        writer.write(img)
    writer.release()
    assert extract_frames(video, str(tmp_path / "t"), stride=2) == 3
    assert j_extract.extract_frames(video, str(tmp_path / "j"), stride=2) == 3
    for f in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()
    calib = tmp_path / "calib.txt"
    calib.write_text("60.0 60.0 32.0 24.0\n")
    got = list(t_stream.iter_video(video, str(calib), stride=2, skip=1))
    want = list(j_stream.iter_video(video, str(calib), stride=2, skip=1))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[1], b[1])


def _viewer_state(n=20, m=400, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.stack([0.1 * np.arange(n), np.zeros(n), 0.05 * np.arange(n)], 1)
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0], np.float32), (n, 1))
    poses[:, :3] = -centers
    points = centers[-1] + rng.normal(size=(m, 3)) * [1.0, 0.5, 1.5] + [0, 0, 2.0]
    colors = rng.integers(0, 255, (m, 3)).astype(np.uint8)
    return poses.astype(np.float32), points.astype(np.float32), colors


def test_viewer_renders_as_jax():
    """The 3-D view and the top-down view draw the JAX viewer's pixels, also
    for one pose and for NaN poses."""
    from dpvo_tpu.apps import viewer as j_viewer
    from dpvo_tpu_torch.apps import viewer as t_viewer

    poses, points, colors = _viewer_state()
    cases = [((480, 640), (poses, points, colors)),
             ((120, 160), (poses[:1], None, None)),
             ((120, 160), (np.full((3, 7), np.nan, np.float32), None, None))]
    for hw, state in cases:
        for fn in ("_render_3d", "_render_topdown"):
            got = getattr(t_viewer, fn)(np.zeros((*hw, 3), np.uint8), *state)
            want = getattr(j_viewer, fn)(np.zeros((*hw, 3), np.uint8), *state)
            np.testing.assert_array_equal(got, want)
    canvas = t_viewer._render_3d(np.zeros((480, 640, 3), np.uint8), poses, points, colors)
    assert (canvas > 0).any(axis=2).sum() > 300


def test_viewer_process_round_trip(tmp_path):
    """The spawned renderer takes images and states, writes its headless
    frames and ends on join()."""
    from dpvo_tpu_torch.apps.viewer import Viewer

    poses, points, colors = _viewer_state()
    v = Viewer(outdir=str(tmp_path))
    for k in range(12):
        v.update_image(np.zeros((48, 64, 3), np.uint8))
        v.update_state(poses[: k + 2], points, colors)
    v.join()
    assert not v.proc.is_alive() and v.proc.exitcode == 0
    assert list(tmp_path.glob("viewer_*.png"))


def test_viewer_needs_opencv(monkeypatch):
    from dpvo_tpu_torch.apps.viewer import Viewer

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        Viewer()


ENTRY_POINTS = {
    "demo": ["--imagedir", "frames", "--calib", "calib.txt"],
    "eval_synthetic": [],
    "export_network": ["--outdir", "exported"],
    "evaluate_euroc": [], "evaluate_tum": [], "evaluate_kitti": [], "evaluate_icl_nuim": [],
    "evaluate_tartan": [],
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_needs_a_card(name, monkeypatch, tmp_path):
    """Without --device each entry point asks for the card, and without one
    it raises before it reads or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    app = importlib.import_module(f"dpvo_tpu_torch.apps.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        app.main(ENTRY_POINTS[name])
    assert os.listdir(tmp_path) == []
