"""The port's data layer against the JAX package's on the same inputs:
numpy SE(3), the flow/depth file readers, the RGB-D helpers, the frame
streams, the TartanAir reader (geometry, frame graph, the clip walk of a
seed) and the train entry point on a TartanAir directory."""

import json
import os
import sys

import numpy as np
import pytest

from dpvo_tpu.data import frame_utils as j_fu
from dpvo_tpu.data import rgbd_utils as j_ru
from dpvo_tpu.data import tartan as j_tartan
from dpvo_tpu.utils import npse3 as j_npse3
from dpvo_tpu_torch.data import frame_utils as t_fu
from dpvo_tpu_torch.data import rgbd_utils as t_ru
from dpvo_tpu_torch.data import tartan as t_tartan
from dpvo_tpu_torch.utils import npse3 as t_npse3
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)


def _se3(rng, n):
    q = rng.normal(size=(n, 4))
    return np.concatenate([rng.normal(size=(n, 3)), q / np.linalg.norm(q, axis=1, keepdims=True)],
                          1)


def test_npse3_matches_jax():
    rng = np.random.default_rng(0)
    g, h = _se3(rng, 9), _se3(rng, 9)
    for name, args in (("inv", (g,)), ("mul", (g, h)), ("quat_rotmat", (g[:, 3:],)),
                       ("log", (g,)), ("rotmat_to_quat", (j_npse3.quat_rotmat(g[0, 3:]),))):
        np.testing.assert_array_equal(getattr(t_npse3, name)(*args),
                                      getattr(j_npse3, name)(*args), err_msg=name)


def test_frame_utils_match_jax(tmp_path):
    """The readers' round trips (tests/test_frame_utils.py's), each read equal
    to the JAX reader's."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    flow = rng.standard_normal((24, 32, 2)).astype(np.float32)
    t_fu.writeFlow(str(tmp_path / "a.flo"), flow)
    np.testing.assert_array_equal(t_fu.readFlow(str(tmp_path / "a.flo")), flow)
    img = rng.standard_normal((10, 14)).astype("<f4")
    with open(tmp_path / "d.pfm", "wb") as f:
        f.write(b"Pf\n14 10\n-1.0\n")
        np.flipud(img).astype("<f4").tofile(f)
    np.testing.assert_allclose(t_fu.readPFM(str(tmp_path / "d.pfm")), img)
    depth = rng.uniform(0.1, 10.0, (12, 16)).astype(np.float32)
    with open(tmp_path / "z.dpt", "wb") as f:
        np.array([202021.25], np.float32).tofile(f)
        np.array([16, 12], np.int32).tofile(f)
        depth.tofile(f)
    np.testing.assert_array_equal(t_fu.readDPT(str(tmp_path / "z.dpt")), depth)
    with open(tmp_path / "c.cam", "wb") as f:
        np.array([202021.25], np.float32).tofile(f)
        np.diag([320.0, 320.0, 1.0]).tofile(f)
        np.hstack([np.eye(3), [[1.0], [2.0], [3.0]]]).tofile(f)
    enc = rng.integers(0, 65535, (8, 10, 3)).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "k.png"), enc)
    cv2.imwrite(str(tmp_path / "i.png"), rng.integers(0, 255, (9, 11, 3)).astype(np.uint8))
    for fn, read in (("a.flo", "read_gen"), ("d.pfm", "read_gen"), ("z.dpt", "read_gen"),
                     ("i.png", "read_gen"), ("c.cam", "cam_read"), ("k.png", "readFlowKITTI")):
        got, want = (getattr(m, read)(str(tmp_path / fn)) for m in (t_fu, j_fu))
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(a, b, err_msg=fn)


def test_frame_utils_without_opencv(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        t_fu.read_gen(str(tmp_path / "x.png"))


def test_rgbd_utils_match_jax(tmp_path):
    """loadtum on a TUM directory (tests/test_rgbd_utils.py's layout), a
    missing one, and the pose distance matrix: equal to the JAX helpers."""
    rng = np.random.default_rng(2)
    (tmp_path / "rgb").mkdir()
    rows = {"rgb": [], "depth": [], "pose": []}
    for i in range(12):
        t = 100.0 + 0.05 * i
        rows["rgb"].append(f"{t:.4f} rgb/{i:04d}.png")
        rows["depth"].append(f"{t + 0.001:.4f} depth/{i:04d}.png")
        rows["pose"].append(" ".join(f"{v:.6f}" for v in [t + 0.002, *_se3(rng, 1)[0]]))
    (tmp_path / "rgb.txt").write_text("# rgb\n" + "\n".join(rows["rgb"]) + "\n")
    (tmp_path / "depth.txt").write_text("# depth\n" + "\n".join(rows["depth"]) + "\n")
    (tmp_path / "groundtruth.txt").write_text("# gt\n" + "\n".join(rows["pose"]) + "\n")
    got, want = t_ru.loadtum(str(tmp_path)), j_ru.loadtum(str(tmp_path))
    assert len(got[0]) == 3 and got[0] == want[0] and got[1] == want[1] and got[4] == want[4]
    np.testing.assert_array_equal(np.stack(got[2]), np.stack(want[2]))
    assert t_ru.loadtum(str(tmp_path / "rgb"))[0] is None
    poses = _se3(rng, 6)
    np.testing.assert_array_equal(t_ru.all_pairs_distance_matrix(poses),
                                  j_ru.all_pairs_distance_matrix(poses))
    m = np.eye(4)
    m[:3, :3], m[:3, 3] = j_npse3.quat_rotmat(poses[0, 3:]), poses[0, :3]
    np.testing.assert_array_equal(t_ru.pose_matrix_to_quaternion(m),
                                  j_ru.pose_matrix_to_quaternion(m))


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(3)
    for i in range(5):
        cv2.imwrite(str(d / f"{i:03d}.png"), rng.integers(0, 255, (70, 90, 3)).astype(np.uint8))
    (d / "calib.txt").write_text("50.0 50.0 45.0 35.0 0.1 -0.05 0.001 0.001\n")
    return d


def test_iter_images_matches_jax(png_dir):
    """The same frames (undistorted, cropped to multiples of 16, RGB) with a
    stride and a skip; the same calibration."""
    from dpvo_tpu.data import stream as j_stream
    from dpvo_tpu_torch.data import stream as t_stream

    calib = str(png_dir / "calib.txt")
    for a, b in zip(t_stream.load_calib(calib), j_stream.load_calib(calib)):
        np.testing.assert_array_equal(a, b)
    got = list(t_stream.iter_images(str(png_dir), calib, stride=2, skip=1))
    want = list(j_stream.iter_images(str(png_dir), calib, stride=2, skip=1))
    assert len(got) == len(want) == 2
    for (ta, ia, ka), (tb, ib, kb) in zip(got, want):
        assert ta == tb and ia.shape == (64, 80, 3)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ka, kb)


def test_spawn_reader_streams_the_frames(png_dir):
    from dpvo_tpu_torch.data import stream as t_stream

    calib = str(png_dir / "calib.txt")
    queue, proc = t_stream.spawn_reader(str(png_dir), calib)
    items = []
    while True:
        t, image, intr = queue.get(timeout=60)
        if t < 0:
            break
        items.append((t, image, intr))
    proc.join(timeout=30)
    assert not proc.is_alive() and proc.exitcode == 0
    want = list(t_stream.iter_images(str(png_dir), calib))
    assert [t for t, *_ in items] == [t for t, *_ in want] == list(range(5))
    for (_, a, _), (_, b, _) in zip(items, want):
        np.testing.assert_array_equal(a, b)


def test_tartan_geometry_matches_jax():
    """ned_to_xyz, the induced flow and the flow distance matrix."""
    rng = np.random.default_rng(4)
    poses = _se3(rng, 7) * [0.3, 0.3, 0.3, 1, 1, 1, 1]
    np.testing.assert_array_equal(t_tartan.ned_to_xyz(poses), j_tartan.ned_to_xyz(poses))
    intr = np.array([40.0, 40.0, 16.0, 12.0])
    xn, yn = rng.normal(0, 0.3, 50), rng.normal(0, 0.3, 50)
    disps = rng.uniform(0.1, 1.0, (7, 50))
    ii, jj = np.array([0, 1, 5, 3]), np.array([2, 1, 0, 6])
    for a, b in zip(t_tartan._induced_flow(poses, xn, yn, disps, intr, ii, jj),
                    j_tartan._induced_flow(poses, xn, yn, disps, intr, ii, jj)):
        np.testing.assert_array_equal(a, b)
    dgrid = rng.uniform(0.2, 1.0, (7, 24, 32))
    np.testing.assert_array_equal(t_tartan.flow_distance_matrix(poses, dgrid, intr, stride=4),
                                  j_tartan.flow_distance_matrix(poses, dgrid, intr, stride=4))


N_SCENE = 12


@pytest.fixture(scope="module")
def tartan_root(tmp_path_factory):
    """A MultiPlaneScene written in TartanAir's layout (as
    tests/test_tartan_sampling.py writes one), at 96x128."""
    cv2 = pytest.importorskip("cv2")
    from dpvo_tpu_torch.utils.synthetic import MultiPlaneScene

    root = tmp_path_factory.mktemp("tartan")
    scene_dir = root / "scene/scene/Easy/P001"
    (scene_dir / "image_left").mkdir(parents=True)
    (scene_dir / "depth_left").mkdir()
    ht, wd = 96, 128
    scene = MultiPlaneScene(ht=ht, wd=wd, n_frames=N_SCENE, depth=8.0, seed=5, tstep=0.06,
                            rstep=0.012)
    ys, xs = np.mgrid[0:ht, 0:wd]
    for i in range(N_SCENE):
        cv2.imwrite(str(scene_dir / "image_left" / f"{i:06d}_left.png"),
                    cv2.cvtColor(scene.render(i), cv2.COLOR_RGB2BGR))
        depth = 1.0 / scene.inv_depth(i, xs.astype(np.float64), ys.astype(np.float64))
        np.save(scene_dir / "depth_left" / f"{i:06d}_left_depth.npy",
                (depth * t_tartan.DEPTH_SCALE).astype(np.float32))
    c2w = t_npse3.inv(scene.poses.astype(np.float64))
    np.savetxt(scene_dir / "pose_left.txt", c2w[:, [2, 0, 1, 5, 3, 4, 6]])
    return root, scene


def test_tartan_sample_matches_jax(tartan_root, tmp_path, monkeypatch):
    """TartanAirDataset on the same directory and seed: the same frame graph
    and the same clips (images, poses, inverse depths, intrinsics), draw for
    draw."""
    root, scene = tartan_root
    for mod in (j_tartan, t_tartan):
        for k, v in (("FX", scene.fx), ("FY", scene.fy), ("CX", scene.cx), ("CY", scene.cy)):
            monkeypatch.setattr(mod, k, v)
    dsets = [mod.TartanAirDataset(str(root), n_frames=5, fmin=4.0, fmax=96.0, seed=7,
                                  index_path=str(tmp_path / f"{name}.pickle"))
             for name, mod in (("t", t_tartan), ("j", j_tartan))]
    assert len(dsets[0].scenes) == len(dsets[1].scenes) == 1
    graphs = [d._scene_graph(d.scenes[0]) for d in dsets]
    assert sorted(graphs[0]) == sorted(graphs[1]) == list(range(N_SCENE))
    for i in graphs[0]:
        for a, b in zip(graphs[0][i], graphs[1][i]):
            np.testing.assert_array_equal(a, b)
    for _ in range(3):
        for a, b in zip(dsets[0].sample(), dsets[1].sample()):
            np.testing.assert_array_equal(a, b)


def test_train_entry_point_on_tartan(tartan_root, tmp_path, monkeypatch):
    """python -m dpvo_tpu_torch.apps.train --dataset tartan --device cpu: one
    step on the TartanAir directory, with a finite loss."""
    from dpvo_tpu_torch.apps import train
    from dpvo_tpu_torch.data.factory import dataset_factory
    from dpvo_tpu_torch.data.tartan import TartanAirDataset

    root, _ = tartan_root
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # JSONL logging only
    assert isinstance(dataset_factory(["tartan"], datapath=str(root), n_frames=4),
                      TartanAirDataset)
    train.main(["--dataset", "tartan", "--datapath", str(root), "--device", "cpu",
                "--steps", "1", "--n_frames", "4", "--unroll", "4", "--log_every", "1",
                "--name", "tartan", "--outdir", str(tmp_path),
                "--opts", "PATCHES_PER_FRAME", "4", "DIM", "32", "FDIM", "16"])
    with open(os.path.join(tmp_path, "runs", "tartan", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows and np.isfinite(rows[-1]["loss"])


def test_tartan_factory_falls_back_to_synthetic_clips(tmp_path, capsys):
    """A path without a scene gives synthetic clips and a warning, as the
    JAX factory does."""
    from dpvo_tpu_torch.data.factory import SyntheticClipDataset, dataset_factory

    ds = dataset_factory(["tartan"], datapath=str(tmp_path / "none"), n_frames=4, ht=32, wd=32)
    assert isinstance(ds, SyntheticClipDataset)
    assert "no TartanAir scenes" in capsys.readouterr().out
