"""The general generator of camera streams: textured planes seen by a
moving camera, rendered on the card.

The scene, its texture and its random-walk trajectory are copies of
``dpvo_tpu_torch/utils/synthetic.py`` (``smooth_texture`` :72,
``PlaneScene`` :87, its walk :107-118, ``render`` :138) and the
out-and-back pan of ``chip_smoke.py:loop_trajectory`` (:1055); the
rendering is the same ray-plane lookup in f64 torch on the device, a
batch of frames at a time, so a run's set-up does not render on the host.

A traffic file gives one camera's ``sequences`` of ``frames`` frames
(at the configuration's ht x wd), tracked in turn, and the
``trajectory``: ``{"type": "walk", "tstep", "rstep", "pool"}`` gives
sequence i the walk of the i-th of a fixed ``pool`` of walk seeds (chosen
to keep the camera 3-5.5 m in front of the plane and within 30 degrees
of facing it); ``{"type": "out_and_back", "span", "ry"}`` gives every
sequence the same pan. Sequence i's texture and patch draws come from
(``scene_seed``, i). The run's seed draws the order in which the
sequences are tracked, so every seed tracks the same work in another
order (a texture of its own a seed changed how many loop closures and
keyframes a run had, and so its work).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bench_port.stats import sub_seed


@dataclass
class Sequence:
    frames: np.ndarray      # [T, H, W, 3] uint8 RGB
    intrinsics: np.ndarray  # [4] f32 (fx, fy, cx, cy)
    poses: np.ndarray       # [T, 7] world-to-camera ground truth
    points: np.ndarray      # [T, K, 2] f32 patch centroids (x, y) at 1/4 resolution
    depths: np.ndarray      # [T, M] f32 initial inverse depths

    def draws(self, frame: int):
        """The tracker's draws of call ``frame`` (``DPVO(draws=...)``)."""
        return self.points[frame], self.depths[frame]


# ---- NumPy SE(3) helpers (copies of synthetic.py :20-69); pose = (t, q xyzw)

def _nq_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def _nq_rotmat(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _nse3_exp(xi):
    tau, phi = xi[:3], xi[3:6]
    theta = np.linalg.norm(phi)
    if theta < 1e-8:
        q = np.array([*(phi / 2.0), 1.0])
        V = np.eye(3)
    else:
        axis = phi / theta
        q = np.array([*(np.sin(theta / 2) * axis), np.cos(theta / 2)])
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        V = (np.eye(3) + ((1 - np.cos(theta)) / theta) * K
             + ((theta - np.sin(theta)) / theta) * (K @ K))
    q /= np.linalg.norm(q)
    return np.concatenate([V @ tau, q])


def _nse3_mul(g1, g2):
    t = g1[:3] + _nq_rotmat(g1[3:7]) @ g2[:3]
    q = _nq_mul(g1[3:7], g2[3:7])
    return np.concatenate([t, q / np.linalg.norm(q)])


def walk_poses(n_frames: int, seed: int, tstep: float, rstep: float) -> np.ndarray:
    """Smooth random-walk poses [n, 7] (synthetic.py :107-118)."""
    rng = np.random.default_rng(seed + 1)
    poses = [np.array([0, 0, 0, 0, 0, 0, 1], np.float32)]
    vel = np.zeros(6)
    for _ in range(1, n_frames):
        vel = 0.9 * vel + np.concatenate([tstep * rng.normal(size=3), rstep * rng.normal(size=3)])
        vel[2] *= 0.3
        poses.append(_nse3_mul(_nse3_exp(vel), poses[-1]).astype(np.float32))
    return np.stack(poses)


def out_and_back_poses(n_frames: int, span: float, ry: float) -> np.ndarray:
    """Lateral pan out and back with gentle yaw (chip_smoke.py :1055)."""
    ts = np.linspace(0, 2 * np.pi, n_frames)
    xs = span * (1 - np.cos(ts)) / 2
    yaw = ry * np.sin(ts)
    return np.stack([_nse3_exp(np.array([-x, 0, 0, 0, r, 0]))
                     for x, r in zip(xs, yaw)]).astype(np.float32)


def smooth_texture(key: int, device, size: int = 1024, octaves: int = 5) -> torch.Tensor:
    """Multi-octave value noise in [0, 255], [size, size, 3] uint8 on the
    device: ``synthetic.smooth_texture``'s draws, upsampled there."""
    rng = np.random.default_rng(key)
    tex = torch.zeros((size, size, 3), dtype=torch.float32, device=device)
    for o in range(octaves):
        s = 8 * 2 ** o
        coarse = torch.as_tensor(rng.uniform(0, 1, (s, s, 3)).astype(np.float32), device=device)
        reps = size // s
        tex += coarse.repeat_interleave(reps, 0).repeat_interleave(reps, 1) / 2 ** o
    tex -= tex.min()
    tex /= tex.max()
    return (tex * 255).to(torch.uint8)


def _rotmats(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1).reshape(-1, 3, 3)


def render(poses: np.ndarray, tex: torch.Tensor, ht: int, wd: int, depth: float,
           batch: int = 8) -> np.ndarray:
    """Frames [T, H, W, 3] uint8 of the plane z = depth seen from poses
    (world-to-camera), ``PlaneScene.render``'s lookup."""
    dev = tex.device
    f = 0.8 * wd
    cx, cy = wd / 2, ht / 2
    scale = tex.shape[0] / 12.0
    ys, xs = torch.meshgrid(torch.arange(ht, device=dev, dtype=torch.float64),
                            torch.arange(wd, device=dev, dtype=torch.float64), indexing="ij")
    d_cam = torch.stack([(xs - cx) / f, (ys - cy) / f, torch.ones_like(xs)], -1)
    out = np.empty((len(poses), ht, wd, 3), np.uint8)
    for s in range(0, len(poses), batch):
        g = torch.as_tensor(np.asarray(poses[s:s + batch], np.float64), device=dev)
        R = _rotmats(g[:, 3:7])                                  # world-to-camera rotation
        o_w = -(R.transpose(1, 2) @ g[:, :3, None])[..., 0]       # camera centre
        d_w = torch.einsum("hwc,bcd->bhwd", d_cam, R)             # rays in the world
        t = (depth - o_w[:, None, None, 2]) / torch.clamp(d_w[..., 2], min=1e-6)
        px = o_w[:, None, None, 0] + t * d_w[..., 0]
        py = o_w[:, None, None, 1] + t * d_w[..., 1]
        ti = torch.remainder((px * scale).to(torch.int64), tex.shape[0])
        tj = torch.remainder((py * scale).to(torch.int64), tex.shape[1])
        out[s:s + batch] = tex[tj, ti].cpu().numpy()
    return out


def make_sequences(params: dict, seed: int, ht: int, wd: int, res: int, points: int,
                   patches: int, device) -> list:
    """The traffic's sequences for one run, in the order they are tracked:
    frames of ht x wd, ``points`` patch centroids (or candidates) a frame
    on the 1/``res`` grid and ``patches`` initial inverse depths."""
    Q, T = params["sequences"], params["frames"]
    traj = params["trajectory"]
    if traj["type"] == "walk":
        pool = list(traj["pool"])
        if len(pool) != Q:
            raise ValueError(f"a walk pool of {len(pool)} seeds for {Q} sequences")
        motion = lambda i: walk_poses(T, pool[i], traj["tstep"], traj["rstep"])
    elif traj["type"] == "out_and_back":
        pan = out_and_back_poses(T, traj["span"], traj["ry"])
        motion = lambda i: pan
    else:
        raise ValueError(f"unknown trajectory type {traj['type']!r}")
    h, w = ht // res, wd // res
    f = 0.8 * wd
    intr = np.array([f, f, wd / 2, ht / 2], np.float32)
    order = np.random.default_rng(sub_seed(seed, 0x0DE4)).permutation(Q)
    out = []
    for i in order:
        tex_key, draw_key = (int(k) for k in sub_seed(params["scene_seed"], int(i) + 1)
                             .generate_state(2, np.uint64) >> np.uint64(1))
        poses = motion(i)
        frames = render(poses, smooth_texture(tex_key, device), ht, wd, params["depth"])
        rng = np.random.default_rng(draw_key)
        x = rng.integers(1, w - 1, (T, points))
        y = rng.integers(1, h - 1, (T, points))
        pts = np.stack([x, y], -1).astype(np.float32)
        depths = rng.random((T, patches), dtype=np.float32)
        out.append(Sequence(frames, intr, poses, pts, depths))
    return out
