"""Synthetic scene generator (NumPy) for tests and the chip smoke run.

A copy of ``dpvo_tpu/utils/synthetic.py``, its oracle targets
(``PlaneScene.gt_targets``) on the port's projective ops. Renders a textured
fronto-parallel plane observed by a moving camera: fully known geometry
(ground-truth poses and dense inverse depth) and realistic optical flow.
"""

from __future__ import annotations

import numpy as np
import torch

from dpvo_tpu_torch.geom import projective as pops

# NumPy quaternion/SE3 helpers. Conventions match dpvo_tpu_torch.lie.se3:
# pose = (tx,ty,tz, qx,qy,qz,qw), world-to-camera.


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
    """exp of a (tau, phi) twist — small-angle-safe closed form."""
    tau, phi = xi[:3], xi[3:6]
    theta = np.linalg.norm(phi)
    if theta < 1e-8:
        q = np.array([*(phi / 2.0), 1.0])
        V = np.eye(3)
    else:
        axis = phi / theta
        q = np.array([*(np.sin(theta / 2) * axis), np.cos(theta / 2)])
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        V = (
            np.eye(3)
            + ((1 - np.cos(theta)) / theta) * K
            + ((theta - np.sin(theta)) / theta) * (K @ K)
        )
    q /= np.linalg.norm(q)
    return np.concatenate([V @ tau, q])


def _nse3_mul(g1, g2):
    t = g1[:3] + _nq_rotmat(g1[3:7]) @ g2[:3]
    q = _nq_mul(g1[3:7], g2[3:7])
    return np.concatenate([t, q / np.linalg.norm(q)])


def _nse3_inv(g):
    R = _nq_rotmat(g[3:7])
    qi = g[3:7] * np.array([-1.0, -1.0, -1.0, 1.0])
    return np.concatenate([-(R.T @ g[:3]), qi])


def smooth_texture(key: int, size: int = 1024, octaves: int = 5) -> np.ndarray:
    """Multi-octave value noise in [0,255], RGB uint8."""
    rng = np.random.default_rng(key)
    tex = np.zeros((size, size, 3), np.float32)
    for o in range(octaves):
        s = 8 * 2**o
        coarse = rng.uniform(0, 1, (s, s, 3)).astype(np.float32)
        reps = size // s
        up = np.kron(coarse, np.ones((reps, reps, 1), np.float32))
        tex += up / 2**o
    tex -= tex.min()
    tex /= tex.max()
    return (tex * 255).astype(np.uint8)


class PlaneScene:
    """Camera looking at plane z = depth (world frame), translating and
    rotating smoothly. Pose convention matches the runtime: poses map
    world -> camera."""

    def __init__(self, ht=480, wd=640, n_frames=100, depth=4.0, seed=0,
                 tstep=0.035, rstep=0.004, poses=None):
        self.ht, self.wd = ht, wd
        self.depth = depth
        self.fx = self.fy = 0.8 * wd
        self.cx, self.cy = wd / 2, ht / 2
        self.intrinsics = np.array([self.fx, self.fy, self.cx, self.cy], np.float32)
        self.tex = smooth_texture(seed)
        self.tex_scale = self.tex.shape[0] / 12.0  # plane extent ~12m

        if poses is not None:
            # prescribed trajectory (e.g. a closed loop for the
            # loop-closure A/B test); [n, 7] world-to-camera
            self.poses = np.asarray(poses, np.float32)
            return
        rng = np.random.default_rng(seed + 1)
        # smooth random-walk twist increments
        poses = [np.array([0, 0, 0, 0, 0, 0, 1], np.float32)]
        vel = np.zeros(6)
        for _ in range(1, n_frames):
            vel = 0.9 * vel + np.concatenate(
                [tstep * rng.normal(size=3), rstep * rng.normal(size=3)]
            )
            vel[2] *= 0.3  # limited forward motion keeps the plane visible
            g = _nse3_mul(_nse3_exp(vel), poses[-1]).astype(np.float32)
            poses.append(g)
        self.poses = np.stack(poses)  # [n,7] world-to-camera

    def _rays(self, n, x, y):
        """Camera-center origin and world-frame ray directions (unit
        camera-z) for pixels (x, y) of frame n — pure NumPy."""
        rx = (x - self.cx) / self.fx
        ry = (y - self.cy) / self.fy
        d_cam = np.stack([rx, ry, np.ones_like(rx)], -1)
        g_inv = _nse3_inv(self.poses[n].astype(np.float64))  # camera-to-world
        Rw = _nq_rotmat(g_inv[3:7])
        return g_inv[:3], d_cam @ Rw.T

    def inv_depth(self, n: int, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """GT inverse depth at full-res pixels (x, y) of frame n."""
        o_w, d_w = self._rays(n, x, y)
        # intersect z = depth: o_z + t d_z = depth
        t = (self.depth - o_w[2]) / np.maximum(d_w[..., 2], 1e-6)
        z_cam = t  # for unit-z camera direction, depth along camera z == t
        return 1.0 / np.maximum(z_cam, 1e-6)

    def render(self, n: int) -> np.ndarray:
        """Render frame n by texture lookup at ray/plane intersections."""
        ys, xs = np.mgrid[0 : self.ht, 0 : self.wd]
        o_w, d_w = self._rays(n, xs.astype(np.float32), ys.astype(np.float32))
        t = (self.depth - o_w[2]) / np.maximum(d_w[..., 2], 1e-6)
        px = o_w[0] + t * d_w[..., 0]
        py = o_w[1] + t * d_w[..., 1]
        ti = np.mod((px * self.tex_scale).astype(np.int64), self.tex.shape[0])
        tj = np.mod((py * self.tex_scale).astype(np.int64), self.tex.shape[1])
        return self.tex[tj, ti]

    def gt_targets(self, poses_gt, patch_xy_q, ii, jj, kk):
        """Oracle reprojection targets at 1/4 resolution.

        patch_xy_q [Mtot, 2]: patch centres (x, y) at 1/4 res; returns the
        ground-truth projection [E, 2] of patch kk (anchored in frame ii,
        at its true inverse depth) into frame jj."""
        x4 = patch_xy_q[kk, 0]
        y4 = patch_xy_q[kk, 1]
        d = self.inv_depth_list(ii, x4 * 4.0, y4 * 4.0)
        ctr = np.stack([x4, y4, d], -1).astype(np.float32)  # [E, 3]
        intr_q = np.tile(self.intrinsics[None] / 4.0, (len(self.poses), 1))
        t = torch.as_tensor
        coords = pops.transform(t(np.asarray(poses_gt, np.float32)), t(ctr[:, :, None, None]),
                                t(intr_q), t(np.asarray(ii, np.int64)),
                                t(np.asarray(jj, np.int64)), torch.arange(len(ii)))
        return coords[:, 0, 0, :].numpy()

    def inv_depth_list(self, frames: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        out = np.zeros_like(x, np.float64)
        for f in np.unique(frames):
            m = frames == f
            out[m] = self.inv_depth(int(f), x[m], y[m])
        return out


class MultiPlaneScene(PlaneScene):
    """Background plane plus textured rectangular billboards at varying
    depths — depth discontinuities, occlusion, and parallax diversity
    for training (the reference trains on TartanAir scenes with full 3-D
    structure, dpvo/data_readers/tartan.py; this is the procedural
    stand-in for environments without the dataset on disk)."""

    def __init__(self, ht=240, wd=320, n_frames=15, depth=8.0, seed=0,
                 tstep=0.05, rstep=0.006, n_planes=8):
        super().__init__(ht=ht, wd=wd, n_frames=n_frames, depth=depth,
                         seed=seed, tstep=tstep, rstep=rstep)
        rng = np.random.default_rng(seed + 2)
        # billboards: (z, cx, cy, half_w, half_h); sorted far-to-near so a
        # simple sequential overwrite yields nearest-hit compositing
        zs = np.sort(rng.uniform(1.2, depth - 0.5, n_planes))[::-1]
        self.rects = []
        for z in zs:
            # place inside the initial view frustum at depth z
            half_view_x = z * (self.wd / 2) / self.fx
            half_view_y = z * (self.ht / 2) / self.fy
            cx = rng.uniform(-half_view_x, half_view_x)
            cy = rng.uniform(-half_view_y, half_view_y)
            hw = rng.uniform(0.25, 0.9) * half_view_x
            hh = rng.uniform(0.25, 0.9) * half_view_y
            self.rects.append((float(z), cx, cy, hw, hh))
        # per-plane texture offset decorrelates the pattern across planes
        self.tex_off = rng.integers(0, self.tex.shape[0], size=(n_planes + 1, 2))

    def _trace(self, o_w, d_w):
        """Nearest-surface ray parameter t and hit plane index
        (-1 = background) for rays o_w + t * d_w."""
        dz = np.where(np.abs(d_w[..., 2]) > 1e-6, d_w[..., 2], 1e-6)
        t = (self.depth - o_w[2]) / dz
        t = np.where(t > 0.1, t, 1e6)
        idx = np.full(t.shape, -1, np.int64)
        for i, (z, cx, cy, hw, hh) in enumerate(self.rects):
            ti = (z - o_w[2]) / dz
            px = o_w[0] + ti * d_w[..., 0]
            py = o_w[1] + ti * d_w[..., 1]
            hit = (ti > 0.1) & (ti < t) & (np.abs(px - cx) < hw) & (np.abs(py - cy) < hh)
            t = np.where(hit, ti, t)
            idx = np.where(hit, i, idx)
        return t, idx

    def inv_depth(self, n, x, y):
        o_w, d_w = self._rays(n, x, y)
        t, _ = self._trace(o_w, d_w)
        return 1.0 / np.maximum(t, 1e-6)  # camera-z depth == t (unit-z rays)

    def render(self, n):
        ys, xs = np.mgrid[0 : self.ht, 0 : self.wd]
        o_w, d_w = self._rays(n, xs.astype(np.float64), ys.astype(np.float64))
        t, idx = self._trace(o_w, d_w)
        px = o_w[0] + t * d_w[..., 0]
        py = o_w[1] + t * d_w[..., 1]
        off = self.tex_off[idx]  # idx -1 wraps to the last row (background)
        ti = np.mod((px * self.tex_scale).astype(np.int64) + off[..., 0], self.tex.shape[0])
        tj = np.mod((py * self.tex_scale).astype(np.int64) + off[..., 1], self.tex.shape[1])
        return self.tex[tj, ti]
