"""Asynchronous 3-D trajectory / point-cloud viewer — port of
``dpvo_tpu/apps/viewer.py``.

The renderer runs in a separate process started with the spawn context
(rendering never blocks tracking, and the child holds no CUDA context);
the tracker sends it numpy snapshots through a queue, dropping them when
the queue is full. It draws the live camera image and a software-rendered
3-D view (follow camera, z-sorted point splats, keyframe frusta, the
trajectory) with a top-down (x, z) inset, into an OpenCV window when a
display is available, else into ``<outdir>/viewer_%05d.png`` every 10th
update. It needs OpenCV: without it, building a ``Viewer`` raises.

    v = Viewer()
    v.update_image(image)
    v.update_state(poses, points, colors)
    v.join()
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as pyqueue

import numpy as np

from dpvo_tpu_torch.utils import npse3, optional


def _render_topdown(canvas, poses, points, colors):
    """Draw a top-down (x, z) view onto the uint8 canvas."""
    H, W, _ = canvas.shape
    pts = []
    if points is not None and len(points):
        pts.append(points[:, [0, 2]])
    if poses is not None and len(poses):
        pts.append(poses[:, [0, 2]])
    if not pts:
        return canvas
    all_xy = np.concatenate(pts, 0)
    ok = np.isfinite(all_xy).all(axis=1)
    if not ok.any():
        return canvas
    lo = np.percentile(all_xy[ok], 2, axis=0)
    hi = np.percentile(all_xy[ok], 98, axis=0)
    span = np.maximum(hi - lo, 1e-3)
    scale = 0.9 * min(W / span[0], H / span[1])
    org = np.array([W, H]) / 2 - scale * (lo + hi) / 2

    def to_px(xy):
        p = (xy * scale + org).astype(np.int32)
        return np.clip(p[:, 0], 0, W - 1), np.clip(p[:, 1], 0, H - 1)

    if points is not None and len(points):
        px, py = to_px(points[:, [0, 2]])
        c = colors if colors is not None else np.full((len(px), 3), 200, np.uint8)
        canvas[py, px] = c[: len(px)]
    if poses is not None and len(poses):
        px, py = to_px(poses[:, [0, 2]])
        canvas[np.clip(py, 1, H - 2), px] = (0, 255, 0)
        canvas[np.clip(py + 1, 0, H - 1), px] = (0, 255, 0)
    return canvas


def _centers_c2w(poses_w2c: np.ndarray):
    """w2c (t, q) poses -> camera centers + c2w rotation matrices."""
    g = npse3.inv(np.asarray(poses_w2c, np.float64))
    return g[:, :3], npse3.quat_rotmat(g[:, 3:7])


def _render_3d(canvas, poses, points, colors, point_px: int = 1):
    """Software-rendered perspective view: a follow camera sits behind
    and above the newest pose, looking along the smoothed trajectory
    (the same shot as the reference's Pangolin follow mode,
    DPViewer/dpviewer/viewer.cpp renderloop). Pure NumPy projection +
    z-ordered splats; cv2 only draws lines."""
    cv2 = optional.cv2("the viewer")
    H, W, _ = canvas.shape
    if poses is None or len(poses) == 0:
        return canvas
    ctr, rots = _centers_c2w(poses)
    ok = np.isfinite(ctr).all(axis=1)
    if not ok.any():
        return canvas
    ctr = ctr[ok]
    rots = rots[ok]

    # scene scale from the trajectory + cloud spread
    ref_pts = ctr if points is None or not len(points) else np.concatenate(
        [ctr, points[np.isfinite(points).all(axis=1)]], 0)
    scale = max(float(np.percentile(
        np.linalg.norm(ref_pts - ctr[-1], axis=1), 90)), 1e-3)

    # follow camera: behind (-z of newest cam) and above, looking at it
    fwd = rots[-1][:, 2]  # newest camera's viewing direction (c2w z)
    up_w = np.array([0.0, -1.0, 0.0])  # image y points down in cam frame
    eye = ctr[-1] - 1.8 * scale * fwd + 0.9 * scale * up_w
    look = ctr[-1] + 0.4 * scale * fwd
    z = look - eye
    z /= np.linalg.norm(z) + 1e-12
    x = np.cross(z, up_w)
    x /= np.linalg.norm(x) + 1e-12
    y = np.cross(z, x)
    Rv = np.stack([x, y, z])  # world -> view rows

    f = 0.9 * min(H, W)
    cx, cy = W / 2, H / 2

    def project(Xw):
        Xc = (Xw - eye) @ Rv.T
        zc = Xc[:, 2]
        vis = zc > 1e-3 * scale
        zs = np.where(vis, zc, 1.0)
        u = f * Xc[:, 0] / zs + cx
        v = f * Xc[:, 1] / zs + cy
        inb = vis & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        return u, v, zc, inb

    # points: z-sorted far-to-near so near splats overwrite far ones
    if points is not None and len(points):
        P = points[np.isfinite(points).all(axis=1)]
        C = (colors[np.isfinite(points).all(axis=1)]
             if colors is not None and len(colors) == len(points)
             else np.full((len(P), 3), 200, np.uint8))
        u, v, zc, inb = project(P)
        order = np.argsort(-zc[inb])
        ui = u[inb].astype(np.int32)[order]
        vi = v[inb].astype(np.int32)[order]
        ci = C[inb][order]
        for d in range(point_px):
            canvas[np.clip(vi + d, 0, H - 1), ui] = ci
            canvas[vi, np.clip(ui + d, 0, W - 1)] = ci

    # trajectory polyline
    u, v, zc, inb = project(ctr)
    pts2d = np.stack([u, v], 1).astype(np.int32)
    for a in range(len(ctr) - 1):
        if inb[a] and inb[a + 1]:
            cv2.line(canvas, tuple(pts2d[a]), tuple(pts2d[a + 1]),
                     (0, 255, 0), 1, cv2.LINE_AA)

    # keyframe frusta (every Nth + the newest, ref draws all)
    step = max(len(ctr) // 12, 1)
    w_half, h_half, depth = 0.10 * scale, 0.075 * scale, 0.16 * scale
    corners_c = np.array([
        [0, 0, 0],
        [-w_half, -h_half, depth], [w_half, -h_half, depth],
        [w_half, h_half, depth], [-w_half, h_half, depth],
    ])
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    for i in list(range(0, len(ctr), step)) + [len(ctr) - 1]:
        col = (0, 160, 255) if i == len(ctr) - 1 else (180, 120, 0)
        Xw = ctr[i] + corners_c @ rots[i].T
        u, v, zc, inb = project(Xw)
        p2 = np.stack([u, v], 1).astype(np.int32)
        for a, b in edges:
            if inb[a] and inb[b]:
                cv2.line(canvas, tuple(p2[a]), tuple(p2[b]), col, 1, cv2.LINE_AA)
    return canvas


def _viewer_loop(q: mp.Queue, outdir: str):
    cv2 = optional.cv2("the viewer")
    show = bool(os.environ.get("DISPLAY"))
    os.makedirs(outdir, exist_ok=True)

    image = None
    poses = points = colors = None
    idx = 0
    while True:
        try:
            msg = q.get(timeout=0.1)
        except pyqueue.Empty:
            continue
        if msg is None:
            break
        kind, payload = msg
        if kind == "image":
            image = payload
        else:
            poses, points, colors = payload

        canvas = np.zeros((480, 640, 3), np.uint8)
        if poses is not None and len(poses):
            canvas = _render_3d(canvas, poses, points, colors)
            # top-down inset, lower-right quadrant
            inset = _render_topdown(np.zeros((160, 212, 3), np.uint8), poses, points, colors)
            canvas[-160:, -212:] = np.maximum(canvas[-160:, -212:] // 3, inset)
        if image is not None:
            h = 160
            w = int(image.shape[1] * h / image.shape[0])
            canvas[:h, :w] = cv2.resize(image, (w, h))[..., :3]
        if show:
            cv2.imshow("dpvo_tpu_torch", canvas)
            cv2.waitKey(1)
        elif idx % 10 == 0:
            cv2.imwrite(os.path.join(outdir, f"viewer_{idx:05d}.png"), canvas)
        idx += 1


class Viewer:
    """Non-blocking viewer handle (a spawned renderer process)."""

    def __init__(self, outdir: str = "viewer_out"):
        optional.cv2("the viewer")
        ctx = mp.get_context("spawn")
        self.q = ctx.Queue(maxsize=8)
        self.proc = ctx.Process(target=_viewer_loop, args=(self.q, outdir), daemon=True)
        self.proc.start()

    def _put(self, msg):
        try:
            self.q.put_nowait(msg)
        except pyqueue.Full:
            pass  # drop a snapshot rather than stall tracking

    def update_image(self, image: np.ndarray):
        self._put(("image", np.asarray(image)))

    def update_state(self, poses, points=None, colors=None):
        self._put(("state", (np.asarray(poses),
                             None if points is None else np.asarray(points),
                             None if colors is None else np.asarray(colors))))

    def join(self, timeout: float = 30.0):
        """Ask the renderer to stop after what is queued, wait for it (a
        spawned child first imports the package, seconds), and end it if it
        has not stopped within timeout."""
        try:
            self.q.put(None, timeout=timeout)
        except pyqueue.Full:  # a renderer that died stops taking snapshots
            pass
        self.proc.join(timeout=timeout)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=2.0)
