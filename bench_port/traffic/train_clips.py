"""The general generator of training clips: textured planes at several
depths seen by a moving camera, with ground-truth poses, inverse depths
and intrinsics, and the unroll's random draws, all from the run's seed.

The scene is a copy of ``dpvo_tpu_torch/utils/synthetic.py``'s
``MultiPlaneScene`` (:174-232: a background plane and billboards at
depths drawn between 1.2 m and the background's, textures offset a plane)
and the clip parameters of ``data/factory.py:SyntheticClipDataset.sample``
(:33-50: a background depth, a translational and a rotational flow a
frame, which set the random walk's steps), rendered in f64 on the device
by ``plane_scene.py``'s ray lookup, a frame at a time. A clip is given in
the form the recipe's batcher feeds a step (``data/factory.py:
batch_iterator``): images [B, F, H, W, 3] uint8, poses [B, F, 7] f32
world-to-camera, disps [B, F, H, W] f16, intrinsics [B, 4] f32, as numpy
arrays on the host. The batcher's photometric augmentation is left out.

A traffic file gives ``clips`` (the pool a run's steps cycle through,
each a batch of the recipe's clips), ``planes``, the ranges ``depth``,
``flow_t`` and ``flow_r``, and ``drop_p``, the chance of each unroll
step's frame dropout. The draws of each clip, as the port's
``models/vonet.draw_inputs`` lays them out (points [F, K, 2] at 1/4
resolution, x in [1, w-1) then y in [1, h-1); d0 [F*M] uniform in
[0, 1); drop [STEPS] bool), come from the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.stats import sub_seed
from bench_port.traffic.plane_scene import _rotmats, smooth_texture, walk_poses


def _scene(rng, F: int, ht: int, wd: int, params: dict, device):
    """One clip's frames [F, H, W, 3] uint8, inverse depths [F, H, W] f32
    (on the device) and poses [F, 7]."""
    f = 0.8 * wd
    depth = float(rng.uniform(*params["depth"]))
    flow_t = float(rng.uniform(*params["flow_t"]))
    flow_r = float(rng.uniform(*params["flow_r"]))
    walk_seed = int(rng.integers(1 << 30))
    poses = walk_poses(F, walk_seed, flow_t * depth / f / 3.0, flow_r / f / 3.0)
    tex = smooth_texture(int(rng.integers(1 << 30)), device)
    n = params["planes"]
    rects = []
    for z in np.sort(rng.uniform(1.2, depth - 0.5, n))[::-1]:   # far to near
        hx, hy = z * (wd / 2) / f, z * (ht / 2) / f
        rects.append((float(z), rng.uniform(-hx, hx), rng.uniform(-hy, hy),
                      rng.uniform(0.25, 0.9) * hx, rng.uniform(0.25, 0.9) * hy))
    off = torch.as_tensor(rng.integers(0, tex.shape[0], size=(n + 1, 2)), device=device)

    ys, xs = torch.meshgrid(torch.arange(ht, device=device, dtype=torch.float64),
                            torch.arange(wd, device=device, dtype=torch.float64), indexing="ij")
    d_cam = torch.stack([(xs - wd / 2) / f, (ys - ht / 2) / f, torch.ones_like(xs)], -1)
    scale = tex.shape[0] / 12.0
    images = torch.empty((F, ht, wd, 3), dtype=torch.uint8, device=device)
    disps = torch.empty((F, ht, wd), dtype=torch.float32, device=device)
    for t in range(F):
        g = torch.as_tensor(np.asarray(poses[t], np.float64), device=device)[None]
        R = _rotmats(g[:, 3:7])
        o = -(R.transpose(1, 2) @ g[:, :3, None])[0, :, 0]         # camera centre
        d = torch.einsum("hwc,cd->hwd", d_cam, R[0])                # rays in the world
        dz = torch.where(d[..., 2].abs() > 1e-6, d[..., 2], torch.full_like(d[..., 2], 1e-6))
        tt = (depth - o[2]) / dz
        tt = torch.where(tt > 0.1, tt, torch.full_like(tt, 1e6))
        idx = torch.full(tt.shape, -1, dtype=torch.int64, device=device)
        for i, (z, cx, cy, hw, hh) in enumerate(rects):
            ti = (z - o[2]) / dz
            hit = ((ti > 0.1) & (ti < tt) & ((o[0] + ti * d[..., 0] - cx).abs() < hw)
                   & ((o[1] + ti * d[..., 1] - cy).abs() < hh))
            tt = torch.where(hit, ti, tt)
            idx = torch.where(hit, torch.full_like(idx, i), idx)
        px, py = o[0] + tt * d[..., 0], o[1] + tt * d[..., 1]
        o_i = off[idx]   # idx -1: the last row, the background's
        ti_ = torch.remainder((px * scale).to(torch.int64) + o_i[..., 0], tex.shape[0])
        tj_ = torch.remainder((py * scale).to(torch.int64) + o_i[..., 1], tex.shape[1])
        images[t] = tex[tj_, ti_]
        disps[t] = (1.0 / torch.clamp(tt, min=1e-6)).to(torch.float32)
    return images, disps, poses


def make_clips(params: dict, seed: int, ht: int, wd: int, frames: int, batch: int, res: int,
               points: int, patches: int, steps: int, device) -> list:
    """The traffic's pool of ``clips`` batches for one run, each (batch
    dict of numpy arrays, [draws a clip]): frames of ht x wd, ``points``
    patch centroids (or candidates) a frame on the 1/``res`` grid,
    ``patches`` initial inverse depths a frame, ``steps`` dropout coins."""
    h, w = ht // res, wd // res
    f = 0.8 * wd
    intr = np.array([f, f, wd / 2, ht / 2], np.float32)
    out = []
    for c in range(params["clips"]):
        imgs, dps, pss, draws = [], [], [], []
        for b in range(batch):
            rng = np.random.default_rng(sub_seed(seed, 0x7C11, c, b))
            images, disps, poses = _scene(rng, frames, ht, wd, params, device)
            imgs.append(images.cpu().numpy())
            dps.append(disps.to(torch.float16).cpu().numpy())
            pss.append(poses.astype(np.float32))
            x = rng.integers(1, w - 1, (frames, points))
            y = rng.integers(1, h - 1, (frames, points))
            draws.append({
                "points": torch.as_tensor(np.stack([x, y], -1).astype(np.float32)),
                "d0": torch.as_tensor(rng.random(frames * patches, dtype=np.float32)),
                "drop": torch.as_tensor(rng.random(steps) < params["drop_p"])})
        out.append(({"images": np.stack(imgs), "poses": np.stack(pss), "disps": np.stack(dps),
                     "intrinsics": np.stack([intr] * batch)}, draws))
    return out
