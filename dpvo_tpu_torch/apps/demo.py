"""Live VO demo on an image directory or a video — the port of
``apps/demo.py``.

  python -m dpvo_tpu_torch.apps.demo --imagedir data/frames \\
      --calib calib/iphone.txt --network weights.npz \\
      --save_trajectory --plot --save_ply --save_colmap [--device cpu]

Frames are decoded in a reader process (``data/stream.spawn_reader``,
OpenCV). ``run(args, frames)``
tracks any (t, image, intrinsics) iterable. The frame rate leaves out the
first 10 frames (warm-up), the clock read after the card has finished its
work; the peak is ``torch.cuda.max_memory_allocated``. Outputs go under
``--outdir``: saved_trajectories/<name>.txt (TUM),
trajectory_plots/<name>.pdf (matplotlib), <name>.ply and
colmap_saves/<name>/. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from dpvo_tpu_torch.apps.common import add_common_args, config_from_args

WARMUP = 10


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--imagedir", type=str, required=True, help="image dir or video path")
    p.add_argument("--calib", type=str, required=True)
    add_common_args(p)
    p.add_argument("--stride", type=int, default=2)
    p.add_argument("--skip", type=int, default=0)
    p.add_argument("--buffer", type=int, default=2048)
    p.add_argument("--viz", action="store_true")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--save_ply", action="store_true")
    p.add_argument("--save_colmap", action="store_true")
    p.add_argument("--save_trajectory", action="store_true")
    p.add_argument("--name", type=str, default="result")
    p.add_argument("--outdir", type=str, default=".")
    return p.parse_args(argv)


def run(args, frames):
    """Track frames, a (t, image [H,W,3] uint8 RGB, intrinsics [4]) iterable,
    then write what args asks for. Returns dict(slam, poses, tstamps,
    n_frames, fps (None for WARMUP frames or fewer), peak_mib (None on the
    CPU))."""
    from dpvo_tpu_torch.eval.export import (plot_trajectory, save_colmap, save_ply,
                                            save_trajectory_tum)
    from dpvo_tpu_torch.runtime.dpvo import DPVO, resolve_device

    device = resolve_device(args.device)
    cfg = config_from_args(args, BUFFER_SIZE=args.buffer)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    slam = None
    n_frames = 0
    t_start = None
    for t, image, intrinsics in frames:
        if slam is None:
            slam = DPVO(cfg, args.network or None, ht=image.shape[0], wd=image.shape[1],
                        viz=args.viz, device=device)
        if t_start is None and n_frames == WARMUP:
            sync()
            t_start = time.perf_counter()
        slam(t, image, intrinsics)
        n_frames += 1
    if slam is None:
        raise RuntimeError("demo: the stream held no frame")
    sync()
    fps = None
    if t_start is not None and n_frames > WARMUP:
        fps = (n_frames - WARMUP) / (time.perf_counter() - t_start)
        print(f"average FPS (post-warmup): {fps:.2f}")
    peak = torch.cuda.max_memory_allocated(device) / 2**20 if cuda else None
    if peak is not None:
        print(f"peak device memory: {peak:.1f} MiB")

    poses, tstamps = slam.terminate()
    name, out = args.name, args.outdir
    if args.save_trajectory:
        save_trajectory_tum(os.path.join(out, "saved_trajectories", f"{name}.txt"), poses,
                            tstamps)
    if args.plot:
        plot_trajectory(os.path.join(out, "trajectory_plots", f"{name}.pdf"), poses, title=name)
    if args.save_ply or args.save_colmap:
        pts, clr = slam.point_cloud()
        if args.save_ply:
            save_ply(os.path.join(out, f"{name}.ply"), pts, clr)
        if args.save_colmap:
            intr = slam.state.intrinsics[0].cpu().numpy() * cfg.RES
            save_colmap(os.path.join(out, "colmap_saves", name), slam.poses_np(), intr, pts, clr,
                        slam.ht, slam.wd)
    print(f"tracked {n_frames} frames -> {len(poses)} poses")
    return dict(slam=slam, poses=poses, tstamps=tstamps, n_frames=n_frames, fps=fps,
                peak_mib=peak)


def main(argv=None):
    from dpvo_tpu_torch.data.stream import spawn_reader
    from dpvo_tpu_torch.runtime.dpvo import resolve_device

    args = parse_args(argv)
    resolve_device(args.device)  # no card: raise before the reader starts
    queue, proc = spawn_reader(args.imagedir, args.calib, args.stride, args.skip)

    def frames():
        while True:
            t, image, intrinsics = queue.get()
            if t < 0:
                return
            yield t, image, intrinsics

    try:
        return run(args, frames())
    finally:
        proc.join(timeout=10.0)
        if proc.is_alive():
            proc.terminate()


if __name__ == "__main__":
    main()
