#!/usr/bin/env python3
"""Print a SHA-256 digest of each correlation variant's output on one
seeded input, on the card, so that two checkouts of the port can be shown
to compute the same bits (run it once per checkout and diff the lines).

    python3 scripts/corr_digest.py [--root CHECKOUT]

The input has chip_smoke.py phase 2's shapes (40960 edges, 37344 live, 5%
of the patches spread 3-6 px; 22 frames of a [36, 120, 160, 128] and a
[36, 30, 40, 128] bf16 map). Printed: kernel A's raw windows per level
(``corr_window``) and the two-level features of every CORR_IMPL the port's
``ops/corr_pallas.py`` and ``ops/corr_cuda.py`` serve.

    python3 scripts/corr_digest.py [--root CHECKOUT] --path CORR_IMPL

also tracks chip_smoke.py's 480x640 scene for 30 frames with that
CORR_IMPL on the checkout (config/default.yaml, weights/vonet_synth.npz),
prints the digest of the trajectory and the profile of the last 5 frames
(device time by kernel), so that a path's kernels can be profiled on a
checkout whose own chip_smoke.py does not.
"""

import argparse
import hashlib
import importlib.util
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def phase2_inputs(torch, C=128, seed=5):
    """Correlation inputs of chip_smoke.py phase 2's shapes on the card, C
    channels: gmap, fmap1, fmap2, coords, ii1, jj1, valid."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    E_cap, E, Np, mem = 40960, 37344, 3456, 36
    gmap = torch.randn((Np, C, 3, 3), generator=g, device=dev).to(torch.bfloat16)
    fmap1 = torch.randn((mem, 120, 160, C), generator=g, device=dev).to(torch.bfloat16)
    fmap2 = torch.randn((mem, 30, 40, C), generator=g, device=dev).to(torch.bfloat16)
    ctr = torch.rand((E_cap, 1, 1, 2), generator=g, device=dev) * torch.tensor(
        [168.0, 128.0], device=dev) - 4.0
    off = torch.stack(torch.meshgrid(torch.arange(-1.0, 2.0, device=dev),
                                     torch.arange(-1.0, 2.0, device=dev), indexing="ij"), -1)
    spread = torch.where(torch.rand((E_cap, 1, 1, 1), generator=g, device=dev) < 0.05,
                         3 + 3 * torch.rand((E_cap, 1, 1, 1), generator=g, device=dev),
                         torch.ones((E_cap, 1, 1, 1), device=dev))
    coords = (ctr + spread * off.flip(-1)[None]
              + 0.3 * torch.randn((E_cap, 3, 3, 2), generator=g, device=dev)).contiguous()
    ii1 = torch.randint(0, Np, (E_cap,), generator=g, device=dev, dtype=torch.int32)
    jj1 = torch.randint(5, 27, (E_cap,), generator=g, device=dev, dtype=torch.int32)
    valid = torch.arange(E_cap, device=dev) < E
    return gmap, fmap1, fmap2, coords, ii1, jj1, valid


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(HERE),
                    help="checkout whose dpvo_tpu_torch is imported")
    ap.add_argument("--path", metavar="CORR_IMPL",
                    help="also track the 480x640 scene with this CORR_IMPL and profile it")
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("corr_digest: no CUDA device is available", file=sys.stderr)
        return 2
    from dpvo_tpu_torch.ops import corr_pallas as cp
    from dpvo_tpu_torch.ops.corr_cuda import corr_features

    args = phase2_inputs(torch)
    gmap, fmap1, fmap2, coords, ii1, jj1, valid = args

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()

    f1, cs, jj, vs, _ = cp.sort_edges(gmap, coords, ii1, jj1, valid)
    for lvl, (fmap, scale) in enumerate(((fmap1, 1.0), (fmap2, 4.0)), 1):
        _, H, W, _ = fmap.shape
        win, _ = cp.window_inputs(cs / scale, vs, H, W, 3)
        print(f"corr_window level {lvl} {digest(cp.corr_window(f1, fmap, jj, vs, *win))}")
    for name, fn in (("pallas", cp.corr_features_pallas), ("pallas_sw", cp.corr_features_pallas_sw),
                     ("pallas_dma", cp.corr_features_pallas_dma)):
        print(f"{name} {digest(fn(*args))}")
    print(f"xla {digest(corr_features(*args))}")
    print(f"pallas_fused {digest(corr_features(*args, clamp=True))}")
    torch.cuda.synchronize()
    if opts.path:
        track(torch, root, opts.path, digest)
    return 0


def track(torch, root, impl, digest, n_frames=30, n_prof=5):
    """The CORR_IMPL path on chip_smoke.py's 480x640 scene (phase 4's run),
    the last n_prof frames under the profiler; prints the profile (this
    script's chip_smoke.py prints it) and the digest of the trajectory."""
    from torch.profiler import ProfilerActivity, profile

    from dpvo_tpu_torch import DPVO, load_config

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(os.path.dirname(HERE), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    scene, frames = smoke.render_main_scene(n_frames)
    cfg = load_config(os.path.join(root, "config", "default.yaml"), overrides={"CORR_IMPL": impl})
    slam = DPVO(cfg, os.path.join(root, "weights", "vonet_synth.npz"), 480, 640)
    for t in range(n_frames - n_prof):
        slam(t, frames[t], scene.intrinsics.copy())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(n_frames - n_prof, n_frames):
            slam(t, frames[t], scene.intrinsics.copy())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"CORR_IMPL={impl} path, the last {n_prof} of {n_frames} frames:")
    smoke._print_profile(prof, wall_ms, n_prof, top=25)
    poses, _ = slam.terminate()
    print(f"CORR_IMPL={impl} trajectory {digest(torch.as_tensor(poses))}")


if __name__ == "__main__":
    sys.exit(main())
