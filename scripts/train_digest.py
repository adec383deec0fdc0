#!/usr/bin/env python3
"""Digest of the unsplit training step (``make_train_step`` without a
mesh), to show that two checkouts compute the same bits.

    python3 scripts/train_digest.py [--root DIR] [--device cpu]

Imports DIR's ``dpvo_tpu_torch`` (default: this checkout's) and takes, from
one state, one structure-only and one full step, then prints each step's
metrics and a SHA-256 of its metrics' and parameters' bytes. On the card
(the default device): chip_smoke.py phase 8's step at full width
(Config(), bf16, weights/vonet_synth.npz, its 15-frame 480x640 clip, 18
unroll steps, draws from generator seed 4). With ``--device cpu``: two
small configurations, the tiny f32 one of tests/test_train.py (SoftAgg's
segment_softmax branch) and a bf16 one with 24 patches a frame (its
grouped-sum branch), 64x96 clips, 6 unroll steps. Run it once per
checkout and compare the digests.
"""

import argparse
import hashlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_clip(F, ht, wd, seed=3):
    from dpvo_tpu_torch.utils.synthetic import PlaneScene

    scene = PlaneScene(ht=ht, wd=wd, n_frames=F, depth=4.0, seed=seed)
    ys, xs = np.mgrid[0:ht, 0:wd].astype(np.float64)
    return dict(images=np.stack([scene.render(t) for t in range(F)])[None].astype(np.float32),
                poses=scene.poses[None].astype(np.float32),
                disps=np.stack([scene.inv_depth(t, xs, ys) for t in range(F)])[None]
                .astype(np.float32),
                intrinsics=scene.intrinsics[None].astype(np.float32))


def cases(torch, device):
    """(name, config, networks, batch, generator seed, unroll steps)."""
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.runtime.weights import init_networks, load_networks

    if device == "cpu":
        for name, kw in (("tiny f32", dict(PATCHES_PER_FRAME=4, MIXED_PRECISION=False)),
                         ("24 patches bf16", dict(PATCHES_PER_FRAME=24, MIXED_PRECISION=True))):
            cfg = Config(DIM=32, FDIM=16, **kw)
            yield name, cfg, init_networks(cfg, torch.Generator().manual_seed(0)), \
                small_clip(6, 64, 96), 2, 6
        return
    from dpvo_tpu_torch.data.factory import SyntheticClipDataset

    torch.backends.cuda.matmul.allow_tf32 = False  # as the train entry point sets them
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config()
    clip = SyntheticClipDataset(n_frames=15, ht=480, wd=640, seed=5).sample()
    batch = {k: v[None] for k, v in zip(("images", "poses", "disps", "intrinsics"), clip)}
    yield "phase 8, Config() bf16", cfg, \
        load_networks(cfg, os.path.join(ROOT, "weights", "vonet_synth.npz")), batch, 4, 18


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=ROOT, help="the checkout whose dpvo_tpu_torch runs")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from dpvo_tpu_torch.train import make_optimizer, make_train_step

    if args.device == "cpu":
        torch.set_num_threads(1)
    elif not torch.cuda.is_available():
        raise SystemExit("train_digest: no CUDA device (pass --device cpu)")
    import dpvo_tpu_torch

    print(f"package {os.path.dirname(dpvo_tpu_torch.__file__)}, device {args.device}")
    for name, cfg, nets, batch, seed, steps in cases(torch, args.device):
        nets = nets.to(args.device)
        tx, _ = make_optimizer(total_steps=240000)
        step = make_train_step(cfg, tx, STEPS=steps)
        opt = tx.init({k: p.detach() for k, p in nets.named_parameters()})
        gen = torch.Generator().manual_seed(seed)
        for so in (True, False):
            nets, opt, m = step(nets, opt, batch, gen, structure_only=so)
            h = hashlib.sha256()
            for k in sorted(m):
                h.update(m[k].cpu().numpy().tobytes())
            for _, v in sorted(nets.state_dict().items()):
                h.update(v.cpu().numpy().tobytes())
            print(f"{name}, {'structure-only' if so else 'full'} step: sha256 "
                  f"{h.hexdigest()[:16]} " + " ".join(f"{k} {float(v)!r}"
                                                      for k, v in sorted(m.items())))


if __name__ == "__main__":
    main()
