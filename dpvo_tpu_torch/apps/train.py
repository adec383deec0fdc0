"""Train the VO network: the port of ``apps/train.py``.

The recipe: AdamW + linear OneCycle (lr 8e-5, weight decay 1e-6),
gradient clipping at 10, structure-only BA for the first 1000 steps of a
fresh start, npz snapshots (the JAX ``save_params`` format, which both
packages' trackers load), checkpoints of parameters, optimizer state and
step (``torch.save``), and held-out validation with a divergence guard.

  python -m dpvo_tpu_torch.apps.train --name exp1 --datapath datasets/TartanAir \\
      --steps 240000 --n_frames 15 --batch 1 [--init_encoders onnx_models]

``--dataset tartan`` (the default) reads TartanAir scenes under
``--datapath`` (``data/tartan.py``); where it holds none, synthetic clips,
as in the JAX package. ``--init_encoders DIR`` loads the reference's
``fnet.onnx`` and ``inet.onnx`` into the encoders
(``runtime/torch_port.py``).

Runs on the CUDA card unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--name", default="bla")
    p.add_argument("--ckpt", default=None, help="checkpoint file to restore")
    p.add_argument("--datapath", default="datasets/TartanAir")
    p.add_argument("--dataset", default="tartan", choices=["tartan", "synthetic"])
    p.add_argument("--steps", type=int, default=240000)
    p.add_argument("--lr", type=float, default=8e-5)
    p.add_argument("--clip", type=float, default=10.0)
    p.add_argument("--n_frames", type=int, default=15)
    p.add_argument("--unroll", type=int, default=18)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--pose_weight", type=float, default=10.0)
    p.add_argument("--flow_weight", type=float, default=0.1)
    p.add_argument("--ht", type=int, default=480)
    p.add_argument("--wd", type=int, default=640)
    p.add_argument("--mesh", default=None, help="e.g. 2,4 for (data,edge)")
    p.add_argument("--ckpt_every", type=int, default=10000)
    p.add_argument("--npz_every", type=int, default=1000,
                   help="inference-weight snapshot cadence (npz)")
    p.add_argument("--log_every", type=int, default=10,
                   help="metric fetch cadence (each fetch waits for the device)")
    p.add_argument("--init_encoders", default=None, metavar="DIR",
                   help="directory with the reference fnet.onnx/inet.onnx")
    p.add_argument("--freeze_encoders", action="store_true",
                   help="zero encoder updates (train the update operator only)")
    p.add_argument("--init_npz", default=None, metavar="NPZ",
                   help="warm-start all parameters from an npz snapshot (save_params format)")
    p.add_argument("--structure_only", type=int, default=1000,
                   help="depth-only BA for the first N fresh-start steps")
    p.add_argument("--flow_t", default=None, metavar="MIN,MAX",
                   help="synthetic target translational flow range (px/frame)")
    p.add_argument("--flow_r", default=None, metavar="MIN,MAX",
                   help="synthetic target rotational flow range")
    p.add_argument("--val_every", type=int, default=0,
                   help="held-out-clip validation cadence (0 = off)")
    p.add_argument("--val_clips", type=int, default=4)
    p.add_argument("--reservoir", type=int, default=0,
                   help="sample batches from a pool of the newest N clips (0 = fresh clips)")
    p.add_argument("--opts", nargs="+", default=[],
                   help="config overrides, e.g. --opts DIM 64 FDIM 32")
    p.add_argument("--device", default="", help="'cpu', or a CUDA device (the default)")
    p.add_argument("--outdir", default=".", help="where checkpoints/ and runs/ go")
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """The run's device: the CUDA card unless 'cpu' is asked for; without a
    card that raises."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("training needs a CUDA device (none is available); pass "
                           "--device cpu to train on the CPU")
    return torch.device(name or "cuda")


def main(argv=None):
    args = parse_args(argv)
    if args.mesh:
        raise NotImplementedError("--mesh (multi-card training) is not ported yet (ROADMAP "
                                  "queue 1, item 8)")
    device = resolve_device(args.device)

    from dpvo_tpu_torch.config import Config, load_config
    from dpvo_tpu_torch.data.factory import SyntheticClipDataset, batch_iterator, dataset_factory
    from dpvo_tpu_torch.runtime.weights import (init_networks, load_npz, params_from_jax,
                                                save_npz)
    from dpvo_tpu_torch.train import make_optimizer, make_train_step, make_val_step
    from dpvo_tpu_torch.train.logger import Logger

    overrides = dict(zip(args.opts[0::2], args.opts[1::2]))
    if device.type == "cpu":
        overrides.setdefault("MIXED_PRECISION", False)
    cfg = load_config(None, overrides) if overrides else Config()
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 stays f32, as in the tracker
        torch.backends.cudnn.allow_tf32 = False
    nets = init_networks(cfg, torch.Generator().manual_seed(0))
    if args.init_encoders:
        from dpvo_tpu_torch.runtime.torch_port import port_reference_encoders

        port_reference_encoders(nets, os.path.join(args.init_encoders, "fnet.onnx"),
                                os.path.join(args.init_encoders, "inet.onnx"))
        print(f"encoders initialized from {args.init_encoders}")
    if args.init_npz:
        nets.load_state_dict(params_from_jax(load_npz(args.init_npz)), strict=True)
        print(f"warm-started from {args.init_npz}")
    nets = nets.to(device)
    tx, _ = make_optimizer(lr=args.lr, total_steps=args.steps, clip=args.clip,
                           freeze_encoders=args.freeze_encoders)
    opt_state = tx.init({k: p.detach() for k, p in nets.named_parameters()})

    ckpt_dir = os.path.join(args.outdir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    start_step = 0
    if args.ckpt:
        ck = torch.load(args.ckpt, map_location=device, weights_only=False)
        nets.load_state_dict(ck["params"])
        opt_state, start_step = ck["opt_state"], ck["step"]
        print(f"restored from {args.ckpt} at step {start_step}")

    synth_kw = {}
    if args.flow_t:
        synth_kw["flow_t"] = tuple(float(x) for x in args.flow_t.split(","))
    if args.flow_r:
        synth_kw["flow_r"] = tuple(float(x) for x in args.flow_r.split(","))
    ds = dataset_factory([args.dataset], datapath=args.datapath, n_frames=args.n_frames,
                         ht=args.ht, wd=args.wd, **synth_kw)
    batches = batch_iterator(ds, batch_size=args.batch, reservoir=args.reservoir)

    logger = Logger(args.name, outdir=os.path.join(args.outdir, "runs"))
    gen = torch.Generator().manual_seed(1234)

    val_batch = None
    if args.val_every:
        # fixed held-out clips from a seed range disjoint from the training stream
        vds = SyntheticClipDataset(n_frames=args.n_frames, ht=args.ht, wd=args.wd,
                                   seed=999_000, **synth_kw)
        clips = [vds.sample() for _ in range(args.val_clips)]
        val_batch = {k: np.stack([c[i] for c in clips])
                     for i, k in enumerate(("images", "poses", "disps", "intrinsics"))}

    step_fn = make_train_step(cfg, tx, STEPS=args.unroll, flow_weight=args.flow_weight,
                              pose_weight=args.pose_weight, frozen_encoders=args.freeze_encoders)
    val_fn = (make_val_step(cfg, STEPS=args.unroll, flow_weight=args.flow_weight,
                            pose_weight=args.pose_weight) if args.val_every else None)
    tlast = time.time()
    # divergence guard: on a validation loss above 2x the best, restore the
    # best parameters and optimizer state and halve the update scale
    lr_scale = 1.0
    best_val = float("inf")
    best_snap = None
    for step in range(start_step, args.steps):
        batch = next(batches)
        so = (step < args.structure_only and args.ckpt is None and args.init_npz is None
              and start_step == 0)
        nets, opt_state, metrics = step_fn(nets, opt_state, batch, gen, structure_only=so,
                                           lr_scale=lr_scale)
        if (step + 1) % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}  # waits for the device
            now = time.time()
            m["steps_per_s"] = args.log_every / max(now - tlast, 1e-9)
            m["lr_scale"] = lr_scale
            tlast = now
            logger.push(m, step=step + 1)

        if val_fn is not None and (step + 1) % args.val_every == 0:
            vm = val_fn(nets, val_batch, [_val_draws(cfg, val_batch, args.unroll, device, i)
                                          for i in range(args.val_clips)])
            vm = {f"val_{k}": float(v) for k, v in vm.items()}
            logger.write_dict(vm, step=step + 1)
            print(f"[val @{step + 1}] " + " ".join(f"{k}={v:.4g}" for k, v in vm.items()),
                  flush=True)
            # the guard engages once the pose loss is live
            if step + 1 > args.structure_only or args.init_npz or args.ckpt:
                vl = vm["val_loss"]
                if vl < best_val:
                    best_val = vl
                    best_snap = (copy.deepcopy(nets.state_dict()), copy.deepcopy(opt_state),
                                 step + 1)
                    save_npz(os.path.join(ckpt_dir, f"{args.name}_best.npz"), best_snap[0])
                elif vl > 2.0 * best_val and best_snap is not None:
                    lr_scale = max(lr_scale * 0.5, 1.0 / 64.0)
                    nets.load_state_dict(best_snap[0])
                    opt_state = copy.deepcopy(best_snap[1])
                    print(f"[guard @{step + 1}] val_loss {vl:.1f} > 2x best {best_val:.1f}: "
                          f"restored best (step {best_snap[2]}), lr_scale -> {lr_scale:.4f}",
                          flush=True)

        if (step + 1) % args.npz_every == 0:
            save_npz(os.path.join(ckpt_dir, f"{args.name}_{step + 1:06d}.npz"),
                     nets.state_dict())
            print(f"npz snapshot at {step + 1}", flush=True)
        if (step + 1) % args.ckpt_every == 0:
            torch.save({"params": nets.state_dict(), "opt_state": opt_state, "step": step + 1},
                       os.path.join(ckpt_dir, f"{args.name}_{step + 1:06d}.pt"))
            print(f"saved checkpoint at {step + 1}", flush=True)

    logger.close()
    print("training loop done")
    return nets, opt_state


def _val_draws(cfg, batch, steps: int, device, i: int):
    """Fixed draws for held-out clip i (the same every validation pass)."""
    from dpvo_tpu_torch.models.vonet import draw_inputs

    F, H, W = batch["images"].shape[1:4]
    return draw_inputs(F, cfg.PATCHES_PER_FRAME, H // cfg.RES, W // cfg.RES, steps,
                       torch.Generator().manual_seed(7 + i), device)


if __name__ == "__main__":
    main()
