"""What the port's entry points share: the device, network and config
arguments, the configuration they build, and the evaluation scripts'
command line."""

from __future__ import annotations

import argparse
import os


def add_common_args(p: argparse.ArgumentParser, config: str = "config/default.yaml"):
    p.add_argument("--network", default="", help=".npz weights or an export directory "
                   "(random weights if empty)")
    p.add_argument("--config", default=config)
    p.add_argument("--opts", nargs="+", default=[], help="config overrides: KEY VALUE ...")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or 'cpu'")


def config_from_args(args, **defaults):
    """The Config of args.config (when the file exists) with the --opts
    overrides, then ``defaults`` where --opts left a key unset; on the CPU
    MIXED_PRECISION defaults to false, as in the JAX entry points."""
    from dpvo_tpu_torch.config import load_config

    overrides = dict(zip(args.opts[0::2], args.opts[1::2]))
    for k, v in defaults.items():
        overrides.setdefault(k, v)
    if args.device == "cpu":
        overrides.setdefault("MIXED_PRECISION", False)
    if getattr(args, "loop_closure", False):
        overrides["LOOP_CLOSURE"] = True
    return load_config(args.config if os.path.exists(args.config) else None, overrides)


def evaluate_parser(datadir: str, stride: bool = True) -> argparse.ArgumentParser:
    """The command line of an evaluate_* script."""
    p = argparse.ArgumentParser()
    p.add_argument("--datadir", default=datadir)
    add_common_args(p)
    if stride:
        p.add_argument("--stride", type=int, default=1)
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--loop_closure", action="store_true")
    return p


def evaluate(args, sequences, gt, max_dt: float, title: str):
    """Score sequences with the N-trial protocol (``eval/protocol.py``) on
    args.device; raises without a card unless --device cpu."""
    from dpvo_tpu_torch.eval.protocol import evaluate_sequences
    from dpvo_tpu_torch.runtime.dpvo import resolve_device

    device = resolve_device(args.device)
    cfg = config_from_args(args)
    return evaluate_sequences(cfg, args.network or None, sequences, gt, trials=args.trials,
                              max_dt=max_dt, title=title, device=device)
