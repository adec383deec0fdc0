"""Export the network as ``torch.export`` programs for deployment — the
port of ``apps/export_network.py`` (``deploy/export.py`` has the layout).

  python -m dpvo_tpu_torch.apps.export_network --network weights.npz \\
      --outdir exported --ht 480 --wd 640 [--e_max 36864] [--device cpu]

The programs are exported on ``--device`` (the card unless ``cpu``) and run
there; ``DPVO(cfg, network=<outdir>)`` loads them.
"""

from __future__ import annotations

import argparse

from dpvo_tpu_torch.apps.common import add_common_args, config_from_args


def main(argv=None):
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--outdir", default="exported")
    p.add_argument("--ht", type=int, default=480)
    p.add_argument("--wd", type=int, default=640)
    p.add_argument("--e_max", type=int, default=0)
    args = p.parse_args(argv)

    from dpvo_tpu_torch.deploy.export import export_network
    from dpvo_tpu_torch.runtime.dpvo import resolve_device
    from dpvo_tpu_torch.runtime.weights import load_networks

    device = resolve_device(args.device)
    cfg = config_from_args(args)
    nets = load_networks(cfg, args.network or None, seed=0)
    out = export_network(nets, cfg, args.ht, args.wd, args.outdir, device=device,
                         e_max=args.e_max or None)
    print(f"exported torch.export programs to {out}")
    return out


if __name__ == "__main__":
    main()
