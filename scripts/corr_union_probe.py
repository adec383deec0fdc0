#!/usr/bin/env python3
"""What holds kernels A, B and C+D (csrc/corr_pallas.cu): their device
time per correlation call (both levels, the profiler) on chip_smoke.py
phase 2's geometry at C = 32, 64, 128 and 256 channels, beside the tiles
of 8 union positions they compute and the bytes those tiles read (C x 2
bytes a position; an item of a per-pixel branch reads 72 tiles).

    python3 scripts/corr_union_probe.py

A time that grows with C as the bytes do says the reads through L2 hold
the kernels; a time that stays flat says a fixed cost per item does.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    sys.path[:0] = [os.path.dirname(HERE), HERE]
    import torch

    if not torch.cuda.is_available():
        print("corr_union_probe: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from corr_digest import phase2_inputs
    from dpvo_tpu_torch.ops import corr_pallas as cp

    for C in (32, 64, 128, 256):
        gmap, fmap1, fmap2, coords, ii1, jj1, valid = phase2_inputs(torch, C)
        f1, cs, jj, vs, _ = cp.sort_edges(gmap, coords, ii1, jj1, valid)
        levels, tiles = [], {"A": 0, "B": 0, "C+D": 0}
        for fmap, scale in ((fmap1, 1.0), (fmap2, 4.0)):
            _, H, W, _ = fmap.shape
            win, _ = cp.window_inputs(cs / scale, vs, H, W, 3)
            lv = {"A": win}
            for name, inputs in (("B", cp.sw_inputs), ("C+D", cp.v3_inputs)):
                (syc, sxc), epi = inputs(cs / scale, vs, H, W, 3)
                lv[name] = (syc, sxc) + epi
                *_, uh, uw, fits = cp.window_union(syc[:, None] + epi[0], sxc[:, None] + epi[1])
                tiles[name] += int(torch.where(fits, (uh * uw + 7) // 8, 72)[vs].sum())
            *_, uh, uw, fits = cp.window_union(*win)
            tiles["A"] += int(torch.where(fits, (uh * uw + 7) // 8, 72)[vs].sum())
            levels.append((fmap, lv))
        kern = {"A": cp.corr_window, "B": cp.corr_sw_fused, "C+D": cp.corr_v3_fused}
        runs = {name: (lambda fn=fn, name=name: [fn(f1, m, jj, vs, *lv[name])
                                                 for m, lv in levels])
                for name, fn in kern.items()}
        items = 2 * int(vs.sum())
        for name, fn in runs.items():
            ms = chip_smoke.device_ms(fn, 20)
            nbytes = tiles[name] * 8 * C * 2
            print(f"C {C:3d} {name:3s}: device {ms:.4f} ms per call; {tiles[name] / items:.2f} "
                  f"tiles per item, {nbytes / 1e9:.3f} GB of tile reads, "
                  f"{nbytes / ms / 1e9:.2f} TB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
