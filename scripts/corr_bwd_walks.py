#!/usr/bin/env python3
"""corr_bwd's two walks, timed apart: csrc/corr_bwd.cu walks the union of
an edge's 9 pixel windows once where that union (clipped to the map)
holds at most kUnionMax positions, else each pixel's 64 positions. This
builds the kernel with kUnionMax set to 0 (every edge walks per pixel),
to 1 << 30 (every edge walks its union) and to values between, and times
each build (CUDA events, the kernel alone) on

- the training traffic: the last unroll step's corr_backward inputs
  (E 18000) of one full-width bf16 train step (Config(), 480x640, 15
  frames, 18 unroll steps, weights/vonet_synth.npz, a SyntheticClipDataset
  clip), with the distribution of the union sizes there;
- chip_smoke.py's corr_bwd case (E 18000, 5% of the edges spread 3-6 px);
- every edge spread s px apart (s = 1 ... 12), to find where one walk
  overtakes the other.

    python3 scripts/corr_bwd_walks.py
"""

import ctypes
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
UNION_MAX = (0, 64, 128, 256, 576, 1024, 1 << 30)


def build_variants(kernels, tmp):
    """{kUnionMax: loaded library} built from csrc/corr_bwd.cu."""
    src = (kernels.CSRC / "corr_bwd.cu").read_text()
    pat = r"constexpr int kUnionMax = \d+;"
    if len(re.findall(pat, src)) != 1:
        raise RuntimeError("corr_bwd.cu: no single kUnionMax constant to vary")
    procs = {}
    for n in UNION_MAX:
        cu = os.path.join(tmp, f"corr_bwd_{n}.cu")
        with open(cu, "w") as f:
            f.write(re.sub(pat, f"constexpr int kUnionMax = {n};", src))
        so = os.path.join(tmp, f"libcorr_bwd_{n}.so")
        procs[n] = (so, subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                                          "-o", so, cu], stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    libs = {}
    for n, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the kUnionMax {n} build:\n{log}")
        lib = ctypes.CDLL(so)
        lib.dpvo_corr_backward.argtypes = kernels._SIGNATURES["dpvo_corr_backward"]
        lib.dpvo_corr_backward.restype = ctypes.c_int
        libs[n] = lib
    return libs


def launcher(torch, kernels, lib, args):
    """A function launching one build on args (corr_backward's inputs),
    and the buffers it writes (d f1, d fmap1, d fmap2)."""
    g, gmap, fmap1, fmap2, coords, ii1, jj1, valid = args[:8]
    g = g.contiguous()
    E, C = coords.shape[0], gmap.shape[1]
    mem, H1, W1, _ = fmap1.shape
    _, H2, W2, _ = fmap2.shape
    dev = coords.device
    df1 = torch.empty((E, C * 9), dtype=torch.float32, device=dev)
    dfm1 = torch.zeros(fmap1.shape, dtype=torch.float32, device=dev)
    dfm2 = torch.zeros(fmap2.shape, dtype=torch.float32, device=dev)

    def call():
        rc = lib.dpvo_corr_backward(
            g.data_ptr(), gmap.data_ptr(), fmap1.data_ptr(), fmap2.data_ptr(),
            coords.data_ptr(), ii1.data_ptr(), jj1.data_ptr(), valid.data_ptr(), df1.data_ptr(),
            dfm1.data_ptr(), dfm2.data_ptr(), E, gmap.shape[0], mem, C, H1, W1, H2, W2,
            int(gmap.dtype == torch.bfloat16), int(g.dtype == torch.bfloat16),
            kernels.stream_ptr(coords))
        kernels.check("corr_backward", rc)

    return call, (df1, dfm1, dfm2)


def union_sizes(torch, coords, valid, H, W, scale):
    """Each valid edge's union of its pixels' 8 x 8 windows, clipped to
    the H x W map, in positions (as the kernel computes it)."""
    x, y = coords[..., 0].reshape(-1, 9) / scale, coords[..., 1].reshape(-1, 9) / scale
    x0 = torch.floor(x.clamp(-64, W + 64)) - 3
    y0 = torch.floor(y.clamp(-64, H + 64)) - 3
    h = (torch.minimum(y0.amax(1) + 7, torch.tensor(H - 1.0, device=y.device))
         - y0.amin(1).clamp(min=0) + 1).clamp(min=0)
    w = (torch.minimum(x0.amax(1) + 7, torch.tensor(W - 1.0, device=x.device))
         - x0.amin(1).clamp(min=0) + 1).clamp(min=0)
    return (h * w)[valid]


def traffic(torch):
    """corr_backward's inputs at the last unroll step of one full-width
    bf16 train step."""
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.data.factory import SyntheticClipDataset
    from dpvo_tpu_torch.ops import corr_cuda
    from dpvo_tpu_torch.runtime.weights import load_networks
    from dpvo_tpu_torch.train import make_optimizer, make_train_step

    cfg = Config()
    nets = load_networks(cfg, os.path.join(ROOT, "weights", "vonet_synth.npz")).cuda()
    clip = SyntheticClipDataset(n_frames=15, ht=480, wd=640, seed=5).sample()
    batch = {k: v[None] for k, v in zip(("images", "poses", "disps", "intrinsics"), clip)}
    tx, _ = make_optimizer(lr=8e-5, total_steps=240000)
    state = tx.init({k: p.detach() for k, p in nets.named_parameters()})
    step = make_train_step(cfg, tx, STEPS=18)
    seen = []
    inner = corr_cuda.corr_backward

    def record(*args):
        seen.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return inner(*args)

    corr_cuda.corr_backward = record
    try:
        step(nets, state, batch, torch.Generator().manual_seed(3))
    finally:
        corr_cuda.corr_backward = inner
    return max(seen, key=lambda a: a[4].shape[0])


def spread_case(torch, g, s, E=18000, F=15, M=80, H=120, W=160, C=128):
    """chip_smoke.py's corr_bwd case with every edge's pixels s px apart."""
    dev = torch.device("cuda")
    gmap = torch.randn((F * M, C, 3, 3), generator=g, device=dev).bfloat16()
    fmap1 = torch.randn((F, H, W, C), generator=g, device=dev).bfloat16()
    fmap2 = torch.randn((F, H // 4, W // 4, C), generator=g, device=dev).bfloat16()
    ctr = torch.rand((E, 1, 1, 2), generator=g, device=dev) * torch.tensor(
        [W + 16.0, H + 16.0], device=dev) - 8.0
    off = torch.stack(torch.meshgrid(torch.arange(-1.0, 2.0, device=dev),
                                     torch.arange(-1.0, 2.0, device=dev), indexing="ij"), -1)
    coords = (ctr + s * off.flip(-1)[None]
              + 0.3 * torch.randn((E, 3, 3, 2), generator=g, device=dev)).contiguous()
    kk = (torch.arange(E, device=dev) // F).to(torch.int32)
    jj = (torch.arange(E, device=dev) % F).to(torch.int32)
    valid = torch.ones(E, dtype=torch.bool, device=dev)
    gout = torch.randn((E, 9, 128), generator=g, device=dev).bfloat16()
    return gout, gmap, fmap1, fmap2, coords, kk, jj, valid


def main():
    sys.path[:0] = [ROOT]
    import torch

    if not torch.cuda.is_available():
        print("corr_bwd_walks: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from dpvo_tpu_torch import kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(kernels, tmp)
        g = torch.Generator(device="cuda").manual_seed(0)
        cases = [("training traffic", traffic(torch)[:8]),
                 ("chip_smoke's case", chip_smoke.train_corr_case(torch, g, torch.bfloat16)[:8])]
        cases += [(f"spread {s} px", spread_case(torch, g, s)) for s in (1, 2, 3, 4, 6, 8, 12)]
        print("kUnionMax: " + ", ".join("per pixel" if n == 0 else "union" if n == 1 << 30
                                        else str(n) for n in UNION_MAX))
        for name, args in cases:
            coords, valid = args[4], args[7]
            for lv, (fm, sc) in enumerate(((args[2], 1.0), (args[3], 4.0))):
                a = union_sizes(torch, coords, valid, fm.shape[1], fm.shape[2], sc).float()
                print(f"{name}: E {coords.shape[0]} ({int(valid.sum())} valid), level "
                      f"{lv + 1} union positions: mean {a.mean().item():.1f}, median "
                      f"{a.median().item():.0f}, max {a.max().item():.0f}; share <= 64 / 128 / "
                      f"256 / 576: " + " / ".join(f"{(a <= t).float().mean().item():.4f}"
                                                   for t in (64, 128, 256, 576)))
            ref = None
            times = []
            for n, lib in libs.items():
                call, outs = launcher(torch, kernels, lib, args)
                call()
                torch.cuda.synchronize()
                if ref is None:
                    ref = [o.clone() for o in outs]
                else:
                    err = max(((o - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()
                              for o, r in zip(outs, ref))
                    if err > 1e-4:
                        raise AssertionError(f"{name}: the kUnionMax {n} build disagrees with "
                                             f"the per-pixel one ({err:.3g} relative)")
                times.append(chip_smoke.cuda_ms(call, 10))
            print(f"{name}: ms " + ", ".join(f"{t:.4f}" for t in times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
