#!/usr/bin/env python3
"""Where a tiny f32 training unroll's gradient on the card parts from the
CPU's, term by term.

    python3 scripts/train_grad_parity.py [--device cuda]

The configuration is tests/test_torch_cuda.py's card-against-CPU train
step: PATCHES_PER_FRAME 4, DIM 32, FDIM 16, f32 (TF32 off), a 64x64
PlaneScene clip (seed 0) of 4 frames, 4 unroll steps, ``init_networks``
seed 0, draws seed 4. It prints, for the CPU and the device:

- the clip loss, and each unroll step's flow and pose terms;
- each term's gradient distance between the two, relative to the CPU's
  (the whole gradient, and the worst leaf among those whose CPU norm is
  at least 1e-5 of the whole's: the conv biases before an instance norm
  have a zero gradient in exact arithmetic and only rounding in f32);
- the NaN entries the update operator's gradient clip zeroes, per call;
- the discrete choices on the gradient's path that differ from the CPU's:
  each supervised edge's pixel of least flow error, the supervision
  mask, BA's residual gate and its depth clamp;
- the same for the CPU against itself with the weights scaled by 1 + 1e-6
  (how far rounding carries), for two device runs, and for a device run
  with cuDNN's deterministic algorithms; and each run's gradient distance
  from the CPU's at weight scalings 1 +- 1e-6.
"""

import argparse
import copy
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def setup(torch):
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.models.vonet import draw_inputs
    from dpvo_tpu_torch.runtime.weights import init_networks
    from dpvo_tpu_torch.utils.synthetic import PlaneScene

    cfg = Config(PATCHES_PER_FRAME=4, DIM=32, FDIM=16, MIXED_PRECISION=False)
    HT, WD, F = 64, 64, 4
    scene = PlaneScene(ht=HT, wd=WD, n_frames=F, depth=4.0, seed=0)
    ys, xs = np.mgrid[0:HT, 0:WD]
    clip = [torch.tensor(np.stack([scene.render(t) for t in range(F)]), dtype=torch.float32),
            torch.tensor(scene.poses, dtype=torch.float32),
            torch.tensor(np.stack([scene.inv_depth(t, xs.astype(np.float64),
                                                   ys.astype(np.float64)) for t in range(F)]),
                         dtype=torch.float32),
            torch.tensor(scene.intrinsics, dtype=torch.float32)]
    draws = draw_inputs(F, 4, HT // 4, WD // 4, 4, torch.Generator().manual_seed(4))
    nets = init_networks(cfg, torch.Generator().manual_seed(0))
    return cfg, clip, draws, nets


def run(torch, cfg, clip, draws, nets, dev, scale=1.0):
    """(total loss, [(term name, loss, {leaf: grad})], total grads, NaN
    counts of the gradient clip's calls, per step (each edge's pixel of
    least flow error, the supervision mask), per BA iteration (its
    residual gate, its depth clamp)) on device ``dev``."""
    from dpvo_tpu_torch.ba import solver
    from dpvo_tpu_torch.models import blocks
    from dpvo_tpu_torch.models.vonet import vo_forward
    from dpvo_tpu_torch.train.loss import flow_error, pose_error

    nans = []
    inner = blocks._GradientClip.backward

    def counted(ctx, g):
        nans.append(int(torch.isnan(g).sum()))
        return inner(ctx, g)

    gates = []
    center, retr = solver._center_residuals, solver.apply_depth_retr

    def gated(prob, bounds, res_clip):
        out = center(prob, bounds, res_clip)
        gates.append(("BA gate", (out[1] != 0).any(-1).cpu()))
        return out

    def clamped(depths, dZ, clamp_mode="runtime"):
        d = depths + dZ
        gates.append(("depth clamp", ((d < 1e-3) | (d > 10.0)).cpu()))
        return retr(depths, dZ, clamp_mode)

    n = copy.deepcopy(nets).to(dev)
    with torch.no_grad():
        for p in n.parameters():
            p.mul_(scale)
    named = [(k, p) for k, p in n.named_parameters()]
    blocks._GradientClip.backward = staticmethod(counted)
    solver._center_residuals, solver.apply_depth_retr = gated, clamped
    try:
        traj = vo_forward(n, cfg, *(t.to(dev) for t in clip),
                          {k: v.to(dev) for k, v in draws.items()}, STEPS=4, remat=False)
        terms, picks = [], []
        for i, (valid, coords, coords_gt, Gs, nn) in enumerate(traj):
            e = (coords - coords_gt).reshape(coords.shape[0], 9, 2).norm(dim=-1)
            picks.append((e.argmin(-1).cpu(), (valid > 0.5).cpu()))
            terms.append((f"flow {i}", 0.1 * flow_error(valid, coords, coords_gt, 3)[0]))
            if i >= 2:
                tr, ro = pose_error(Gs, clip[1].to(dev), nn)
                terms.append((f"pose {i}", 10.0 * (tr + ro)))
        out = []
        for name, term in terms:
            gs = torch.autograd.grad(term, [p for _, p in named], retain_graph=True,
                                     allow_unused=True)
            out.append((name, term.item(), {k: (g.cpu() if g is not None else torch.zeros(
                p.shape)) for (k, p), g in zip(named, gs)}))
        total = sum(t for _, t in terms)
        gs = torch.autograd.grad(total, [p for _, p in named], allow_unused=True)
        grads = {k: (g.cpu() if g is not None else torch.zeros(p.shape))
                 for (k, p), g in zip(named, gs)}
    finally:
        blocks._GradientClip.backward = staticmethod(inner)
        solver._center_residuals, solver.apply_depth_retr = center, retr
    return total.item(), out, grads, nans, picks, gates


def dist(torch, a, b):
    """(whole gradient's relative distance, worst leaf's, that leaf)."""
    flat = lambda g: torch.cat([g[k].reshape(-1) for k in sorted(g)])
    fa, fb = flat(a), flat(b)
    whole = float((fa - fb).norm() / max(float(fb.norm()), 1e-30))
    floor = 1e-5 * float(fb.norm())
    worst = max(((float((a[k] - b[k]).norm() / b[k].norm()), k) for k in b
                 if float(b[k].norm()) >= floor and float(b[k].norm()) > 0), default=(0.0, "-"))
    return whole, worst[0], worst[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path[:0] = [os.path.dirname(HERE)]
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("train_grad_parity: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, clip, draws, nets = setup(torch)
    cpu = torch.device("cpu")
    ref = run(torch, cfg, clip, draws, nets, cpu)
    runs = {"device": run(torch, cfg, clip, draws, nets, dev),
            "device again": run(torch, cfg, clip, draws, nets, dev)}
    torch.backends.cudnn.deterministic = True
    runs["device, cuDNN deterministic"] = run(torch, cfg, clip, draws, nets, dev)
    torch.backends.cudnn.deterministic = False
    scaled = {s: run(torch, cfg, clip, draws, nets, cpu, 1 + s) for s in (1e-6, -1e-6)}
    runs["CPU, weights x (1 + 1e-6)"] = scaled[1e-6]

    print(f"CPU: loss {ref[0]:.7g}; the gradient clip's NaN entries per call {ref[3]}")
    for name, (loss, terms, grads, nans, picks, gates) in runs.items():
        whole, worst, leaf = dist(torch, grads, ref[2])
        print(f"{name}: loss {loss:.7g} ({abs(loss - ref[0]) / abs(ref[0]):.3g} from the CPU's);"
              f" whole gradient {whole:.4g} from the CPU's, worst leaf {worst:.4g} ({leaf});"
              f" the clip's NaN entries per call {nans}")
        for s, other in scaled.items():
            whole, worst, leaf = dist(torch, grads, other[2])
            print(f"    from the CPU's with weights x (1 {s:+g}): whole gradient {whole:.4g}, "
                  f"worst leaf {worst:.4g} ({leaf})")
        for i, ((am, vm), (ar, vr)) in enumerate(zip(picks, ref[4])):
            flips = torch.nonzero((am != ar) & vr).reshape(-1).tolist()
            print(f"    step {i}: edges whose least-error pixel differs from the CPU's (of "
                  f"{int(vr.sum())} supervised): {flips}; supervision mask differs at "
                  f"{torch.nonzero(vm != vr).reshape(-1).tolist()}")
        for i, ((what, m), (_, r)) in enumerate(zip(gates, ref[5])):
            if not torch.equal(m, r):
                print(f"    BA iteration {i} (step {i // 2}): {what} differs from the CPU's at "
                      f"{torch.nonzero(m != r).reshape(-1).tolist()} (of {m.numel()}; set there "
                      f"on the CPU: {r[m != r].tolist()})")
        for (tname, tl, tg), (_, rl, rg) in zip(terms, ref[1]):
            w, wl, lf = dist(torch, tg, rg)
            print(f"    {tname}: loss {tl:.7g} / CPU {rl:.7g}; gradient norm "
                  f"{float(sum(v.norm() ** 2 for v in rg.values()) ** 0.5):.4g}, "
                  f"distance {w:.4g}, worst leaf {wl:.4g} ({lf})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
