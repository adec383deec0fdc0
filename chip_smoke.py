#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dpvo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; the first that fails ends the run with a nonzero exit:

1. Build the CUDA kernels from dpvo_tpu_torch/csrc and print the card's
   name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes of the default configuration's steady state (correlation, all
   variants: 37344 live edges in a 40960-row bucket, 5% of them spread 3-6
   px so that corr.cu and kernel A take both their branches, whose counts
   are printed; kernels B and C+D on Gaussian features within the raw dots'
   bf16 ulp and on integer features, also at the ends of their window
   offsets, torch.equal; segment sum: BA's f32
   [49152, 98] into 2560 rows, SoftAgg's two bf16 [40960, 768] sums and
   (row segsum_gba) the seven f32 reductions of a global-BA iteration at
   phase 6's size (pose blocks [4E, 36] into nfree^2 segments, kpairs
   [KP, 36], Fe [R, 6], ...), bit for bit against the plain version on the
   CPU and a second launch bit for bit the first, each with its longest
   run beside ba/segsum.CHUNK and its device time; SPD solve: n = 96, forward and backward; and classic loop closure's
   call sites: segsum_pgo (the PGO's H [4R, 49] and g [2R, 7] at 60 poses),
   segsum_triplet (the triplet BA's [1024, 26] into 512 depths), bit for bit,
   and spd_triplet (n = 24: the identity system bit for bit, a random one
   within 1e-4); and the training path's: corr_bwd, the correlation's
   backward kernels (patch gradients, then the maps), at the last unroll
   step's 18000 edges (bf16 and f32 features: the maps torch.equal to the
   plain version on the CPU, d gmap within an ulp of it, a second launch
   bit for bit the first), segsum_train (BA's
   [18000, 92] into 1200 depths, forward bit for bit, backward the gather)
   and spd_train (n = 90, forward and backward)). Print the error and the
   median time of the kernel, the plain
   version and, where one PyTorch call computes the same function, that
   call (``library_ms``): each an event pair around one call, host launch
   included (``ms``), and for the kernels also the device time of their
   launches alone (``device_ms``, profiler; it raises unless the profiler
   kept an event for every kernel launched).
3. Drive the main path through the tracker's entry points: DPVO with
   config/default.yaml (CORR_IMPL auto) and weights/vonet_synth.npz on a
   synthetic 480x640 plane scene for 40 frames, then terminate(). The
   kernels' launch counters are zeroed just before and read just after;
   its kernels must have run, the tracker must have initialized, the poses
   must be finite. A frames/s smoke reading over 20 frames after warm-up,
   the per-frame time and the ATE against the scene's ground truth are
   printed, not gated.
4. The same path for 30 frames once per CORR_IMPL (xla, pallas, pallas_sw,
   pallas_dma, pallas_fused), counters zeroed before each run: each run's
   correlation kernels must have run, and its ATE stay within
   IMPL_ATE_FACTOR of the exact (xla) run's; pallas's, pallas_sw's and
   pallas_dma's last 5 frames run under the profiler, and the pallas and
   pallas_sw runs count the live items that took each of kernel A's and
   B's branches. The xla run is made twice and the two trajectories must
   be bit for bit equal; the second counts how many live edges took each
   of corr.cu's branches. Then the main path with PIPELINE_DEPTH 3 (each
   keyframe decision applied three frames late): it must initialize, keep
   three decisions pending, cull and give finite poses.
5. Small-path parity: the tiny configuration of the tests
   (tests/fixtures/tiny_synth.npz, 48x64, 24 frames, f32) on the card and
   on the CPU with the same injected draws: free-running (init state,
   keyframes, trajectory; two card runs bit for bit equal), then frame by
   frame from the same state (every buffer of the state after each
   frame). Then the oracle loop-closure tracker of the CPU tests
   (tests/test_torch_loop_closure.py: scripts/lc_ab.py's configuration,
   128x160, 48 frames) on the card and on the CPU: the same global-BA
   frames and loop edges, the poses within LC_SMALL_POSE_ATOL. Then the
   sparse global BA of tests/test_ba.py's problem on the card against the
   CPU, printed with each side's dense solve and with both solves on the
   CPU (two card runs must give the same bits).
6. Loop closure at full width: DPVO with config/slam.yaml (LOOP_CLOSURE)
   and weights/vonet_synth.npz, 480x640, an out-and-back pan of LC_FRAMES
   frames, then terminate(), twice: loop edges appended, global-BA rounds
   run and launch segsum, finite poses, the two runs bit for bit equal.
   Each round's edges, free poses, entries, kpairs and times, the peak
   device memory and the ATE beside a run with LOOP_CLOSURE false are
   printed, not gated; the largest round's solve is timed alone.
7. Classic loop closure at full width on phase 6's stream: DPVO with
   config/default.yaml plus CLASSIC_LOOP_CLOSURE (LOOP_RETR_THRESH 0.8) and
   weights/vonet_synth.npz,
   its keypoints from SceneKeypoints (seeded points on the scene's plane with
   seeded descriptors: no OpenCV on the card's machine), then terminate():
   two inline runs (a candidate, a correction applied, segsum launched in the
   triplet BAs and the PGO and the SPD kernel in the triplet BAs, finite
   poses, the two bit for bit equal) and one with the worker thread and the
   PGO executor (a correction applied). The retrieval frames, candidates,
   corrections, each triplet BA's and PGO's time and size, peak memory and
   the ATE beside phase 6's run without loop closure are printed, not gated.
8. Training at full width: python -m dpvo_tpu_torch.apps.train's main()
   (Config(), bf16, --dataset synthetic, 480x640, 15 frames, 18 unroll
   steps, weights/vonet_synth.npz) for 3 steps, counters zeroed before:
   finite losses and gradient norms above 0, the parameters moved, the
   correlation (forward and backward), segment-sum and SPD kernels
   launched, the metrics JSONL and the npz snapshot written and the
   snapshot loading into load_networks. Then one structure-only and one
   full step through make_train_step at that shape, timed by phase
   (forward, backward, optimizer) with their peak memory, one more under
   the profiler (top 15), two from one state and one draw (whether their
   gradients and parameters repeat bit for bit printed, not gated), and
   20 steps on one fixed small clip
   (tests/test_train.py's configuration), whose loss must fall below 0.7x
   its start.
9. Export and the user entry points at full width (config/default.yaml,
   weights/vonet_synth.npz, 480x640, phase 3's scene; files in a temporary
   directory): export_network.main writes torch.export programs, which
   load_exported reloads (update.pt2 must hold the segment-sum op); an
   eager DPVO and an exported one track the same 40 frames with the same
   draws, each twice, alternating: the segment-sum kernel launched inside
   the exported update, every run's poses within EXPORT_POSE_ATOL of the
   first eager run's, the exported ATE within IMPL_ATE_FACTOR of the eager
   ATE, the median frame times printed (the segsum_bf16 row of the
   kernels line gets the exported update's launches as export_launches).
   Then
   demo.run with the trajectory, PLY and COLMAP writers (a TUM row per
   frame, the PLY's vertices the finite points of point_cloud(), colours
   not all zero, the COLMAP files parse to the tracker's state; frames/s
   and peak memory printed), eval_synthetic.main on 2 scenes (each
   initialized, each ATE finite), and the protocol's evaluate_sequences
   with 2 trials (AVG and AUC equal to their recomputation from the
   trials' ATEs).
10. GRADIENT_BIAS, the parallel layer and Timer (phase_gradient_bias_parallel):
   phase 3's path with CENTROID_SEL_STRAT GRADIENT_BIAS (initialized, culled,
   finite poses, corr / segsum / SPD launched, the card's centroid selection
   torch.equal to the CPU's from the same bf16 image and candidates on the
   first 5 frames; ATE beside phase 3's and a ms/frame reading printed, the
   frame loop timed by Timer, a frame's patchify under each strategy timed
   in turn); that configuration exported and tracked on 10
   frames, bit for bit the eager tracker; a world-size-1 NCCL group with a
   (1, 1) mesh: phase 6's stream through DPVO(mesh=), its global-BA rounds
   through dist_gba (segsum launched), poses bit for bit phase 6's, the last
   round through gba and dist_gba timed in turn; dist_ba_delta
   at the main path's last BA, bit for bit ba_delta with the SPD kernel
   launched; one step of apps/train.py --mesh 1,1 at phase 8's shape (finite
   loss; its parameters' difference from a step without a mesh printed
   beside the 1.53e-4 that a backward with f32 atomics gave). The
   group is destroyed. Then training's edge split (phase_edge_split):
   phase 8's full-width step from one state and one draw on a (1, 2) mesh,
   two gloo ranks on the one card, each a process of its own
   (``chip_smoke.py edge-rank``), twice in each rank: each rank launches
   the correlation (forward and backward), segment-sum and SPD kernels, its
   correlation takes half of the last unroll step's edges, its loss,
   metrics and parameters are the single-process card step's within the
   CPU test's tolerances, and its two runs and the two ranks give the same
   bits; each rank's step seconds, peak memory and busy share printed.

Segment-sum runs (segsum_runs): the second xla run of phase 4, the tiny
tracker's card runs of phase 5, the second loop-closure run of phase 6,
the second inline run of phase 7, and phase 8's two steps from one state
and fixed-clip overfit print each call site's longest run and how far into
a run its last nonzero row lies; a site other than the global BA's with a
nonzero row past ba/segsum.CHUNK fails the run (there the chunked order
would leave the sequential sum's bits).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. It needs a CUDA device and
the rest of the repository; without either it exits nonzero and prints
no result.
"""

import contextlib
import copy
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# published dense peaks of one H100 SXM (NVIDIA data sheet), for the bounds
PEAK_BYTES = 3.35e12         # HBM3 bytes/s
PEAK_F32 = 67e12             # f32 FLOP/s outside the tensor cores
PEAK_BF16 = 989e12           # bf16 tensor-core FLOP/s


def cuda_ms(fn, reps, warmup=2):
    """Median device time of fn() over reps runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def alternating_ms(fns, reps, warmup=2):
    """The median event-pair time of each of fns, run in turn reps times,
    so that a drift of the card's or the host's speed falls on each alike."""
    import torch

    for _ in range(warmup):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
    return [float(np.median(ts)) for ts in times]


# Profiles device_ms takes before it gives up. The drops grow with the
# events a profile holds: on an H100 a 63k-event profile of three PGO calls
# (phase 7) was incomplete in 7 of 17 attempts, three times in a row once,
# and a 20-event one came back empty
PROFILE_ATTEMPTS = 8
# A spin kernel (torch.cuda._sleep, ~1 ms, not counted) that starts each
# profile: late in phase 2 on an H100 a profile of 20 segment sums kept 19
# of them in all 8 attempts, in two runs; with the spin kernel first it kept
# all 20 (spin kernels at the end of the profile changed nothing)
PROFILE_HEAD_CYCLES = 2_000_000
# A host pause at each end of a profile, so that the kernels lie well inside
# its window even where the profiler's device clock and the host's part by
# more than the spin kernel covers: with the spin kernel alone, a profile of
# 20 global-BA segment sums in phase 2 kept all 20 in none of 8 attempts on
# an H100 (and 5 of 20 in another run), where the same profile early in a
# fresh process keeps them all
PROFILE_MARGIN_S = 0.02


def queued_ms(fn, reps, attempts=4):
    """Device time per call of fn() (which must not wait for the card): an
    event pair around reps calls that the host queues behind a spin kernel,
    so the card runs them back to back. It counts the short gaps between
    kernels beside their run time. The spin is sized at twice the host's
    time for the calls and lengthened until the first event was still
    pending when the host had queued the last call."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(host_s, 1e-3) * 4e9)  # ~2x the host's time at the card's ~2 GHz
    for _ in range(attempts):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued = not a.query()
        b.synchronize()
        if queued:
            return a.elapsed_time(b) / reps
        cycles *= 4
    raise RuntimeError(f"queued_ms: the card caught up with the host in all {attempts} attempts")


def device_ms(fn, reps, warmup=2, mixed=False):
    """Device time per call of the kernels fn() launches (profiler, summed
    over them). Beside cuda_ms's event pair, which includes the host's
    launch: for a call shorter than its launch, that times the host.

    A profile counts only if the profiler kept an event for every kernel
    the reps launched: where fn launches the port's kernels, one each per
    wrapper call and nothing else, reps x the launches kernels.LAUNCHES
    counts in one call; where it launches none (a library call or a plain
    version), reps x the events of one call profiled alone; where it
    launches some beside library kernels (``mixed``: a global-BA solve,
    whose library calls launch a varying number of kernels), at least that
    many. The profiler
    on the card sometimes drops an event (an H100 run kept 39 of 40); such
    a profile is reported, with where its kept kernels lie in it, and taken
    again. After PROFILE_ATTEMPTS incomplete profiles the time comes from
    queued_ms, and is printed as such; a ``mixed`` fn waits for the card
    between its kernels, which queued_ms cannot time, so then this raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dpvo_tpu_torch import kernels

    def profiled(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            time.sleep(PROFILE_MARGIN_S)
            torch.cuda._sleep(PROFILE_HEAD_CYCLES)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
            host_ms = (time.perf_counter() - t0) * 1e3
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]
        return (sum(e.count for e in evs), sum(e.self_device_time_total for e in evs),
                {e.key[:48]: e.count for e in evs}, prof, host_ms)

    def kept_span(prof, host_ms):
        kept = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not kept:
            return f"none kept in a {host_ms:.1f} ms profile"
        first = min(kept, key=lambda e: e.time_range.start)
        last = max(e.time_range.end for e in kept)
        return (f"kept kernels from {first.time_range.start / 1e3:.3f} ms (the first "
                f"{'the spin kernel' if 'spin_kernel' in first.key else first.key[:32]}) to "
                f"{last / 1e3:.3f} ms after the profile's start, in a {host_ms:.1f} ms profile "
                f"with {PROFILE_MARGIN_S * 1e3:.0f} ms pauses at each end")

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    before = sum(kernels.LAUNCHES.values())
    fn()
    torch.cuda.synchronize()
    launched = sum(kernels.LAUNCHES.values()) - before
    for _ in range(PROFILE_ATTEMPTS):
        want = reps * (profiled(1)[0] if mixed or not launched else launched)
        count, us, names, prof, host_ms = profiled(reps)
        if (count >= want if mixed else count == want) and us > 0:
            return us / 1e3 / reps
        print(f"device_ms: the profiler kept {count} kernel events of the {want} launched "
              f"({us / 1e3:.4f} ms of device time; by kernel {names}; "
              f"{kept_span(prof, host_ms)}); this profile is not used")
        time.sleep(0.5)
    if mixed:
        raise RuntimeError(f"the profiler kept every kernel event in none of {PROFILE_ATTEMPTS} "
                           "profiles")
    ms = queued_ms(fn, reps)
    print(f"device_ms: no complete profile in {PROFILE_ATTEMPTS}; device time from "
          f"{reps} calls queued behind a spin kernel (event pair): {ms:.5f} ms a call")
    return ms


def bound(nbytes, flops, peak_flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ate_rmse(est, gt):
    """ATE-RMSE after a Umeyama Sim(3) alignment of positions [N,3]."""
    from dpvo_tpu_torch.eval.ate import ate_rmse as port_ate_rmse

    return port_ate_rmse(est, gt)


def phase_kernels(torch, kernels):
    """Each kernel against its plain version at the main path's shapes."""
    from dpvo_tpu_torch.ba.spd_solve import spd_solve, spd_solve_plain
    from dpvo_tpu_torch.ops.corr import corr_features_plain
    from dpvo_tpu_torch.ops.corr_cuda import corr_features, union_tile_levels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # ---- correlation: default.yaml steady state ----
    E_cap, E, M, pmem, mem, C = 40960, 37344, 96, 36, 36, 128
    H1, W1, H2, W2 = 120, 160, 30, 40
    gmap = torch.randn((pmem * M, C, 3, 3), generator=g, device=dev).to(torch.bfloat16)
    fmap1 = torch.randn((mem, H1, W1, C), generator=g, device=dev).to(torch.bfloat16)
    fmap2 = torch.randn((mem, H2, W2, C), generator=g, device=dev).to(torch.bfloat16)
    ctr = torch.rand((E_cap, 1, 1, 2), generator=g, device=dev) * torch.tensor(
        [W1 + 8.0, H1 + 8.0], device=dev) - 4.0
    off = torch.stack(torch.meshgrid(torch.arange(-1.0, 2.0, device=dev),
                                     torch.arange(-1.0, 2.0, device=dev), indexing="ij"), -1)
    # pixels 1 px apart, and 3-6 px apart on 5% of the edges (depth or
    # rotation spreading a patch), which exceeds corr.cu's union cap
    spread = torch.where(torch.rand((E_cap, 1, 1, 1), generator=g, device=dev) < 0.05,
                         3 + 3 * torch.rand((E_cap, 1, 1, 1), generator=g, device=dev),
                         torch.ones((E_cap, 1, 1, 1), device=dev))
    noise = 0.3 * torch.randn((E_cap, 3, 3, 2), generator=g, device=dev)
    coords = (ctr + spread * off.flip(-1)[None] + noise).contiguous()
    ii1 = torch.randint(0, pmem * M, (E_cap,), generator=g, device=dev, dtype=torch.int32)
    jj1 = torch.randint(5, 5 + 22, (E_cap,), generator=g, device=dev,
                        dtype=torch.int32)  # 22 live frames
    valid = torch.arange(E_cap, device=dev) < E
    args = (gmap, fmap1, fmap2, coords, ii1, jj1, valid)
    tiles = union_tile_levels(coords[:E], (H1, W1), (H2, W2))
    print(f"corr: live (edge, level) items by branch, kernel's rule: union tile "
          f"{int(tiles[:, 0].sum())} + {int(tiles[:, 1].sum())}, per-pixel "
          f"{int((~tiles[:, 0]).sum())} + {int((~tiles[:, 1]).sum())} (level 1 + level 2)")
    if tiles.all() or not tiles.any():
        raise AssertionError("the correlation inputs do not take both of corr.cu's branches")
    k = corr_features(*args).float()
    p = corr_features_plain(*args).float()
    # one bf16 ulp of the value, plus the f32 accumulation error of a
    # 128-term dot of unit-variance features (n * 2^-24 * sum|a b| ~ 1e-3),
    # which matters where a value cancels to near zero
    err = (k - p).abs()
    tol = 2.0 ** -7 * torch.maximum(k.abs(), p.abs()) + 2e-3
    print(f"corr: max_abs_err {err.max().item():.6g}; beyond one bf16 ulp alone: "
          f"{int((err > 2.0 ** -7 * torch.maximum(k.abs(), p.abs())).sum())} of {err.numel()}")
    if (err > tol).any():
        raise AssertionError("corr kernel disagrees with its plain version")
    nframes = int(torch.unique(jj1[:E]).numel())
    nrows = int(torch.unique(ii1[:E]).numel())
    # the frames and patch rows the live edges touch, their coords, the
    # int32 ii1/jj1 and bool valid of the bucket, the bf16 output
    nbytes = (nframes * (H1 * W1 + H2 * W2) * C * 2 + nrows * C * 9 * 2 + E * 9 * 2 * 4
              + E_cap * (4 + 4 + 1) + E_cap * 9 * 128 * 2)
    flops = E * 2 * 9 * 64 * C * 2
    # the same edges with every patch's pixels 1 px apart, the main path's
    # geometry (phase 4 counts its branches)
    near = (gmap, fmap1, fmap2, (ctr + off.flip(-1)[None] + noise).contiguous(), ii1, jj1, valid)
    print(f"corr: ms per call with every patch 1 px apart "
          f"{cuda_ms(lambda: corr_features(*near), 20):.4f} (device "
          f"{device_ms(lambda: corr_features(*near), 20):.4f})")
    out["corr"] = dict(max_abs_err=err.max().item(), ms=cuda_ms(lambda: corr_features(*args), 20),
                       device_ms=device_ms(lambda: corr_features(*args), 20),
                       plain_ms=cuda_ms(lambda: corr_features_plain(*args), 3, warmup=1),
                       library_ms=None, bound=bound(nbytes, flops, PEAK_BF16))
    out.update(corr_variant_kernels(torch, args, nframes, nrows))

    out.update(segsum_kernels(torch, g))
    out.update(train_kernels(torch, g))
    out.update(segsum_gba_kernels(torch, g))
    from dpvo_tpu_torch.ba import segsum

    runs = out["segsum_gba"]["longest_runs"]
    print(f"segsum_gba: CHUNK {segsum.CHUNK} rows a piece; the reductions with longer runs "
          f"(taken in pieces): {[name for name, n in runs.items() if n > segsum.CHUNK]}")
    out.update(classic_lc_kernels(torch, g))

    # ---- SPD solve: the n = 96 damped pose system, forward and backward ----
    n = 96
    A = torch.randn((n, n), generator=g, device=dev)
    S = (A @ A.T + n * torch.eye(n, device=dev)).contiguous()
    y = torch.randn(n, generator=g, device=dev)
    w = torch.randn(n, generator=g, device=dev)
    Sg, yg = S.clone().requires_grad_(), y.clone().requires_grad_()
    x = spd_solve(Sg, yg)
    (w * x * x).sum().backward()
    # the plain version, forward and the same adjoint: y_bar = S^-1 g, S_bar = -y_bar x^T
    xp = spd_solve_plain(S, y)
    yb = spd_solve_plain(S, 2 * w * xp)
    grads = [(x.detach(), Sg.grad, yg.grad), (xp, -torch.outer(yb, xp), yb)]
    errs = [(a - b).abs().max().item() / b.abs().max().item() for a, b in zip(*grads)]
    print(f"spd_solve: relative max error x {errs[0]:.3g}, dS {errs[1]:.3g}, dy {errs[2]:.3g}")
    if max(errs) > 1e-4:  # f32 Cholesky, condition number ~5
        raise AssertionError("SPD kernel (forward or backward) disagrees with its plain version")
    times = dict(ms=cuda_ms(lambda: spd_solve(S, y), 50),
                 library_ms=cuda_ms(lambda: torch.linalg.solve(S, y), 50),
                 device_ms=device_ms(lambda: spd_solve(S, y), 50),
                 library_device_ms=device_ms(lambda: torch.linalg.solve(S, y), 50))
    print("spd_solve: ms {ms:.5f} (torch.linalg.solve {library_ms:.5f}); device time "
          "{device_ms:.5f} ({library_device_ms:.5f})".format(**times))
    out["spd_solve"] = dict(
        max_abs_err=(grads[0][0] - grads[1][0]).abs().max().item(),
        ms=times["ms"], library_ms=times["library_ms"], device_ms=times["device_ms"],
        plain_ms=cuda_ms(lambda: spd_solve_plain(S, y), 10),
        # S and y read, x written; the least work of an SPD solve is a
        # Cholesky factorization and two triangular solves, n^3/3 + 2n^2,
        # what the kernel does. A dependency chain of 3n steps, which
        # neither bound sees, sets its time
        bound=bound((n * n + 2 * n) * 4, n ** 3 / 3 + 2 * n * n, PEAK_F32))
    return out


def segsum_kernels(torch, g):
    """The segment sum at its two shapes on the path, each against its plain
    version run on the CPU (index_add_ there adds row after row, the
    kernel's order; on the card it adds with atomics): the same bits.
    segsum: BA's f32 [49152, 98] into 2560 depth rows. segsum_bf16: one
    SoftAgg layer's two sums of a bf16 [40960, 768] payload, by patch into
    2560 rows (~16 edges each) and by frame pair into 2048 (96 edges each,
    ~430 ids, the rest empty; 1% of the rows past the last id, as the small
    branch maps invalid rows, dropped)."""
    from dpvo_tpu_torch.ba.segsum import segment_sum, segment_sum_plain

    dev = torch.device("cuda")

    def shuffled(kd):
        kd = kd[torch.randperm(kd.shape[0], generator=g, device=dev)].to(torch.int32)
        return kd, torch.argsort(kd, stable=True).to(torch.int32)

    def groups(E, Md):  # every id once, the rest at random
        return torch.cat([torch.arange(Md, device=dev),
                          torch.randint(0, Md, (E - Md,), generator=g, device=dev)])

    Eb, Kb, Mb = 49152, 98, 2560
    Es, Ks = 40960, 768
    ij = torch.arange(Es, device=dev) // 96
    ij[torch.rand(Es, generator=g, device=dev) < 0.01] = 2048
    x = torch.randn((Es, Ks), generator=g, device=dev).to(torch.bfloat16)
    shapes = {
        "segsum": [(torch.randn((Eb, Kb), generator=g, device=dev), *shuffled(groups(Eb, Mb)),
                    Mb)],
        "segsum_bf16": [(x, *shuffled(groups(Es, 2560)), 2560), (x, *shuffled(ij), 2048)],
    }
    out = {}
    for name, calls in shapes.items():
        got = [segment_sum(*c).cpu() for c in calls]
        want = [segment_sum_plain(p.cpu(), kd.cpu(), Md) for p, kd, _, Md in calls]
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"{name}: bit for bit equal to the plain version: {same} (max_abs_err {err:.3g})")
        if not same:
            raise AssertionError(f"{name} kernel disagrees with its plain version")
        # index_add_ with its zeroing (and, for bf16, the f32 cast it needs)
        lib_args = [(p, torch.where((kd < 0) | (kd >= Md), Md, kd).long(), Md)
                    for p, kd, _, Md in calls]
        run = lambda: [segment_sum(*c) for c in calls]
        lib = lambda: [torch.zeros((Md + 1, p.shape[1]), device=dev).index_add_(0, kd, p.float())
                       for p, kd, Md in lib_args]
        t = dict(ms=cuda_ms(run, 50), library_ms=cuda_ms(lib, 50), device_ms=device_ms(run, 50),
                 library_device_ms=device_ms(lib, 50))
        print(f"{name}: ms {{ms:.5f}} (index_add_ {{library_ms:.5f}}); device time "
              "{device_ms:.5f} ({library_device_ms:.5f})".format(**t))
        if len(calls) > 1:
            print(f"{name}: device time per call " + ", ".join(
                f"{device_ms(lambda: segment_sum(*c), 50):.5f} (into {c[3]} rows)" for c in calls))
        # the payload rows of ids in [0, Md) read once, the int32 kd and
        # order once, the f32 output written once; one add per value read
        kept = sum(int(((kd >= 0) & (kd < Md)).sum()) for _, kd, _, Md in calls)
        nbytes = sum(p.shape[0] * 8 + Md * p.shape[1] * 4 for p, _, _, Md in calls) \
            + kept * calls[0][0].shape[1] * calls[0][0].element_size()
        out[name] = dict(max_abs_err=err, ms=t["ms"], library_ms=t["library_ms"],
                         device_ms=t["device_ms"],
                         plain_ms=cuda_ms(lambda: [segment_sum_plain(p, kd, Md)
                                                   for p, kd, _, Md in calls], 10),
                         bound=bound(nbytes, kept * calls[0][0].shape[1], PEAK_F32))
    return out


# the training path's shapes (phase 8): Config()'s 80 patches a frame, a
# 15-frame clip, its last unroll step's edges (every patch to every frame)
TRAIN_F, TRAIN_M, TRAIN_H, TRAIN_W, TRAIN_C = 15, 80, 120, 160, 128
TRAIN_E = TRAIN_F * TRAIN_M * TRAIN_F  # 18000


def train_corr_case(torch, g, dtype):
    """corr_bwd's inputs at the last unroll step: gmap [F*M, C, 3, 3], the
    two maps of F frames, patch rows kk = every patch once per target
    frame, coords of patches 1 px apart around centres over the map and 8
    px past its borders (3-6 px apart on 5% of the edges), 3% of the edges
    invalid, and the incoming gradient [E, 9, 128]; the orders as the
    unroll passes them: kk's sorted on the device, jj's stable argsort
    built on the host (vonet.step_tensors)."""
    dev = torch.device("cuda")
    E, F, M, H, W, C = TRAIN_E, TRAIN_F, TRAIN_M, TRAIN_H, TRAIN_W, TRAIN_C
    gmap = torch.randn((F * M, C, 3, 3), generator=g, device=dev).to(dtype)
    fmap1 = torch.randn((F, H, W, C), generator=g, device=dev).to(dtype)
    fmap2 = torch.randn((F, H // 4, W // 4, C), generator=g, device=dev).to(dtype)
    ctr = torch.rand((E, 1, 1, 2), generator=g, device=dev) * torch.tensor(
        [W + 16.0, H + 16.0], device=dev) - 8.0
    off = torch.stack(torch.meshgrid(torch.arange(-1.0, 2.0, device=dev),
                                     torch.arange(-1.0, 2.0, device=dev), indexing="ij"), -1)
    spread = torch.where(torch.rand((E, 1, 1, 1), generator=g, device=dev) < 0.05,
                         3 + 3 * torch.rand((E, 1, 1, 1), generator=g, device=dev),
                         torch.ones((E, 1, 1, 1), device=dev))
    coords = (ctr + spread * off.flip(-1)[None]
              + 0.3 * torch.randn((E, 3, 3, 2), generator=g, device=dev)).contiguous()
    kk = (torch.arange(E, device=dev) // F).to(torch.int32)
    jj = (torch.arange(E, device=dev) % F).to(torch.int32)
    valid = torch.rand(E, generator=g, device=dev) > 0.03
    gout = torch.randn((E, 9, 128), generator=g, device=dev).to(torch.bfloat16)
    order = torch.argsort(kk, stable=True).to(torch.int32)
    jj_order = torch.from_numpy(np.argsort(jj.cpu().numpy(), kind="stable").astype(np.int32))
    return gout, gmap, fmap1, fmap2, coords, kk, jj, valid, order, jj_order.to(dev)


def train_kernels(torch, g):
    """The training path's kernels at its shapes (phase 8's last unroll
    step): corr_bwd against corr_backward_plain on the CPU (bf16 and f32
    features; the maps bit for bit, and two launches bit for bit), and
    the forward plus backward of BA's segment sum and of the pose solve at
    n = 6 F = 90 (segsum_train_row)."""
    from dpvo_tpu_torch.ba.spd_solve import spd_solve, spd_solve_plain
    from dpvo_tpu_torch.ops.corr import corr_backward_plain
    from dpvo_tpu_torch.ops.corr_cuda import corr_backward

    dev = torch.device("cuda")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = train_corr_case(torch, g, dtype)
        got = corr_backward(*args)
        want = corr_backward_plain(*(a.cpu() for a in args[:8]))
        torch.cuda.synchronize()
        errs = []
        for name, a, b in zip(("gmap", "fmap1", "fmap2"), got, want):
            a, b = a.cpu(), b
            equal = torch.equal(a, b)
            a, b = a.float(), b.float()
            # d gmap: f32 sums in another order (registers against the plain
            # version's einsum), then, for bf16 features, one rounding to
            # bf16: an ulp of the value. The maps: bit for bit (the map
            # kernel sums in the plain version's order, with its roundings)
            ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
            tol = ulp * torch.maximum(a.abs(), b.abs()) + 1e-5 * b.abs().max()
            err = (a - b).abs()
            errs.append(err.max().item())
            print(f"corr_bwd ({str(dtype)[6:]}): d {name} max_abs_err {err.max().item():.4g} "
                  f"(max |value| {b.abs().max().item():.4g}), beyond tolerance "
                  f"{int((err > tol).sum())}, torch.equal to the CPU's plain version {equal}")
            if (err > tol).any() or (name != "gmap" and not equal):
                raise AssertionError(f"corr_bwd disagrees with its plain version ({name}, {dtype})")
        again = corr_backward(*args)
        repeat = [torch.equal(a, b) for a, b in zip(again, got)]
        print(f"corr_bwd ({str(dtype)[6:]}): a second launch bit for bit equal (d gmap, d fmap1, "
              f"d fmap2): {repeat}")
        if not all(repeat):
            raise AssertionError(f"corr_bwd: a second launch differs ({dtype})")
    gout, gmap, fmap1, fmap2, coords, kk, jj, valid, order, _ = args
    E, C = TRAIN_E, TRAIN_C
    # bytes the function must move: g, the features, coords and int32/bool
    # indices read once, the three gradients written once in the features'
    # dtype (bf16); the dots: per edge and level 9 pixels x 64 positions x C,
    # twice (d f1 and d fmap), on bf16 operands: at the bf16 rate, as corr's
    # row. The one-kernel backward's count charged f32 map buffers and the
    # f32 per-edge patch gradients (that kernel's writes), printed beside it
    feats = gmap.numel() + fmap1.numel() + fmap2.numel()
    nbytes = gout.numel() * 2 + feats * 2 + coords.numel() * 4 + E * 9 + feats * 2
    old_bytes = (gout.numel() * 2 + feats * 2 + coords.numel() * 4 + E * 9
                 + (fmap1.numel() + fmap2.numel()) * 4 + E * C * 9 * 4)
    flops = int(valid.sum()) * 2 * 9 * 64 * C * 2 * 2
    print(f"corr_bwd bound: {bound(nbytes, flops, PEAK_BF16)[0]:.4f} ms ({nbytes / 1e6:.1f} MB; "
          f"the one-kernel design's count {bound(old_bytes, flops, PEAK_BF16)[0]:.4f} ms, "
          f"{old_bytes / 1e6:.1f} MB)")
    call = lambda: corr_backward(*args)
    out["corr_bwd"] = dict(max_abs_err=max(errs), ms=cuda_ms(call, 10),
                           device_ms=device_ms(call, 10, mixed=True),
                           plain_ms=cuda_ms(lambda: corr_backward_plain(*args[:8]), 2, warmup=1),
                           library_ms=None, bound=bound(nbytes, flops, PEAK_BF16))

    out.update(segsum_train_row(torch, g, kk))

    # the pose solve at n = 6 F = 90, forward and backward
    n = 6 * TRAIN_F
    A = torch.randn((n, n), generator=g, device=dev)
    S = (A @ A.T + n * torch.eye(n, device=dev)).contiguous()
    yv = torch.randn(n, generator=g, device=dev)
    w = torch.randn(n, generator=g, device=dev)

    def solve_fwd_bwd():
        Sg, yg = S.clone().requires_grad_(), yv.clone().requires_grad_()
        x = spd_solve(Sg, yg)
        return (x,) + torch.autograd.grad(x, (Sg, yg), w)

    x, dS, dy = solve_fwd_bwd()
    xp = spd_solve_plain(S, yv)
    yb = spd_solve_plain(S, w)
    errs = [(a - b).abs().max().item() / b.abs().max().item()
            for a, b in zip((x, dS, dy), (xp, -torch.outer(yb, xp), yb))]
    print(f"spd_train (n = {n}): relative max error x {errs[0]:.3g}, dS {errs[1]:.3g}, "
          f"dy {errs[2]:.3g}")
    if max(errs) > 1e-4:
        raise AssertionError("spd_train: the SPD kernel's forward or backward disagrees")

    def lib_solve():
        Sg, yg = S.clone().requires_grad_(), yv.clone().requires_grad_()
        xl = torch.linalg.solve(Sg, yg)
        return torch.autograd.grad(xl, (Sg, yg), w)

    out["spd_train"] = dict(
        max_abs_err=(x - xp).abs().max().item(), ms=cuda_ms(solve_fwd_bwd, 50),
        device_ms=device_ms(solve_fwd_bwd, 50, mixed=True),
        plain_ms=cuda_ms(lambda: (spd_solve_plain(S, yv), spd_solve_plain(S, w)), 5),
        library_ms=cuda_ms(lib_solve, 50),
        # two solves: S, y and g read, x and y_bar written, dS [n, n] written
        bound=bound((n * n + 2 * n) * 4 * 2 + n * n * 4, 2 * (n ** 3 / 3 + 2 * n * n), PEAK_F32))
    return out


def segsum_train_row(torch, g, kk):
    """BA's depth reduction at the training shape (row segsum_train): an
    [E, 6F + 2] f32 payload into F*M rows by a shuffle of the patch ids kk,
    forward and backward (the gather of its gradient), drawn from g."""
    from dpvo_tpu_torch.ba.segsum import segment_sum, segment_sum_plain

    dev = kk.device
    E = kk.shape[0]
    K, Md = 6 * TRAIN_F + 2, TRAIN_F * TRAIN_M
    pay = torch.randn((E, K), generator=g, device=dev)
    kd = kk[torch.randperm(E, generator=g, device=dev)]
    kd_order = torch.argsort(kd, stable=True).to(torch.int32)
    gy = torch.randn((Md, K), generator=g, device=dev)

    def fwd_bwd():
        p = pay.clone().requires_grad_()
        y = segment_sum(p, kd, kd_order, Md)
        (gp,) = torch.autograd.grad(y, p, gy)
        return y, gp

    y, gp = fwd_bwd()
    same = torch.equal(y.cpu(), segment_sum_plain(pay.cpu(), kd.cpu(), Md)) and \
        torch.equal(gp, gy[kd.long()])
    print(f"segsum_train: forward bit for bit equal to the plain version, backward the gather: "
          f"{same}")
    if not same:
        raise AssertionError("segsum_train: the kernel or its gradient disagrees")
    lib = lambda: (torch.zeros((Md, K), device=dev).index_add_(0, kd.long(), pay),
                   gy[kd.long()])
    return {"segsum_train": dict(
        max_abs_err=0.0, ms=cuda_ms(fwd_bwd, 50), device_ms=device_ms(fwd_bwd, 50, mixed=True),
        plain_ms=cuda_ms(lambda: (segment_sum_plain(pay, kd, Md), gy[kd.long()]), 10),
        library_ms=cuda_ms(lib, 50),
        # payload and ids read, sums written; the gradient read by id, written
        bound=bound(E * K * 4 + E * 8 + Md * K * 4 + E * K * 4 * 2, E * K, PEAK_F32))}


# the largest global-BA round of phase 6 as its scene's topology gives it:
# GBA_FRAMES free keyframes of 96 patches, each patch observed in the frames
# within GBA_REACH of its own (~115k edges, ~2.7M kpairs)
GBA_FRAMES, GBA_REACH = 63, 10


def gba_reductions(torch, g, dev, n=GBA_FRAMES, M=96, reach=GBA_REACH):
    """The global BA's seven reductions (ba/gba_sparse.py:_iteration) on
    build_sparse_indices' ids and orders for n free keyframes of M patches,
    each patch observed in the frames within `reach` of its own, with random
    f32 payloads of each one's width (drawn from generator g) on device dev:
    name -> (payload, ids, order, segments), and the sizes."""
    from dpvo_tpu_torch.ba.gba_sparse import build_sparse_indices

    kk, jj = [], []
    for i in range(n):
        K, J = np.meshgrid(np.arange(i * M, (i + 1) * M),
                           np.arange(max(i - reach, 0), min(i + reach + 1, n)),
                           indexing="ij")
        kk.append(K.ravel())
        jj.append(J.ravel())
    kk, jj = np.concatenate(kk), np.concatenate(jj)
    kd = np.unique(kk, return_inverse=True)[1].reshape(-1)
    idx = build_sparse_indices(kk // M, jj, kd, 0, n, W=n, R_MAX=1 << 23, KP_MAX=1 << 23)
    E, R, F, KP = len(kk), len(idx["re"]), len(idx["fk"]), len(idx["p1"])
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    x = lambda rows, k: torch.randn((rows, k), generator=g, device=g.device).to(dev)
    return {  # in the order of _iteration
        "C, u by depth [E, 2]": (x(E, 2), t(kd), t(idx["kd_order"]), n * M),
        "pose blocks [4E, 36]": (x(4 * E, 36), t(idx["blk_seg"]), t(idx["blk_order"]), n * n),
        "v by pose [2E, 6]": (x(2 * E, 6), t(idx["v_seg"]), t(idx["v_order"]), n),
        "Fe by entry [R, 6]": (x(R, 6), t(idx["r2f"]), t(idx["r2f_order"]), F),
        # one call for all kpairs, in sorted id order as _iteration's chunks take them
        "kpairs [KP, 36]": (x(KP, 36), t(idx["pair_seg"][idx["pair_order"]]),
                            torch.arange(KP, dtype=torch.int32, device=dev), n * n),
        "E Q u by pose [F, 6]": (x(F, 6), t(idx["fa"]), t(idx["fa_order"]), n),
        "E^T dX by depth [F, 2]": (x(F, 2), t(idx["fk"]), t(idx["fk_order"]), n * M),
    }, dict(E=E, R=R, F=F, KP=KP, nfree=n)


def longest_run(kd, Md):
    """Rows of the longest run of ids in [0, Md) in kd (a CPU tensor)."""
    kd = kd.long()
    kept = kd[(kd >= 0) & (kd < Md)]
    return int(kept.bincount().max()) if kept.numel() else 0


def segsum_gba_kernels(torch, g):
    """The segment sum at the global BA's shapes (its own row, segsum_gba):
    each of the seven reductions of a Gauss-Newton iteration bit for bit
    against the plain version on the CPU, with its longest run and device
    time; the seven together against their bound and index_add_."""
    from dpvo_tpu_torch.ba.segsum import segment_sum, segment_sum_plain

    calls, sizes = gba_reductions(torch, g, torch.device("cuda"))
    print("segsum_gba: the global BA's reductions at {nfree} free poses, E {E} edges, R {R} "
          "rows, F {F} entries, KP {KP} kpairs".format(**sizes))
    err, reductions, runs = 0.0, {}, {}
    for name, (p, kd, order, Md) in calls.items():
        got = segment_sum(p, kd, order, Md).cpu()
        want = segment_sum_plain(p.cpu(), kd.cpu(), Md)
        err = max(err, (got - want).abs().max().item())
        dms = device_ms(lambda: segment_sum(p, kd, order, Md), 20)
        reductions[name], runs[name] = dms, longest_run(kd.cpu(), Md)
        print(f"segsum_gba: {name} into {Md} segments, longest run {runs[name]} rows: bit for "
              f"bit equal to the plain version: {torch.equal(got, want)}; device time "
              f"{dms:.5f} ms")
        if not torch.equal(got, want):
            raise AssertionError(f"segsum kernel disagrees with its plain version at {name}")
        again = segment_sum(p, kd, order, Md).cpu()
        if not torch.equal(again, got):
            raise AssertionError(f"segsum_gba: a second launch differs at {name}")
    run = lambda: [segment_sum(*c) for c in calls.values()]
    lib_args = [(p, torch.where((kd < 0) | (kd >= Md), Md, kd).long(), Md)
                for p, kd, _, Md in calls.values()]
    lib = lambda: [torch.zeros((Md + 1, p.shape[1]), device=p.device).index_add_(0, kd, p)
                   for p, kd, Md in lib_args]
    t = dict(ms=cuda_ms(run, 10), library_ms=cuda_ms(lib, 10), device_ms=device_ms(run, 10),
             library_device_ms=device_ms(lib, 10))
    # the rows of ids in [0, Md) read once with their int32 id and order,
    # the f32 outputs written once; one add per value read
    kept = [int(((kd >= 0) & (kd < Md)).sum()) for _, kd, _, Md in calls.values()]
    nbytes = sum(p.shape[0] * 8 + k * p.shape[1] * 4 + Md * p.shape[1] * 4
                 for (p, _, _, Md), k in zip(calls.values(), kept))
    flops = sum(k * p.shape[1] for (p, _, _, _), k in zip(calls.values(), kept))
    b = bound(nbytes, flops, PEAK_F32)
    print("segsum_gba: the seven calls: ms {ms:.5f} (index_add_ {library_ms:.5f}); device time "
          "{device_ms:.5f} ({library_device_ms:.5f}); each a second launch bit for bit the "
          "first".format(**t) + f"; bound {b[0]:.5f} ms ({b[1]}), "
          f"{100 * b[0] / t['device_ms']:.1f}% of it")
    # device_ms's measure where no profile is whole, run here every time
    q = queued_ms(run, 10)
    print(f"segsum_gba: the seven calls queued behind a spin kernel (queued_ms): {q:.5f} ms, "
          f"{q / t['device_ms']:.3f}x the profiler's device time")
    return {"segsum_gba": dict(
        max_abs_err=err, ms=t["ms"], library_ms=t["library_ms"], device_ms=t["device_ms"],
        plain_ms=cuda_ms(lambda: [segment_sum_plain(p, kd, Md) for p, kd, _, Md in calls.values()],
                         2, warmup=1),
        bound=b, reductions=reductions, longest_runs=runs)}


# phase 7's keyframe count (phase 6's stream kept 60): the PGO's size there
PGO_N = 60


def pgo_reductions(torch, dev, n=PGO_N, seed=0):
    """The PGO's two reductions (slam/pgo.normal_eqs) for an odometry chain of
    n poses and one loop constraint (n - 2 -> 1), every pose free, with
    random f32 payloads: name -> (payload, ids, order, segments)."""
    from dpvo_tpu_torch.slam.pgo import pgo_graph

    iii = np.concatenate([np.arange(1, n), [n - 2]])
    jjj = np.concatenate([np.arange(n - 1), [1]])
    graph = pgo_graph(iii, jjj, n, n, dev)
    R = len(iii)
    g = torch.Generator().manual_seed(seed)
    x = lambda rows, k: torch.randn((rows, k), generator=g).to(dev)
    return {"H blocks [4R, 49]": (x(4 * R, 49), graph["h_seg"], graph["h_order"], n * n),
            "g terms [2R, 7]": (x(2 * R, 7), graph["g_seg"], graph["g_order"], n)}


def triplet_reduction(torch, dev, n=512, seed=0):
    """The triplet BA's depth reduction (ba/solver.assemble_normal_eqs at W =
    4): a [2 n, 6 W + 2] f32 payload into n depth variables, each seen from
    the two neighbours (kd = tile(arange(n), 2), its stable order)."""
    kd = np.tile(np.arange(n, dtype=np.int32), 2)
    g = torch.Generator().manual_seed(seed)
    t = lambda a: torch.as_tensor(a, device=dev)
    return (torch.randn((2 * n, 26), generator=g).to(dev), t(kd),
            t(np.argsort(kd, kind="stable").astype(np.int32)), n)


def classic_lc_kernels(torch, g):
    """The segment sum and the SPD solve at classic loop closure's call
    sites, each against its plain version: segsum_pgo (the PGO's H and g,
    PGO_N poses, into n^2 and n segments), segsum_triplet (the triplet BA's
    [1024, 26] into 512 depth variables), both bit for bit against the plain
    version on the CPU; spd_triplet (the triplet BA's pose system, n = 24: no
    pose is free, so S = I and y = 0, x = 0 bit for bit; and a random SPD
    system of that size within 1e-4 relative)."""
    from dpvo_tpu_torch.ba.segsum import segment_sum, segment_sum_plain
    from dpvo_tpu_torch.ba.spd_solve import spd_solve, spd_solve_plain

    dev = torch.device("cuda")
    out = {}
    for name, calls in (("segsum_pgo", list(pgo_reductions(torch, dev).values())),
                        ("segsum_triplet", [triplet_reduction(torch, dev)])):
        got = [segment_sum(*c).cpu() for c in calls]
        want = [segment_sum_plain(p.cpu(), kd.cpu(), Md) for p, kd, _, Md in calls]
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        print(f"{name}: {[tuple(c[0].shape) for c in calls]} into {[c[3] for c in calls]} "
              f"segments: bit for bit equal to the plain version: {same}")
        if not same:
            raise AssertionError(f"{name}: segsum kernel disagrees with its plain version")
        run = lambda: [segment_sum(*c) for c in calls]
        lib_args = [(p, kd.long(), Md) for p, kd, _, Md in calls]
        lib = lambda: [torch.zeros((Md, p.shape[1]), device=dev).index_add_(0, kd, p)
                       for p, kd, Md in lib_args]
        t = dict(ms=cuda_ms(run, 50), library_ms=cuda_ms(lib, 50), device_ms=device_ms(run, 50),
                 library_device_ms=device_ms(lib, 50))
        print(f"{name}: ms {{ms:.5f}} (index_add_ {{library_ms:.5f}}); device time "
              "{device_ms:.5f} ({library_device_ms:.5f})".format(**t))
        # each row read once with its int32 id and order, each output written once
        nbytes = sum(p.numel() * 4 + p.shape[0] * 8 + Md * p.shape[1] * 4 for p, _, _, Md in calls)
        out[name] = dict(max_abs_err=err, ms=t["ms"], library_ms=t["library_ms"],
                         device_ms=t["device_ms"],
                         plain_ms=cuda_ms(lambda: [segment_sum_plain(p, kd, Md)
                                                   for p, kd, _, Md in calls], 10),
                         bound=bound(nbytes, sum(p.numel() for p, *_ in calls), PEAK_F32))

    n = 24
    S, y = torch.eye(n, device=dev), torch.zeros(n, device=dev)
    x = spd_solve(S, y)
    if not torch.equal(x.cpu(), spd_solve_plain(S.cpu(), y.cpu())):
        raise AssertionError("spd_triplet: the identity system's solve differs from the plain one")
    A = torch.randn((n, n), generator=g, device=dev)
    Sr = (A @ A.T + n * torch.eye(n, device=dev)).contiguous()
    yr = torch.randn(n, generator=g, device=dev)
    xr, xp = spd_solve(Sr, yr), spd_solve_plain(Sr, yr)
    rel = ((xr - xp).abs().max() / xp.abs().max()).item()
    print(f"spd_triplet: n = {n}: S = I, y = 0 bit for bit equal to the plain version; a random "
          f"SPD system within {rel:.3g} relative")
    if rel > 1e-4:
        raise AssertionError("spd_triplet: SPD kernel disagrees with its plain version")
    t = dict(ms=cuda_ms(lambda: spd_solve(S, y), 50),
             library_ms=cuda_ms(lambda: torch.linalg.solve(S, y), 50),
             device_ms=device_ms(lambda: spd_solve(S, y), 50),
             library_device_ms=device_ms(lambda: torch.linalg.solve(S, y), 50))
    print("spd_triplet: ms {ms:.5f} (torch.linalg.solve {library_ms:.5f}); device time "
          "{device_ms:.5f} ({library_device_ms:.5f})".format(**t))
    out["spd_triplet"] = dict(max_abs_err=(x.cpu() - spd_solve_plain(S.cpu(), y.cpu())).abs()
                              .max().item(), ms=t["ms"], library_ms=t["library_ms"],
                              device_ms=t["device_ms"],
                              plain_ms=cuda_ms(lambda: spd_solve_plain(S, y), 10),
                              bound=bound((n * n + 2 * n) * 4, n ** 3 / 3 + 2 * n * n, PEAK_F32))
    return out


def corr_variant_kernels(torch, args, nframes, nrows):
    """Kernels A, B and C+D of the CORR_IMPL variants (ops/corr_pallas.py)
    on the correlation inputs above, each against its plain version. A
    kernel's time is that of one correlation call: its two launches, one
    per pyramid level."""
    from dpvo_tpu_torch.ops import corr_pallas as cp

    gmap, fmap1, fmap2, coords, ii1, jj1, valid = args
    E_cap, C = coords.shape[0], gmap.shape[1]
    E = int(valid.sum())
    f1, cs, jj, vs, _ = cp.sort_edges(gmap, coords, ii1, jj1, valid)
    levels = []
    for fmap, scale in ((fmap1, 1.0), (fmap2, 4.0)):
        _, H, W, _ = fmap.shape
        c = cs / scale
        win, _ = cp.window_inputs(c, vs, H, W, 3)
        sw, sw_epi = cp.sw_inputs(c, vs, H, W, 3)
        v3, v3_epi = cp.v3_inputs(c, vs, H, W, 3)
        levels.append(dict(fmap=fmap, HW=H * W, win=win, corr_sw_fused=sw + sw_epi,
                           corr_v3_fused=v3 + v3_epi))
    fits = [cp.window_union(*lv["win"])[-1][vs] for lv in levels]
    print(f"corr_window: live (edge, level) items by branch, kernel's rule: union grid "
          f"{int(fits[0].sum())} + {int(fits[1].sum())}, per-pixel {int((~fits[0]).sum())} + "
          f"{int((~fits[1]).sum())} (level 1 + level 2)")
    if all(f.all() for f in fits) or not any(f.any() for f in fits):
        raise AssertionError("the correlation inputs do not take both of kernel A's branches")
    feat_bytes = nframes * sum(lv["HW"] for lv in levels) * C * 2 + nrows * C * 9 * 2
    idx_bytes = E_cap * (4 + 1)  # jj, valid
    run = lambda fn: [fn(f1, lv["fmap"], jj, vs, *lv["win"]) for lv in levels]
    got, want = run(cp.corr_window), run(cp.corr_window_plain)
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    # one bf16 ulp, plus f32 accumulation error where a value cancels
    bad = sum(int(((a.float() - b.float()).abs() > 2.0 ** -7 * torch.maximum(
        a.float().abs(), b.float().abs()) + 2e-3).sum()) for a, b in zip(got, want))
    print(f"corr_window: max_abs_err {err:.6g}")
    if bad:
        raise AssertionError(f"corr_window kernel disagrees with its plain version ({bad} values)")
    nbytes = feat_bytes + 2 * (idx_bytes + E_cap * 9 * 2 * 4 + E_cap * 9 * 64 * 2)
    out = {"corr_window": dict(
        max_abs_err=err, ms=cuda_ms(lambda: run(cp.corr_window), 20),
        device_ms=device_ms(lambda: run(cp.corr_window), 20),
        plain_ms=cuda_ms(lambda: run(cp.corr_window_plain), 2, warmup=1), library_ms=None,
        bound=bound(nbytes, 2 * E * 9 * 64 * C * 2, PEAK_BF16))}
    for name in ("corr_sw_fused", "corr_v3_fused"):
        out[name] = superwindow_kernel(torch, cp, name, f1, jj, vs, levels, feat_bytes, idx_bytes)
    return out


# kernels B and C+D: the superwindow's plain dots (rows x columns), the
# plain epilogue on them as the kernel's plain version applies it, and the
# ends of the window offsets (dy, dxw)
SUPERWINDOWS = {"corr_sw_fused": ((14, 32), (6, 24)), "corr_v3_fused": ((16, 24), (7, 15))}


def superwindow_kernel(torch, cp, name, f1, jj, vs, levels, feat_bytes, idx_bytes):
    """Kernel B or C+D against its plain version (superwindow_plain, then
    the selection and bilinear of level_sw or the v3 epilogue, sliced and
    padded): torch.equal on integer features (every f32 dot exact, so the
    raw dots agree and the epilogue rounds where its plain version rounds)
    at the correlation inputs' geometry and at the ends of the window
    offsets; within the raw dots' bf16 ulp, carried through the epilogue,
    on the Gaussian features."""
    E_cap, C = f1.shape[0], f1.shape[2]
    E = int(vs.sum())
    dev = f1.device
    g = torch.Generator(device=dev).manual_seed(1)
    kern, plain = getattr(cp, name), getattr(cp, name + "_plain")
    (R, Cw), (dy_max, dxw_max) = SUPERWINDOWS[name]
    fused = lambda fn, f, lvs: [fn(f, lv["fmap"], jj, vs, *lv[name]) for lv in lvs]
    got, want = fused(kern, f1, levels), fused(plain, f1, levels)

    # the plain epilogue on the magnitudes of the plain raw dots bounds how
    # far one bf16 ulp of each raw dot (and a flipped rounding of v3's row
    # stage) moves an output
    def envelope(lv):
        syc, sxc, dy, dxw, dyf, dxf, vf = lv[name]
        s = cp.superwindow_plain(f1, lv["fmap"], jj, vs, syc, sxc, R, Cw).abs()
        if name == "corr_sw_fused":
            return cp.epilogue_sw_plain(s, dy, dxw, dyf, dxf, vf).float()
        wide = cp.epilogue_v3_plain(s, dy, dxw, dyf, dxf, vf).reshape(E_cap, 9, 7, Cw)[..., :7]
        return torch.nn.functional.pad(wide, (0, 1, 0, 1)).reshape(E_cap, 9, 64).float()

    env = [envelope(lv) for lv in levels]
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    bad = sum(int(((a.float() - b.float()).abs() > 2.0 ** -6 * m + 2.0 ** -7 * b.float().abs()
                   + 2e-3).sum()) for a, b, m in zip(got, want, env))
    print(f"{name}: Gaussian features: max_abs_err {err:.6g}, equal values "
          f"{sum(int((a == b).sum()) for a, b in zip(got, want))} of "
          f"{sum(a.numel() for a in got)}")
    if bad:
        raise AssertionError(f"{name} disagrees with its plain version ({bad} values)")
    ints = lambda t: torch.randint(-3, 4, t.shape, generator=g, device=dev).to(torch.bfloat16)
    f1i = ints(f1)
    lvi = [dict(lv, fmap=ints(lv["fmap"])) for lv in levels]
    if not all(torch.equal(a, b) for a, b in zip(fused(kern, f1i, lvi), fused(plain, f1i, lvi))):
        raise AssertionError(f"{name} disagrees with its plain version on exact dots")
    # the ends of the window offsets, bilinear fractions 0 and 1, masked
    # pixels; then the pixels' windows spread over the superwindow (dy 0 /
    # dy_max / 2 / dy_max by pixel row, dxw likewise by pixel column): B's
    # union of 14 x 32 positions takes its per-pixel branch
    syc, sxc, _, _, _, _, vf = lvi[0][name]
    full = lambda v: torch.full((E_cap, 9), v, dtype=torch.int32, device=dev)
    p = torch.arange(9, device=dev).expand(E_cap, 9)
    spread = ((p // 3 * (dy_max // 2)).int().contiguous(),
              (p % 3 * (dxw_max // 2)).int().contiguous())
    for dy, dxw in [(full(a), full(b)) for a in (0, dy_max) for b in (0, dxw_max)] + [spread]:
        frac = torch.tensor([0.0, 1.0], device=dev)[
            torch.randint(0, 2, (E_cap, 9), generator=g, device=dev)]
        case = (f1i, lvi[0]["fmap"], jj, vs, syc, sxc, dy, dxw, frac, 1 - frac,
                vf * (torch.rand((E_cap, 9), generator=g, device=dev) > 0.3).float())
        if not torch.equal(kern(*case), plain(*case)):
            raise AssertionError(f"{name} disagrees with its plain version at dy "
                                 f"{dy[0].tolist()}, dxw {dxw[0].tolist()}")
    fits = cp.window_union(syc[:, None] + spread[0], sxc[:, None] + spread[1])[-1][vs]
    print(f"{name}: torch.equal to its plain version on integer features, at the "
          f"correlation inputs' windows, at dy 0 / {dy_max} x dxw 0 / {dxw_max} with "
          "fractions 0 and 1 and masked pixels, and with windows spread over the "
          f"superwindow (union grid {int(fits.sum())}, per-pixel {int((~fits).sum())} of "
          f"{E} live items)")
    if name == "corr_sw_fused" and fits.any():
        raise AssertionError("the spread windows do not take kernel B's per-pixel branch")
    # per level: syc/sxc [E] and the five per-pixel inputs read, the
    # [E, 9, 64] bf16 output written; 2 x 9 x 64 x C operations per edge.
    # Beside it the bounds of the kernels it replaces: B's raw 14 x 32
    # superwindow written (torch's epilogue not counted); C (the raw 16 x 24
    # superwindow written) and D (its live rows read back, [E, 9, 168]
    # written)
    per_level = idx_bytes + E_cap * 2 * 4 + E_cap * 9 * 5 * 4 + E_cap * 9 * 64 * 2
    new = bound(feat_bytes + 2 * per_level, 2 * 2 * E * 9 * 64 * C, PEAK_BF16)
    old = bound(feat_bytes + 2 * (idx_bytes + E_cap * 2 * 4 + E_cap * 9 * R * Cw * 2),
                2 * E * 9 * R * Cw * C * 2, PEAK_BF16)
    if name == "corr_sw_fused":
        print(f"{name}: bound {new[0]:.5f} ms ({new[1]}); unfused B {old[0]:.5f} ms")
    else:
        old_d = bound(2 * E_cap * 9 * (192 * 2 + 5 * 4 + 168 * 2),
                      2 * E_cap * 9 * 168 * (4 + 6), PEAK_F32)
        print(f"{name}: bound {new[0]:.5f} ms ({new[1]}); unfused C {old[0]:.5f} + D "
              f"{old_d[0]:.5f} = {old[0] + old_d[0]:.5f} ms")
    return dict(max_abs_err=err, ms=cuda_ms(lambda: fused(kern, f1, levels), 20),
                device_ms=device_ms(lambda: fused(kern, f1, levels), 20),
                plain_ms=cuda_ms(lambda: fused(plain, f1, levels), 2, warmup=1),
                library_ms=None, bound=new)


def loop_trajectory(n_frames, span=2.4, ry=0.10):
    """Out-and-back lateral pan with gentle yaw, frame 0 and the last frames
    viewing the same part of the plane (world-to-camera poses [n, 7]); a
    copy of scripts/lc_ab.py:loop_trajectory, which imports JAX."""
    from dpvo_tpu_torch.utils.synthetic import _nse3_exp

    ts = np.linspace(0, 2 * np.pi, n_frames)
    xs = span * (1 - np.cos(ts)) / 2  # 0 -> span -> 0
    yaw = ry * np.sin(ts)
    return np.stack([_nse3_exp(np.array([-x, 0, 0, 0, r, 0]))
                     for x, r in zip(xs, yaw)]).astype(np.float32)


def scene_oracle(scene, noise=0.0, seed=0):
    """The oracle hook for a PlaneScene: every edge's ground-truth
    reprojection target at weight 1 (tests/test_runtime.py:make_oracle),
    plus Gaussian noise of `noise` px at 1/4 resolution from a generator
    seeded with `seed` (scripts/lc_ab.py's noisy oracle)."""
    rng = np.random.default_rng(seed)

    def oracle(slam, es):
        E, c = es.count, slam.cfg.P // 2
        xy = slam.state.patches[:, :2, c, c].cpu().numpy()  # [N*M, 2] at 1/4 res
        row2frame = np.asarray(slam.tstamps)
        target = scene.gt_targets(scene.poses, xy, row2frame[es.ii[:E]], row2frame[es.jj[:E]],
                                  es.kk[:E])
        target = target + noise * rng.standard_normal(target.shape).astype(np.float32)
        return target, np.ones((E, 2), np.float32)

    return oracle


class SceneKeypoints:
    """Classic loop closure's detector for a PlaneScene where OpenCV is
    missing (the card's machine has none): a fixed set of points on the
    scene's plane, uniform over the union of the frames' footprints, about
    `per_view` in a view, each with a 32-byte descriptor, all drawn from
    `seed`. Detecting in frame t projects them with t's ground-truth pose,
    keeps those inside the image (the first MAX_DESC in point order) and
    flips `flips` bits of each kept descriptor, drawn from (seed, t).
    ``__call__(image)`` knows a frame by its array (one of `frames`)."""

    def __init__(self, scene, frames, per_view=320, flips=4, seed=0):
        from dpvo_tpu_torch.slam.retrieval import MAX_DESC

        self.scene, self.flips, self.seed, self.max_desc = scene, flips, seed, MAX_DESC
        self.frame_of = {f.ctypes.data: t for t, f in enumerate(frames)}
        h, w = scene.ht - 1.0, scene.wd - 1.0
        corners = []
        for t in range(len(scene.poses)):
            o, d = scene._rays(t, np.array([0.0, w, 0.0, w]), np.array([0.0, 0.0, h, h]))
            corners.append(o[:2] + d[:, :2] * ((scene.depth - o[2]) / d[:, 2:3]))
        corners = np.concatenate(corners)
        lo, hi = corners.min(0), corners.max(0)
        view = (scene.wd / scene.fx) * (scene.ht / scene.fy) * scene.depth ** 2
        rng = np.random.default_rng(seed)
        n = int(np.prod(hi - lo) / view * per_view)
        self.points = np.concatenate([rng.uniform(lo, hi, (n, 2)),
                                      np.full((n, 1), scene.depth)], 1)
        self.desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)

    def __call__(self, image):
        from dpvo_tpu_torch.utils.synthetic import _nq_rotmat

        t = self.frame_of[image.ctypes.data]
        sc, pose = self.scene, self.scene.poses[t].astype(np.float64)
        X = self.points @ _nq_rotmat(pose[3:7]).T + pose[:3]
        u = sc.fx * X[:, 0] / X[:, 2] + sc.cx
        v = sc.fy * X[:, 1] / X[:, 2] + sc.cy
        inside = (X[:, 2] > 0.1) & (u >= 0) & (u < sc.wd) & (v >= 0) & (v < sc.ht)
        idx = np.nonzero(inside)[0][:self.max_desc]
        rng = np.random.default_rng([self.seed, t])
        desc = self.desc[idx].copy()
        bits = rng.integers(0, 256, (len(idx), self.flips))
        rows = np.repeat(np.arange(len(idx)), self.flips)
        np.bitwise_xor.at(desc, (rows, bits.ravel() // 8),
                          (1 << (bits.ravel() % 8)).astype(np.uint8))
        return np.stack([u[idx], v[idx]], 1).astype(np.float32), desc


def render_main_scene(n_frames):
    from dpvo_tpu_torch.utils.synthetic import PlaneScene

    scene = PlaneScene(ht=480, wd=640, n_frames=n_frames, depth=4.0, seed=7, tstep=0.06,
                       rstep=0.004)
    return scene, [scene.render(t) for t in range(n_frames)]


def phase_main_path(torch, kernels):
    from dpvo_tpu_torch import DPVO, load_config
    from dpvo_tpu_torch.lie import se3

    ht, wd, n_frames, warm, n_prof = 480, 640, 40, 15, 5
    cfg = load_config(os.path.join(ROOT, "config", "default.yaml"))
    scene, frames = render_main_scene(n_frames)
    slam = DPVO(cfg, os.path.join(ROOT, "weights", "vonet_synth.npz"), ht, wd)

    def step(t):
        t0 = time.perf_counter()
        slam(t, frames[t], scene.intrinsics.copy())
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    step_ms = [step(t) for t in range(n_frames - n_prof)]
    # the last frames run under the profiler (kept out of the timing above)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(n_frames - n_prof, n_frames):
            step(t)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    poses, _ = slam.terminate()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"main path: initialized {slam.is_initialized}, keyframes {slam.n}, "
          f"active edges {len(slam.topo.ii)}, launches {launches}")
    if not slam.is_initialized:
        raise AssertionError("the tracker did not initialize")
    if not np.isfinite(poses).all() or poses.shape != (n_frames, 7):
        raise AssertionError("non-finite or misshapen poses")
    missing = [k for k in IMPL_KERNELS["xla"] + PATH_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    steady = step_ms[warm:]
    gt = se3.inv(torch.as_tensor(scene.poses[:n_frames])).numpy()
    ate = ate_rmse(poses[:, :3], gt[:, :3])
    # a smoke reading over a 20-frame window, not the port's frame rate
    print(f"main path (smoke reading): {1e3 / np.mean(steady):.3f} frames/s over frames {warm}-"
          f"{n_frames - n_prof - 1}, "
          f"median step {np.median(steady):.3f} ms, max {np.max(steady):.3f} ms, "
          f"ATE {ate:.4f} (path length "
          f"{np.linalg.norm(np.diff(gt[:, :3], axis=0), axis=1).sum():.3f}), peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    _print_profile(prof, prof_wall_ms, n_prof)
    return launches, ate


# the kernels each CORR_IMPL's correlation runs, and those every run of the
# default configuration adds: BA's f32 segment sum and pose solve, SoftAgg's
# bf16 segment sums
IMPL_KERNELS = {"xla": ["corr"], "pallas": ["corr_window"], "pallas_sw": ["corr_sw_fused"],
                "pallas_dma": ["corr_v3_fused"], "pallas_fused": ["corr"]}
# their last 5 frames run under the profiler
IMPL_PROFILED = ("pallas", "pallas_sw", "pallas_dma")
# the kernels whose union-grid branch phase 4 counts on their paths (A and B)
UNION_KERNELS = {"pallas": "corr_window", "pallas_sw": "corr_sw_fused"}
# Bound on each variant's ATE, written before the first card run: the variants
# differ from the exact windows only in bf16 rounding points and, for the
# superwindows, in windows clamped beyond +-3 px of the patch centre, which real
# patches (one depth, 3x3 px at 1/4 resolution) do not reach; over 30 frames of
# a well-conditioned 96-patch scene that moves the trajectory by rounding-level
# amounts, so each variant tracks within 1.5x the exact run's ATE.
IMPL_ATE_FACTOR = 1.5
IMPL_FRAMES = 30
PATH_KERNELS = ["segsum", "segsum_bf16", "spd_solve"]


def phase_corr_impls(torch, kernels):
    """The main path once per CORR_IMPL: DPVO with config/default.yaml and
    CORR_IMPL set, weights/vonet_synth.npz, the 480x640 scene of phase 3 for
    30 frames, terminate(). Each run's launch counters are zeroed just
    before it and read just after: its correlation kernels, segsum and
    spd_solve must have run. Its ATE is held to IMPL_ATE_FACTOR x the exact
    (xla) run's. The exact run is made twice, and the two must give the
    same bits (no float atomics on the path)."""
    from dpvo_tpu_torch import DPVO, load_config
    from dpvo_tpu_torch.lie import se3

    scene, frames = render_main_scene(IMPL_FRAMES)
    gt = se3.inv(torch.as_tensor(scene.poses[:IMPL_FRAMES])).numpy()

    def run(impl, n_prof=0, before_prof=None):
        """Track the scene; the last n_prof frames under the profiler, after
        calling before_prof()."""
        from torch.profiler import ProfilerActivity, profile

        cfg = load_config(os.path.join(ROOT, "config", "default.yaml"),
                          overrides={"CORR_IMPL": impl})
        slam = DPVO(cfg, os.path.join(ROOT, "weights", "vonet_synth.npz"), 480, 640)
        t0 = time.perf_counter()
        kernels.reset_launches()
        for t, image in enumerate(frames[:IMPL_FRAMES - n_prof]):
            slam(t, image, scene.intrinsics.copy())
        if n_prof:
            if before_prof:
                before_prof()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                for t in range(IMPL_FRAMES - n_prof, IMPL_FRAMES):
                    slam(t, frames[t], scene.intrinsics.copy())
                torch.cuda.synchronize()
                prof_wall_ms = (time.perf_counter() - t1) * 1e3
            print(f"CORR_IMPL={impl}: the last {n_prof} frames under the profiler")
            _print_profile(prof, prof_wall_ms, n_prof)
        poses, _ = slam.terminate()
        torch.cuda.synchronize()
        return slam, poses, dict(kernels.LAUNCHES), time.perf_counter() - t0

    def count_branches():
        """Wrap the tracker's correlation so that each call also counts its
        live (edge, level) items by corr.cu's branch (kernel's rule); the
        values and launches are those of the plain run. Returns the counts
        [live edges, union tiles level 1, level 2] and an undo."""
        from dpvo_tpu_torch.ops.corr_cuda import union_tile_levels
        from dpvo_tpu_torch.runtime import steps

        real, counts = steps.corr_features, torch.zeros(3, dtype=torch.long, device="cuda")

        def counted(g, f1, f2, coords, ii, jj, valid, radius=3, clamp=False):
            tiles = union_tile_levels(coords, f1.shape[1:3], f2.shape[1:3], radius, clamp)
            counts.add_(torch.cat([valid.sum()[None], (tiles & valid[:, None]).sum(0)]))
            return real(g, f1, f2, coords, ii, jj, valid, radius=radius, clamp=clamp)

        steps.corr_features = counted
        return counts, lambda: setattr(steps, "corr_features", real)

    def count_union_branches(name):
        """The same for kernel A or B (name "corr_window" or "corr_sw_fused")
        on its path: each call of its wrapper also counts its live items and
        those its dot grid holds (the kernel's rule, ops/corr_pallas.py:
        window_union), by level (map height). Returns the counts {H: [live,
        union grid]} and an undo."""
        from dpvo_tpu_torch.ops import corr_pallas as cp

        real, counts = getattr(cp, name), {}

        def counted(f1, fmap, jj, valid, y, x, *epi):
            live = valid & (jj >= 0) & (jj < fmap.shape[0])
            # B's windows at (syc + dy, sxc + dxw)
            union = (cp.window_union(y[:, None] + epi[0], x[:, None] + epi[1]) if epi
                     else cp.window_union(y, x))
            c = counts.setdefault(fmap.shape[1], torch.zeros(2, dtype=torch.long, device="cuda"))
            c.add_(torch.stack([live.sum(), (union[-1] & live).sum()]))
            return real(f1, fmap, jj, valid, y, x, *epi)

        setattr(cp, name, counted)
        return counts, lambda: setattr(cp, name, real)

    launches, ates = {}, {}
    for impl, ks in IMPL_KERNELS.items():
        # kernel A's and B's branches are counted up to the profiled frames
        union, undo = (count_union_branches(UNION_KERNELS[impl]) if impl in UNION_KERNELS
                       else (None, None))
        slam, poses, launches[impl], sec = run(impl, 5 if impl in IMPL_PROFILED else 0, undo)
        if union:
            print(f"CORR_IMPL={impl}: {UNION_KERNELS[impl]}'s branches over frames 0-"
                  f"{IMPL_FRAMES - 6}, kernel's rule: " + ", ".join(
                      f"union grid {g} of {n} live items at level {lvl} (per-pixel {n - g})"
                      for lvl, (n, g) in enumerate(
                          (union[h].tolist() for h in sorted(union, reverse=True)), 1)))
        if not slam.is_initialized or not np.isfinite(poses).all():
            raise AssertionError(f"CORR_IMPL={impl}: no initialization or non-finite poses")
        missing = [k for k in ks + PATH_KERNELS if launches[impl][k] == 0]
        if missing:
            raise AssertionError(f"CORR_IMPL={impl}: kernels not launched: {missing}")
        ates[impl] = ate_rmse(poses[:, :3], gt[:, :3])
        print(f"CORR_IMPL={impl}: {IMPL_FRAMES} frames in {sec:.2f} s, "
              f"keyframes {slam.n}, ATE {ates[impl]:.5f}, launches "
              f"{ {k: v for k, v in launches[impl].items() if v} }")
        if impl == "xla":
            counts, undo = count_branches()
            with segsum_runs(torch, "phase 4, the second xla run"):
                again = run(impl)[1]
            undo()
            n, t1, t2 = counts.tolist()
            print(f"CORR_IMPL={impl}: corr.cu's branches over the run, kernel's rule: union tile "
                  f"{t1} of {n} live edges at level 1, {t2} at level 2; per-pixel {n - t1} + "
                  f"{n - t2}")
            print(f"CORR_IMPL={impl}: a second run bit for bit equal: "
                  f"{np.array_equal(poses, again)} (largest difference "
                  f"{np.abs(again - poses).max():.3g})")
            if not np.array_equal(poses, again):
                raise AssertionError("two card runs of the 480x640 path differ")
    for impl, ate in ates.items():
        if ate > IMPL_ATE_FACTOR * ates["xla"]:
            raise AssertionError(f"CORR_IMPL={impl}: ATE {ate:.5f} above {IMPL_ATE_FACTOR} x "
                                 f"the exact run's {ates['xla']:.5f}")

    # the main path with PIPELINE_DEPTH 3: each keyframe decision applied
    # three frames late, as the JAX tracker applies it
    cfg = load_config(os.path.join(ROOT, "config", "default.yaml"),
                      overrides={"PIPELINE_DEPTH": 3})
    slam = DPVO(cfg, os.path.join(ROOT, "weights", "vonet_synth.npz"), 480, 640)
    kernels.reset_launches()
    deepest, init_delta = 0, None
    for t, image in enumerate(frames):
        slam(t, image, scene.intrinsics.copy())
        deepest = max(deepest, len(slam._inflights))
        if slam.is_initialized and init_delta is None:
            init_delta = len(slam.delta)  # after it, only a cull adds to delta
    poses, _ = slam.terminate()
    depth3 = dict(kernels.LAUNCHES)
    culls = len(slam.delta) - (init_delta or 0)
    print(f"PIPELINE_DEPTH=3: {IMPL_FRAMES} frames, decisions pending at most {deepest}, "
          f"culls {culls}, keyframes {slam.n}, ATE {ate_rmse(poses[:, :3], gt[:, :3]):.5f}, "
          f"launches { {k: v for k, v in depth3.items() if v} }")
    missing = [k for k in IMPL_KERNELS["xla"] + PATH_KERNELS if depth3[k] == 0]
    if not slam.is_initialized or deepest != 3 or culls == 0 or missing \
            or not np.isfinite(poses).all() or poses.shape != (IMPL_FRAMES, 7):
        raise AssertionError("PIPELINE_DEPTH=3: no initialization, no pipeline, no cull, "
                             f"kernels not launched ({missing}) or bad poses")
    return launches


def _print_profile(prof, wall_ms, n, top=15, unit="frame"):
    """Device time by kernel over n profiled frames, the `top` costliest by
    name (profiler wall time includes its own overhead; the busy share is
    kernel time / wall)."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in evs)
    if busy_us == 0:
        print("profile: the profiler recorded no device time (busy share not measured)")
        return
    print(f"profile over {n} {unit}s: wall {wall_ms / n:.3f} ms/{unit}, kernel time "
          f"{busy_us / 1e3 / n:.3f} ms/{unit} (busy {100 * busy_us / 1e3 / wall_ms:.1f}%), "
          f"{sum(e.count for e in evs) / n:.0f} kernel launches/{unit}")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/{unit} {e.count / n:7.1f}/{unit}  "
              f"{e.key[:100]}")
    for name in ("window_union_kernel", "sw_fused_kernel", "v3_fused_kernel"):  # A, B, C+D
        mine = [e for e in evs if name in e.key]
        if mine:
            print(f"  {name}: {sum(e.self_device_time_total for e in mine) / 1e3 / n:.4f} "
                  f"ms/{unit} in {sum(e.count for e in mine) / n:.1f} launches/{unit}")


def _sync(dst, src):
    """Give tracker dst the exact state of tracker src (tensors, topology,
    host bookkeeping)."""
    import copy

    for f in dst.state.__dataclass_fields__:
        getattr(dst.state, f).copy_(getattr(src.state, f))
    dst.topo = copy.deepcopy(src.topo)
    for attr in ("is_initialized", "counter", "tlist", "tstamps", "delta", "_inflights"):
        setattr(dst, attr, copy.deepcopy(getattr(src, attr)))


# tests/test_tracking_e2e.py's tiny configuration (tests/fixtures/tiny_synth.npz)
SMALL_CFG = dict(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=10, OPTIMIZATION_WINDOW=6,
                 PATCH_LIFETIME=5, KEYFRAME_INDEX=2, KEYFRAME_THRESH=12.5, MIXED_PRECISION=False,
                 E_MAX=1024, E_INAC_MAX=1024, W_OPT_MAX=8, M_OPT_MAX=128, PMEM=16, MEM=16,
                 DIM=64, FDIM=32)
# The tiny network tracks 8 patches a frame, and over 24 frames it amplifies
# rounding differences on most random draws of those patches: a keyframe
# decision flips and the trajectories part. The draws of this seed are ones
# on which it does not (tests/test_torch_slice.py::
# test_small_parity_draws_are_well_conditioned holds them to that on the CPU),
# with 1, 2, 4 or 8 torch threads on the CPU (each a summation order of its own).
SMALL_DRAW_SEED = 109
# Per-frame tolerances, as a fraction of each buffer's largest magnitude.
# The feature rings and patches come from the encoders alone (f32 convolutions
# in another summation order); the edge payloads pass through up to 12 update
# rounds whose correlation features are rounded to bf16, so one flipped bf16
# ulp (2^-8) can move them by a few times that.
SMALL_FRAME_RTOL = {"patches": 1e-4, "intrinsics": 1e-6, "imap": 1e-4, "gmap": 1e-4,
                    "fmap1": 1e-4, "fmap2": 1e-4, "net": 0.02, "target": 0.01, "weight": 0.02,
                    "target_inac": 0.01, "weight_inac": 0.02}


def small_path(**overrides):
    """The tiny configuration (with overrides of its fields), its scene,
    draws and frames."""
    from dpvo_tpu_torch import DPVO
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.utils.synthetic import PlaneScene

    cfg = Config(**dict(SMALL_CFG, **overrides))
    ht, wd, n_frames = 48, 64, 24
    scene = PlaneScene(ht=ht, wd=wd, n_frames=n_frames, depth=5.0, seed=9002, tstep=0.3,
                       rstep=0.008)
    rng = np.random.default_rng(SMALL_DRAW_SEED)
    M, h, w = cfg.PATCHES_PER_FRAME, ht // 4, wd // 4
    draws = [(np.stack([rng.integers(1, w - 1, M), rng.integers(1, h - 1, M)], -1)
              .astype(np.float32), rng.uniform(size=M).astype(np.float32))
             for _ in range(n_frames)]
    frames = [scene.render(t) for t in range(n_frames)]
    weights = os.path.join(ROOT, "tests", "fixtures", "tiny_synth.npz")

    def tracker(dev):
        return DPVO(cfg, weights, ht, wd, device=dev, draws=lambda f: draws[f])

    return tracker, frames, scene.intrinsics


def free_run(slam, frames, intrinsics):
    """Track every frame; returns (init frame, poses and inverse depths at
    initialization, keyframe timestamps, the poses after terminate())."""
    init = None
    for t, image in enumerate(frames):
        was = slam.is_initialized
        slam(t, image, intrinsics.copy())
        if slam.is_initialized and not was:
            init = (t, slam.state.poses[:slam.n].cpu().clone(),
                    slam.state.dvec[:slam.m].cpu().clone())
    poses, _ = slam.terminate()
    return init, list(slam.tstamps), poses


def check_free_runs(ref, alt, who="card"):
    """Hold free_run() results alt against ref. As tests/test_torch_slice.py
    holds the CPU port to the JAX package: the init state within f32
    summation order and the bf16 rounding flips of the correlation through
    12 rounds, the same keyframes, the positions within 1% of the path and
    the quaternions within 0.01 per component."""
    (ri, rk, rp), (di, dk, dp) = ref, alt
    path = np.linalg.norm(np.diff(rp[:, :3], axis=0), axis=1).sum()
    same_init = ri is not None and di is not None and ri[0] == di[0]
    d_init = ((di[1] - ri[1]).abs().max().item(), (di[2] - ri[2]).abs().max().item()) \
        if same_init else (np.inf, np.inf)
    d_t = np.abs(dp[:, :3] - rp[:, :3]).max()
    d_q = np.abs(np.abs(dp[:, 3:]) - np.abs(rp[:, 3:])).max()
    print(f"small path, free-running: init at frame {ri and ri[0]} ({who} {di and di[0]}), "
          f"init state difference poses {d_init[0]:.3g}, inverse depths {d_init[1]:.3g}; "
          f"keyframes {rk} ({who} {dk}); trajectory difference {d_t:.3g} on a path of "
          f"{path:.4g}, quaternions {d_q:.3g}")
    if d_init[0] > 1e-3 or d_init[1] > 0.02:
        raise AssertionError(f"{who} and CPU trackers initialize differently")
    if dk != rk or not (np.isfinite(dp).all() and d_t < 0.01 * path and d_q < 0.01):
        raise AssertionError(f"free-running {who} and CPU trajectories disagree")


def phase_small_parity(torch):
    """The tiny configuration on the card against the same on the CPU, with
    the same injected draws, compared two ways.

    Free-running, as tests/test_torch_slice.py holds the CPU port to the JAX
    package: the same init frame and state after its 12 updates, the same
    keyframes, the same trajectory, for each of two card runs, and the two
    card runs bit for bit equal (no float atomics on the path). Frame by
    frame: the card's tracker
    starts every frame from the CPU tracker's exact state, and after the
    frame (probe gate, patchify, 12 init updates or one update plus
    keyframing) both took the same decisions and every buffer of the state
    agrees, the feature rings moved by a keyframe cull included."""
    tracker, frames, K = small_path()
    ref = free_run(tracker("cpu"), frames, K)
    with segsum_runs(torch, "phase 5, the tiny tracker's card runs"):
        cards = [free_run(tracker("cuda"), frames, K) for _ in range(2)]
    for card in cards:
        check_free_runs(ref, card)
    (i0, k0, p0), (i1, k1, p1) = cards
    same = (i0[0] == i1[0] and torch.equal(i0[1], i1[1]) and torch.equal(i0[2], i1[2])
            and k0 == k1 and np.array_equal(p0, p1))
    print(f"small path, free-running: two card runs bit for bit equal: {same} (largest "
          f"difference {np.abs(p1 - p0).max():.3g})")
    if not same:
        raise AssertionError("two card runs of the small path differ")

    ref, dev = tracker("cpu"), tracker("cuda")
    fields = list(ref.state.__dataclass_fields__)
    worst = {f: 0.0 for f in fields}
    for t, image in enumerate(frames):
        _sync(dev, ref)
        ref(t, image, K.copy())
        dev(t, image, K.copy())
        if (dev.n, dev.tstamps, dev.is_initialized) != (ref.n, ref.tstamps, ref.is_initialized) \
                or not all(np.array_equal(getattr(dev.topo, a), getattr(ref.topo, a))
                           for a in ("ii", "jj", "kk")):
            raise AssertionError(f"frame {t}: card and CPU took different decisions")
        for f in fields:
            a = getattr(dev.state, f).cpu().float()
            b = getattr(ref.state, f).float()
            diff = (a - b).abs().max().item()
            worst[f] = max(worst[f], diff if f in ("poses", "dvec")
                           else diff / max(b.abs().max().item(), 1e-30))
    print("small path, frame by frame: worst difference card vs CPU: " + ", ".join(
        f"{f} {v:.3g}" for f, v in worst.items()) + " (poses, dvec absolute; the rest relative "
        "to the buffer's largest magnitude)")
    # poses and inverse depths as at initialization above
    bad = [f for f, v in worst.items()
           if v > {"poses": 1e-3, "dvec": 0.02}.get(f, SMALL_FRAME_RTOL.get(f, 0.0))]
    if bad:
        raise AssertionError(f"card and CPU states disagree after a frame: {bad}")


def gba_problem(torch, seed=3, n=6, npts=64, noise=0.5, pad=37):
    """tests/test_ba.py:synthetic_problem's layout: every point, anchored in
    frame 0, seen in every frame; perturbed poses and depths; invalid
    padding edges at the end. Returns gba's first nine arguments on the
    CPU, the valid edges' (ii, jj, kd) as numpy, n and the point count."""
    from dpvo_tpu_torch.geom import projective as pops
    from dpvo_tpu_torch.lie import se3

    g = torch.Generator().manual_seed(seed)
    intr = torch.tensor([[120.0, 120.0, 80.0, 60.0]]).repeat(n, 1)
    xi = torch.cat([0.12 * torch.randn(n, 3, generator=g), 0.03 * torch.randn(n, 3, generator=g)],
                   -1)
    poses = [se3.identity()]
    for i in range(1, n):
        poses.append(se3.mul(se3.exp(xi[i]), poses[-1]))
    poses = torch.stack(poses)
    ctr = torch.stack([30 + 100 * torch.rand(npts, generator=g),
                       25 + 70 * torch.rand(npts, generator=g),
                       0.3 + 0.5 * torch.rand(npts, generator=g)], -1)
    jj = torch.arange(n).repeat_interleave(npts)
    kd = torch.arange(npts).repeat(n)
    ii = torch.zeros_like(jj)
    target = pops.transform(poses, ctr[:, :, None, None], intr, ii, jj, kd)[:, 0, 0]
    target = target + noise * torch.randn(target.shape, generator=g)
    poses0 = poses.clone()
    poses0[1:, :3] += 0.05 * torch.randn(n - 1, 3, generator=g)
    ctr0 = ctr.clone()
    ctr0[:, 2] *= 1 + 0.15 * torch.randn(npts, generator=g)
    E = len(ii)
    padE = lambda a: torch.cat([a, torch.zeros((pad,) + a.shape[1:], dtype=a.dtype)])
    weight = torch.cat([torch.ones(E, 2), torch.zeros(pad, 2)])
    valid = torch.arange(E + pad) < E
    return (poses0, ctr0, intr, padE(target), weight, valid, padE(ii), padE(jj),
            padE(kd).to(torch.int32)), (ii.numpy(), jj.numpy(), kd.numpy()), n, npts


def gba_card_vs_cpu(torch, dev="cuda"):
    """The sparse global BA (two iterations) of gba_problem on the card and
    on the CPU: the largest |card - CPU| of poses and depths with each
    side's own dense solve (``own_solve``) and with the card's solve moved
    to the CPU (``cpu_solve``, the same LAPACK Cholesky on both sides),
    whether two card runs give the same bits, the segment sums one card
    run launched and the largest pose step."""
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.ba import gba_sparse

    args, (ii, jj, kd), n, Md = gba_problem(torch)
    idx = gba_sparse.build_sparse_indices(ii, jj, kd, 1, n - 1, W=8, R_MAX=4096, KP_MAX=1 << 14)
    bounds = torch.tensor([-64.0, -64.0, 224.0, 184.0])
    run = lambda d: [x.cpu() for x in gba_sparse.gba(
        *(a.to(d) for a in args[:9]), 1, n - 1, bounds.to(d), 1e-4,
        gba_sparse.index_tensors(idx, d), W=8, Md=Md, iterations=2)]
    diff = lambda a, b: tuple((x - y).abs().max().item() for x, y in zip(a, b))
    cpu = run("cpu")
    before = kernels.LAUNCHES["segsum"]
    card = run(dev)
    launches = kernels.LAUNCHES["segsum"] - before
    again = run(dev)
    factor, solve = torch.linalg.cholesky_ex, torch.cholesky_solve
    torch.linalg.cholesky_ex = lambda S: tuple(x.to(S.device) for x in factor(S.cpu()))
    torch.cholesky_solve = lambda y, L: solve(y.cpu(), L.cpu()).to(y.device)
    try:
        mixed = run(dev)
    finally:
        torch.linalg.cholesky_ex, torch.cholesky_solve = factor, solve
    return dict(own_solve=diff(card, cpu), cpu_solve=diff(mixed, cpu),
                repeat_equal=all(torch.equal(a, b) for a, b in zip(card, again)),
                segsum_launches=launches, step=(cpu[0] - args[0]).abs().max().item())


# phase 5's oracle loop-closure cell: tests/test_torch_loop_closure.py's
# (scripts/lc_ab.py's configuration at 128x160, 48 frames, oracle noise 0.25)
LC_SMALL_CFG = dict(SMALL_CFG, BUFFER_SIZE=192, E_MAX=4096, E_INAC_MAX=8192, M_OPT_MAX=1024,
                    MAX_EDGE_AGE=96, KEYFRAME_THRESH=0.0, GBA_POSES_MAX=256,
                    GBA_DEPTHS_MAX=4096, GBA_EDGES_MAX=16384, GBA_KPAIRS_MAX=1 << 18,
                    LOOP_CLOSURE=True, GLOBAL_OPT_FREQ=10, BACKEND_THRESH=64.0)
# Bound on |card - CPU| of that run's poses, written before its first card
# run: each global-BA round differs by f32 summation order (the CPU tests
# measured ~1e-5 per round between two f32 implementations), and the
# oracle's targets pin the geometry, so the differences do not compound
# past a few rounds' worth.
LC_SMALL_POSE_ATOL = 1e-3


def lc_small_run(dev):
    """The oracle loop-closure tracker of the CPU tests on device dev: its
    global-BA frames, its loop-edge batches and its poses."""
    from dpvo_tpu_torch import DPVO
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.runtime import dpvo as dpvo_mod
    from dpvo_tpu_torch.utils.synthetic import PlaneScene

    ht, wd, n_frames = 128, 160, 48
    scene = PlaneScene(ht=ht, wd=wd, n_frames=n_frames, depth=4.0, seed=5,
                       poses=loop_trajectory(n_frames))
    slam = DPVO(Config(**LC_SMALL_CFG), None, ht, wd, device=dev, seed=1)
    slam.oracle = scene_oracle(scene, 0.25, seed=78)
    slam._motion_probe = lambda: 1e9
    batches, real = [], dpvo_mod.edges_loop

    def loop(s):
        kk, jj = real(s)
        batches.append((s.n, kk, jj))
        return kk, jj

    dpvo_mod.edges_loop = loop
    try:
        for t in range(n_frames):
            slam(t, scene.render(t), scene.intrinsics.copy())
        poses, _ = slam.terminate()
    finally:
        dpvo_mod.edges_loop = real
    return sorted(slam.ran_global_ba), [b for b in batches if len(b[1])], poses


def phase_lc_small_parity():
    """Oracle loop closure on the card against the CPU: the same global-BA
    frames, the same loop edges, the poses within LC_SMALL_POSE_ATOL."""
    (rg, rb, rp), (dg, db, dp) = lc_small_run("cpu"), lc_small_run("cuda")
    same_edges = len(rb) == len(db) and all(
        a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
        for a, b in zip(rb, db))
    d_t = np.abs(dp[:, :3] - rp[:, :3]).max()
    d_q = np.abs(np.abs(dp[:, 3:]) - np.abs(rp[:, 3:])).max()
    print(f"oracle loop closure (48 frames, 128x160): global BA at frames {rg} (card {dg}), "
          f"loop-edge batches at {[b[0] for b in rb]} of {[len(b[1]) for b in rb]} edges "
          f"(card the same: {same_edges}); poses card vs CPU: positions {d_t:.3g}, "
          f"quaternions {d_q:.3g} (bound {LC_SMALL_POSE_ATOL})")
    if rg != dg or not rg or not same_edges or not np.isfinite(dp).all() \
            or max(d_t, d_q) > LC_SMALL_POSE_ATOL:
        raise AssertionError("oracle loop closure: card and CPU disagree")


# Phase 6: config/slam.yaml at full width on an out-and-back pan of LC_SPAN m
# at 4 m from the plane, LC_FRAMES frames: a keyframe moves ~0.15 m, so
# frames are kept and the run passes the 22-keyframe removal window and the
# 30-keyframe pair separation. Its H100 run (PR 7) kept 60 keyframes and
# ran 13 global-BA rounds of up to 119136 edges, 74304 of them from the
# inactive ring: with slam.yaml's capacities a longer run can reach
# E_INAC_MAX + E_MAX = 180224 edges, past GBA_EDGES_MAX = 172032, and stops
# on its assert (as the JAX tracker would).
LC_FRAMES, LC_SPAN = 140, 10.5


def phase_loop_closure(torch, kernels):
    """DPV-SLAM's proximity loop closure at full width: DPVO with
    config/slam.yaml and weights/vonet_synth.npz, 480x640. Counters zeroed
    before and read after each run. Two runs with loop closure must append
    loop edges, run global-BA rounds that launch segsum, give finite poses
    and equal bits; a third with LOOP_CLOSURE false gives the ATE beside.
    Prints each round's sizes and times, peak memory, the ATEs, and the
    device time of the largest round's solve. Returns (segsum launches in
    the first run's global-BA rounds, the stream: scene, frames, ground
    truth, and the ATE of the run without loop closure)."""
    from dpvo_tpu_torch import DPVO, load_config
    from dpvo_tpu_torch.ba import gba_sparse
    from dpvo_tpu_torch.lie import se3
    from dpvo_tpu_torch.runtime import dpvo as dpvo_mod
    from dpvo_tpu_torch.utils.synthetic import PlaneScene

    scene = PlaneScene(ht=480, wd=640, n_frames=LC_FRAMES, depth=4.0, seed=7,
                       poses=loop_trajectory(LC_FRAMES, LC_SPAN))
    frames = [scene.render(t) for t in range(LC_FRAMES)]
    gt = se3.inv(torch.as_tensor(scene.poses)).numpy()
    weights = os.path.join(ROOT, "weights", "vonet_synth.npz")

    def run(lc, keep_largest=False):
        cfg = load_config(os.path.join(ROOT, "config", "slam.yaml"),
                          overrides={"LOOP_CLOSURE": lc})
        gc.collect()  # an earlier run's tracker (its hooks hold it in a cycle)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        slam = DPVO(cfg, weights, 480, 640)
        rounds, batches, largest = [], [], {}
        real_loop, real_round, real_gba = dpvo_mod.edges_loop, slam._run_global_ba, \
            slam.steps._global_ba

        def loop(s):
            kk, jj = real_loop(s)
            if len(kk):
                batches.append((s.n, len(kk)))
            return kk, jj

        def solve(state, ges, pos, ninac, t0, nfree, idx):
            if keep_largest and len(idx["p1"]) >= largest.get("KP", -1):
                # the solve's arguments (the state's buffers copied), to time it alone
                args, kw = slam.steps._gba_inputs(state, ges, pos, ninac, t0, nfree, idx)
                args = (args[0].clone(), args[1], args[2].clone()) + args[3:]
                largest.update(KP=len(idx["p1"]), inputs=(args, kw))
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            before = kernels.LAUNCHES["segsum"]
            a.record()
            real_gba(state, ges, pos, ninac, t0, nfree, idx)
            b.record()
            b.synchronize()
            rounds[-1].update(Eg=ges["count"], ninac=ninac, nfree=nfree, depths=ges["n_depths"],
                              F=len(idx["fk"]), KP=len(idx["p1"]),
                              frozen=int((~idx["fkeep"]).sum()), ms=a.elapsed_time(b),
                              segsum=kernels.LAUNCHES["segsum"] - before)

        def timed_round():
            t0 = time.perf_counter()
            rounds.append(dict(n=slam.n))
            real_round()
            torch.cuda.synchronize()
            rounds[-1]["host_ms"] = (time.perf_counter() - t0) * 1e3

        dpvo_mod.edges_loop, slam._run_global_ba, slam.steps._global_ba = loop, timed_round, solve
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            for t, image in enumerate(frames):
                slam(t, image, scene.intrinsics.copy())
            in_run = sorted(slam.ran_global_ba)
            poses, _ = slam.terminate()
            torch.cuda.synchronize()
        finally:
            dpvo_mod.edges_loop = real_loop
        # the tracker goes with this function: the next run's peak is its own
        return dict(n=slam.n, poses=poses, rounds=rounds, batches=batches, in_run=in_run,
                    launches=dict(kernels.LAUNCHES), sec=time.perf_counter() - t0,
                    peak=(torch.cuda.max_memory_allocated() - base) / 2**30, largest=largest,
                    ate=ate_rmse(poses[:, :3], gt[:, :3]),
                    dvec=slam.state.dvec[:slam.m].cpu())

    on = run(True, keep_largest=True)
    for r in on["rounds"]:
        print("global BA at keyframe {n}: Eg {Eg} ({ninac} inactive), nfree {nfree}, depth "
              "variables {depths}, F {F}, KP {KP}, frozen entries {frozen}; {ms:.3f} ms (event "
              "pair around the solve), {host_ms:.1f} ms with the host's sparsity build; segsum "
              "launches {segsum}".format(**r))
    print(f"loop closure: {LC_FRAMES} frames in {on['sec']:.1f} s, keyframes {on['n']}, "
          f"loop-edge batches (keyframe, edges) {on['batches']}, global BA in-run at "
          f"{on['in_run']}, rounds {len(on['rounds'])}, peak device memory {on['peak']:.3f} "
          f"GiB (above what earlier phases left allocated), launches { {k: v for k, v in on['launches'].items() if v} }")
    with segsum_runs(torch, "phase 6, the second loop-closure run"):
        again = run(True)
    off = run(False)
    same = (np.array_equal(on["poses"], again["poses"]) and torch.equal(on["dvec"], again["dvec"])
            and on["in_run"] == again["in_run"] and on["batches"] == again["batches"])
    path = np.linalg.norm(np.diff(gt[:, :3], axis=0), axis=1).sum()
    print(f"loop closure: a second run bit for bit equal (poses, inverse depths, rounds, "
          f"batches): {same} (largest pose difference "
          f"{np.abs(again['poses'] - on['poses']).max():.3g})")
    print(f"loop closure: ATE {on['ate']:.5f} with LOOP_CLOSURE, {off['ate']:.5f} without "
          f"({off['n']} keyframes, peak device memory {off['peak']:.3f} GiB, "
          f"{off['sec']:.1f} s); path length {path:.3f}")
    gba_segsum = sum(r["segsum"] for r in on["rounds"])
    if not on["batches"] or not on["rounds"] or gba_segsum == 0 or not same \
            or not np.isfinite(on["poses"]).all() or on["poses"].shape != (LC_FRAMES, 7):
        raise AssertionError("loop closure: no loop edges, no global BA, no segsum in its "
                             "rounds, non-finite poses or two runs that differ")
    big = on["largest"]
    solve = lambda: gba_sparse.gba(*big["inputs"][0], **big["inputs"][1])
    stats = dict(ms=cuda_ms(solve, 5), device_ms=device_ms(solve, 5, mixed=True), KP=big["KP"])
    print("loop closure: the largest round's solve (KP {KP}) timed alone: {ms:.3f} ms (event "
          "pair), device time {device_ms:.3f} ms".format(**stats))
    return gba_segsum, dict(scene=scene, frames=frames, gt=gt, off_ate=off["ate"],
                            lc_poses=on["poses"], lc_rounds=on["rounds"])


# Phase 7's retrieval threshold. The retrieval scores a frame pair by the mean
# best-match hamming similarity: a random 256-bit descriptor's nearest among
# a few hundred others differs in ~100 bits, so unrelated frames score ~0.6,
# and a revisit's shared points (4 flipped bits each) pull it toward 0.97.
# default.yaml's LOOP_RETR_THRESH 0.04 (a DBoW-scale value) passes every
# query: the first candidate then fires at keyframe RADIUS + 2 onto an
# unrelated frame, and its suppression window (RADIUS keyframes) hides the
# real revisit. 0.8 lies between the two.
CLC_RETR_THRESH = 0.8


def phase_classic_lc(torch, kernels, stream):
    """Classic loop closure at full width on phase 6's stream: DPVO with
    config/default.yaml plus CLASSIC_LOOP_CLOSURE (LOOP_RETR_THRESH
    CLC_RETR_THRESH) and weights/vonet_synth.npz, 480x640, its keypoints from
    SceneKeypoints (the card's machine has no OpenCV); everything after
    detection is the port's: native scoring and matching, the triplet BA on
    segsum and the SPD kernel, RANSAC, the PGO on segsum and Cholesky, the
    correction. Two inline runs (asynchronous=False) must find a candidate,
    apply a correction, launch segsum in the triplet BAs and the PGO and the
    SPD kernel in the triplet BAs (counters zeroed before the first run, read
    after), give finite poses and equal bits; one run with the worker thread
    and the PGO executor must apply a correction. Prints the retrieval
    frames, candidates, RANSAC fits, corrections (with the keyframe ATE just
    before and after each), each triplet BA's and PGO's time and the PGO's
    size and LM iterations, the peak memory and the ATE beside phase 6's run
    without loop closure; then one triplet BA and one PGO of the first run
    timed alone. Returns the launches of each call site in the first run."""
    from dpvo_tpu_torch import DPVO, load_config
    from dpvo_tpu_torch.lie import se3, so3
    from dpvo_tpu_torch.slam import long_term, pgo

    scene, frames, gt = stream["scene"], stream["frames"], stream["gt"]
    cfg = load_config(os.path.join(ROOT, "config", "default.yaml"),
                      overrides={"CLASSIC_LOOP_CLOSURE": True,
                                 "LOOP_RETR_THRESH": CLC_RETR_THRESH})
    weights = os.path.join(ROOT, "weights", "vonet_synth.npz")
    detect = SceneKeypoints(scene, frames)
    real_tri, real_pgo, real_step = long_term._triplet_structure_ba, pgo.apply_loop_closure, \
        pgo._pgo_step
    real_ransac = long_term.ransac_umeyama

    def timed(fn, log, kinds):
        """fn with each call's event-pair time, host time, the launches of
        `kinds` it made and its arguments logged."""
        def call(*args, **kw):
            before = {k: kernels.LAUNCHES[k] for k in kinds}
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            out = fn(*args, **kw)
            b.record()
            b.synchronize()
            log.append(dict(ms=a.elapsed_time(b), host_ms=(time.perf_counter() - t0) * 1e3,
                            args=(args, kw), **{k: kernels.LAUNCHES[k] - before[k] for k in kinds}))
            return out
        return call

    def run(asynchronous):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        slam = DPVO(cfg, weights, 480, 640, detect=detect)
        if not asynchronous:
            slam.long_term_lc.close()
            slam.long_term_lc = long_term.LongTermLoopClosure(cfg, slam, asynchronous=False,
                                                              detect=detect)
        lc = slam.long_term_lc
        tri, pgos, steps, cands, fixes, fits, fit_R = [], [], [], [], [], [], []
        apply = slam.apply_pgo_result

        def kf_ate():  # the live keyframes against their frames' ground truth
            p = se3.inv(torch.as_tensor(slam.poses_np())).numpy()
            return ate_rmse(p[:, :3], gt[np.asarray(slam.tstamps[:slam.n]), :3])

        def against_truth(q, rr):
            """The fitted loop Sim(3) (cam-q points to cam-rr points, tracker
            units) beside the truth: s against the ratio of the tracker's
            scale at rr and at q (keyframe baselines to the neighbours against
            the ground truth's), R against the true relative rotation."""
            est = torch.as_tensor(slam.poses_np())
            true = torch.as_tensor(scene.poses[np.asarray(slam.tstamps[:slam.n])])
            step = lambda P, a, b: se3.mul(P[b], se3.inv(P[a]))[:3].norm().item()
            scale = lambda k: np.mean([step(est, k, j) / step(true, k, j)
                                       for j in (k - 1, k + 1) if 0 <= j < slam.n])
            R_true = (so3.to_matrix(true[rr, 3:]) @ so3.to_matrix(true[q, 3:]).T).numpy()
            cos = (np.trace(fit_R[-1][0].T @ R_true) - 1) / 2
            return dict(s_true=scale(rr) / scale(q), deg=np.degrees(np.arccos(np.clip(cos, -1, 1))))

        def applied(corrected):  # each correction with the keyframe ATE around it
            (_, _, ii, jj), _ = pgos[-1]["args"]
            before, truth = kf_ate(), against_truth(int(ii[0]), int(jj[0]))
            apply(corrected)
            fixes.append(dict(m=len(corrected), before=before, after=kf_ate(), s_fit=fit_R[-1][1],
                              s=(float(corrected[:, 7].min()), float(corrected[:, 7].max())),
                              **truth))

        slam.apply_pgo_result = applied
        package = lc._package
        lc._package = lambda cand: (cands.append(cand), package(cand))[1]
        long_term._triplet_structure_ba = timed(real_tri, tri, ("segsum", "spd_solve"))
        timed_pgo = timed(real_pgo, pgos, ("segsum",))

        def pgo_call(*a, **k):  # with its LM iterations (two steps each)
            s0 = len(steps)
            out = timed_pgo(*a, **k)
            pgos[-1]["lm"] = (len(steps) - s0) // 2
            return out

        pgo.apply_loop_closure = pgo_call
        pgo._pgo_step = lambda *a, **k: (steps.append(1), real_step(*a, **k))[1]

        def ransac(X, Y, *a, **k):  # each loop's Sim(3) fit: points, inliers, scale
            fit = real_ransac(X, Y, *a, **k)
            fits.append((len(X),) + ((int(fit[3].sum()), float(fit[2])) if fit else (0, None)))
            if fit:
                fit_R.append((fit[0], float(fit[2])))
            return fit

        long_term.ransac_umeyama = ransac
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            for t, image in enumerate(frames):
                slam(t, image, scene.intrinsics.copy())
            poses, _ = slam.terminate()
            torch.cuda.synchronize()
        finally:
            long_term._triplet_structure_ba, pgo.apply_loop_closure, pgo._pgo_step = \
                real_tri, real_pgo, real_step
            long_term.ransac_umeyama = real_ransac
        return dict(poses=poses, n=slam.n, frames=lc.retrieval.n_frames(), cands=cands,
                    applied=list(lc.applied), tri=tri, pgo=pgos, fixes=fixes, fits=fits,
                    launches=dict(kernels.LAUNCHES), sec=time.perf_counter() - t0,
                    peak=(torch.cuda.max_memory_allocated() - base) / 2**30,
                    ate=ate_rmse(poses[:, :3], gt[:, :3]))

    inline = run(False)
    for i, r in enumerate(inline["tri"]):
        print(f"classic loop closure: triplet BA {i}: {r['ms']:.3f} ms (event pair), host "
              f"{r['host_ms']:.3f} ms; segsum launches {r['segsum']}, spd_solve {r['spd_solve']}")
    for i, r in enumerate(inline["pgo"]):
        (poses_in, C, ii, jj), _ = r["args"]
        print(f"classic loop closure: PGO {i}: n {len(poses_in)}, R {len(poses_in) - 1 + len(C)} "
              f"constraints, loop {int(ii[0])} -> {int(jj[0])}, LM iterations {r['lm']}; "
              f"{r['ms']:.3f} ms (event pair), host {r['host_ms']:.3f} ms; segsum launches "
              f"{r['segsum']}")
    print(f"classic loop closure: RANSAC-Umeyama fits (points, inliers, scale) {inline['fits']}")
    for r in inline["fixes"]:
        print("classic loop closure: a correction of {m} keyframes (scales {s[0]:.4f}-{s[1]:.4f}):"
              " keyframe ATE {before:.5f} before it, {after:.5f} after; its loop's fitted scale "
              "{s_fit:.4f} against the tracker's scale ratio {s_true:.4f} between the two ends "
              "(neighbour baselines against the truth), its rotation {deg:.3f} deg from the true "
              "relative rotation".format(**r))
    print(f"classic loop closure: {len(frames)} frames in {inline['sec']:.1f} s, keyframes "
          f"{inline['n']}, retrieval frames {inline['frames']}, candidates {inline['cands']}, "
          f"corrections applied at {inline['applied']}, peak device memory "
          f"{inline['peak']:.3f} GiB, launches "
          f"{ {k: v for k, v in inline['launches'].items() if v} }")
    with segsum_runs(torch, "phase 7, the second inline run"):
        again = run(False)
    same = np.array_equal(inline["poses"], again["poses"]) and inline["applied"] == again["applied"]
    print(f"classic loop closure: a second inline run bit for bit equal (poses, corrections): "
          f"{same} (largest pose difference "
          f"{np.abs(again['poses'] - inline['poses']).max():.3g})")
    threaded = run(True)
    print(f"classic loop closure, worker thread and PGO executor: corrections applied at "
          f"{threaded['applied']}, candidates {threaded['cands']}, {threaded['sec']:.1f} s, ATE "
          f"{threaded['ate']:.5f}")
    print(f"classic loop closure: ATE {inline['ate']:.5f} inline, {stream['off_ate']:.5f} "
          f"without loop closure (phase 6)")
    sites = dict(segsum_triplet=sum(r["segsum"] for r in inline["tri"]),
                 spd_triplet=sum(r["spd_solve"] for r in inline["tri"]),
                 segsum_pgo=sum(r["segsum"] for r in inline["pgo"]))
    if not inline["cands"] or not inline["applied"] or min(sites.values()) == 0 or not same \
            or not threaded["applied"] or not all(np.isfinite(r["poses"]).all() and
                                                  r["poses"].shape == (len(frames), 7)
                                                  for r in (inline, again, threaded)):
        raise AssertionError(f"classic loop closure: no candidate or correction, kernels not "
                             f"launched at their call sites ({sites}), two inline runs that "
                             "differ, or bad poses")
    # one triplet BA and one PGO of the first run, timed alone
    for name, fn, r in (("triplet BA", real_tri, inline["tri"][0]),
                        ("PGO", real_pgo, inline["pgo"][0])):
        args, kw = r["args"]
        call = lambda: fn(*args, **kw)
        print(f"classic loop closure: the first {name} timed alone: {cuda_ms(call, 3, 1):.3f} ms "
              f"(event pair), device time {device_ms(call, 1, 1, mixed=True):.3f} ms")
    return sites


def _segsum_site():
    """The port's function that called the segment sum: "file:function" of
    the innermost frame in dpvo_tpu_torch outside ba/segsum.py."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename.replace(os.sep, "/")
        if "/dpvo_tpu_torch/" in path and not path.endswith("/ba/segsum.py"):
            return f"{path.rsplit('/dpvo_tpu_torch/', 1)[1]}:{f.f_code.co_name}"
        f = f.f_back
    return "elsewhere"


# the global BA's reductions, whose runs are thousands of rows long
LONG_RUN_SITES = ("ba/gba_sparse.py:",)


@contextlib.contextmanager
def segsum_runs(torch, label):
    """While open, every segment-sum kernel call also records, by call site,
    its longest run of ids in [0, Md) and how far into a run its last
    nonzero row lies (padded edges carry exact zeros, which change no bit of
    a sum); on the device, without a sync. On leaving, prints them beside
    ba/segsum.CHUNK and raises where a site other than the global BA's has
    a nonzero row past the first CHUNK of its run: there the chunked order
    would differ from the sequential sum that earlier builds took."""
    from dpvo_tpu_torch.ba import segsum

    sites, real = {}, segsum._segment_sum_kernel

    def watched(payload, kd, order, Md):
        site = _segsum_site()
        n, longest, live = sites.get(site, (0, 0, 0))
        if payload.shape[0]:
            o = order.long()
            ids = kd[o]
            rank = torch.arange(1, ids.shape[0] + 1, device=ids.device) - torch.searchsorted(ids,
                                                                                               ids)
            keep = (ids >= 0) & (ids < Md)
            nonzero = (payload != 0).any(1)[o]
            longest = torch.maximum(torch.as_tensor(longest, device=ids.device),
                                    torch.where(keep, rank, 0).max())
            live = torch.maximum(torch.as_tensor(live, device=ids.device),
                                 torch.where(keep & nonzero, rank, 0).max())
        sites[site] = (n + 1, longest, live)
        return real(payload, kd, order, Md)

    segsum._segment_sum_kernel = watched
    try:
        yield
    finally:
        segsum._segment_sum_kernel = real
    rows = {site: (n, int(a), int(b)) for site, (n, a, b) in sorted(sites.items())}
    print(f"segsum runs, {label} (CHUNK {segsum.CHUNK}): " + "; ".join(
        f"{site} {n} calls, longest run {a} rows, its last nonzero row at {b}"
        for site, (n, a, b) in rows.items()))
    bad = [site for site, (_, _, b) in rows.items()
           if b > segsum.CHUNK and not site.startswith(LONG_RUN_SITES)]
    if not rows or bad:
        raise AssertionError(f"segsum runs, {label}: no call, or nonzero rows past CHUNK at the "
                             f"short-run sites {bad}")


# Phase 8: the train entry point at full width (Config(): 80 patches a frame,
# DIM 384, FDIM 128, bf16) from weights/vonet_synth.npz, the recipe's clip
# (15 frames, 18 unroll steps) at 480x640; then the fixed-clip overfit check
# at tests/test_train.py's tiny configuration (64x96, 5 frames, 4 steps)
TRAIN_STEPS = 3
OVERFIT_STEPS = 20


def phase_training(torch, kernels):
    """The training path through its entry points: python -m
    dpvo_tpu_torch.apps.train's main() for TRAIN_STEPS steps, one
    structure-only step and one full step through make_train_step at the
    same shape (timed by phase, the full one also profiled), then
    OVERFIT_STEPS steps on one fixed small clip. Returns the launches of
    the entry point's run."""
    import shutil

    from dpvo_tpu_torch.apps import train as train_app
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.data.factory import SyntheticClipDataset
    from dpvo_tpu_torch.runtime.weights import load_networks, load_npz
    from dpvo_tpu_torch.train import make_optimizer, make_train_step

    outdir = os.path.join(ROOT, "runs", "chip_smoke_train")  # git-ignored
    shutil.rmtree(outdir, ignore_errors=True)
    npz = os.path.join(ROOT, "weights", "vonet_synth.npz")
    argv = ["--dataset", "synthetic", "--ht", "480", "--wd", "640", "--n_frames", "15",
            "--unroll", "18", "--batch", "1", "--init_npz", npz, "--steps", str(TRAIN_STEPS),
            "--log_every", "1", "--npz_every", str(TRAIN_STEPS), "--ckpt_every", "1000000",
            "--name", "smoke", "--outdir", outdir]
    print(f"training: python -m dpvo_tpu_torch.apps.train {' '.join(argv)}")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    nets, opt_state = train_app.main(argv)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    with open(os.path.join(outdir, "runs", "smoke", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    print(f"training: {TRAIN_STEPS} steps in {sec:.1f} s (clip rendering and the first "
          f"step's set-up included), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    for r in rows:
        print("training: step {step}: loss {loss:.5g} gnorm {gnorm:.5g} flow {flow:.4g} tr "
              "{tr:.4g} ro {ro:.4g} px1 {px1:.4g} ({steps_per_s:.3f} steps/s)".format(**r))
    snap = os.path.join(outdir, "checkpoints", f"smoke_{TRAIN_STEPS:06d}.npz")
    cfg = Config()
    start = load_networks(cfg, npz).state_dict()
    moved = sum(not torch.equal(v.cpu(), start[k]) for k, v in nets.state_dict().items())
    loaded = load_networks(cfg, snap).state_dict()
    same = all(torch.equal(v.cpu(), loaded[k]) for k, v in nets.state_dict().items())
    need = ("corr", "corr_bwd", "segsum", "segsum_bf16", "spd_solve")
    if len(rows) != TRAIN_STEPS or not all(np.isfinite(r["loss"]) and np.isfinite(r["gnorm"])
                                          and r["gnorm"] > 0 for r in rows) \
            or moved == 0 or not same or min(launches[k] for k in need) == 0 \
            or len(load_npz(snap)) != len(start):
        raise AssertionError(f"training: a loss or gradient norm not finite or zero, the "
                             f"parameters unmoved ({moved} moved), the npz snapshot not the "
                             f"trained weights ({same}), or a kernel of {need} not launched")
    print(f"training: {moved} of {len(start)} parameter tensors moved; the npz snapshot loads "
          f"into load_networks with the trained weights: {same}")

    # one structure-only and one full step through make_train_step, timed by phase
    clip = SyntheticClipDataset(n_frames=15, ht=480, wd=640, seed=5).sample()
    batch = {k: v[None] for k, v in zip(("images", "poses", "disps", "intrinsics"), clip)}
    tx, _ = make_optimizer(lr=8e-5, total_steps=240000)
    step = make_train_step(cfg, tx, STEPS=18)
    step.timed = True
    gen = torch.Generator().manual_seed(3)
    for so in (True, False):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        nets, opt_state, m = step(nets, opt_state, batch, gen, structure_only=so)
        m = {k: float(v) for k, v in m.items()}
        wall = time.perf_counter() - t0
        print("training: a {} step: {:.3f} s (forward {forward:.3f}, backward {backward:.3f}, "
              "optimizer {optimizer:.3f}), peak device memory {:.3f} GiB; loss {:.5g} gnorm "
              "{:.5g}".format("structure-only" if so else "full", wall,
                              torch.cuda.max_memory_allocated() / 2**30, m["loss"], m["gnorm"],
                              **step.times))
        if not (np.isfinite(m["loss"]) and np.isfinite(m["gnorm"]) and m["gnorm"] > 0):
            raise AssertionError("training: a step through make_train_step gave a non-finite "
                                 "loss or a zero gradient")
    from torch.profiler import ProfilerActivity, profile

    step.timed = False
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(nets, opt_state, batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _print_profile(prof, wall, 1, top=15, unit="train step")

    # two full steps from one state and one draw: printed, not gated (the
    # unroll keeps other nondeterministic sums, ROADMAP.md section 3)
    runs = []
    with segsum_runs(torch, "phase 8, two full steps from one state"):
        for _ in range(2):
            n2, s2, m2 = step(copy.deepcopy(nets), copy.deepcopy(opt_state), batch,
                              torch.Generator().manual_seed(4))
            runs.append((float(m2["loss"]), {k: torch.zeros_like(p) if p.grad is None else p.grad
                                             for k, p in n2.named_parameters()},
                         n2.state_dict()))
    (la, ga, pa), (lb, gb, pb) = runs
    print(f"training: two steps from one state and one draw: losses {la!r} {lb!r}; gradient "
          f"leaves bit for bit equal {sum(torch.equal(v, gb[k]) for k, v in ga.items())} of "
          f"{len(ga)}, parameter tensors {sum(torch.equal(v, pb[k]) for k, v in pa.items())} of "
          f"{len(pa)}")
    del runs, ga, gb, pa, pb

    t0 = time.perf_counter()
    with segsum_runs(torch, "phase 8, the fixed-clip overfit"):
        losses = fixed_clip_overfit(torch)
    first, last = float(np.median(losses[:5])), float(np.median(losses[-5:]))
    print(f"training: fixed-clip overfit ({OVERFIT_STEPS} steps in "
          f"{time.perf_counter() - t0:.1f} s): median loss of the first 5 steps {first:.5g}, of "
          f"the last 5 {last:.5g} ({last / first:.3f}x); losses {[round(x, 4) for x in losses]}")
    if not (np.isfinite(losses).all() and last < 0.7 * first):
        raise AssertionError("training: the fixed-clip loss did not fall below 0.7x its start")
    return launches


def fixed_clip_overfit(torch, steps=OVERFIT_STEPS):
    """steps training steps on the card on one fixed small clip
    (tests/test_train.py's tiny configuration in f32, constant-lr AdamW),
    through make_train_step; returns the losses. Two runs part at the first
    step, in the encoders' gradients: cuDNN's convolution backward picks a
    nondeterministic algorithm at these shapes (with
    torch.backends.cudnn.deterministic they repeat; scripts/segsum_ab.py
    overfit)."""
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.runtime.weights import init_networks
    from dpvo_tpu_torch.train import make_train_step
    from dpvo_tpu_torch.train.step import Optimizer
    from dpvo_tpu_torch.utils.synthetic import PlaneScene

    small = Config(PATCHES_PER_FRAME=4, DIM=32, FDIM=16, MIXED_PRECISION=False)
    HT, WD, F = 64, 96, 5
    scene = PlaneScene(ht=HT, wd=WD, n_frames=F, depth=4.0, seed=3)
    ys, xs = np.mgrid[0:HT, 0:WD]
    fixed = dict(images=np.stack([scene.render(t) for t in range(F)])[None].astype(np.float32),
                 poses=scene.poses[None].astype(np.float32),
                 disps=np.stack([scene.inv_depth(t, xs.astype(np.float64), ys.astype(np.float64))
                                 for t in range(F)])[None].astype(np.float32),
                 intrinsics=scene.intrinsics[None].astype(np.float32))
    tiny = init_networks(small, torch.Generator().manual_seed(0)).to(torch.device("cuda"))
    otx = Optimizer(lambda count: 3e-4, clip=10.0, weight_decay=1e-4)
    ost = otx.init({k: p.detach() for k, p in tiny.named_parameters()})
    ostep = make_train_step(small, otx, STEPS=4)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(steps):
        tiny, ost, m = ostep(tiny, ost, fixed, gen)
        losses.append(float(m["loss"]))
    return losses


# Phase 9. Bound on the largest difference between the exported tracker's
# poses and the eager tracker's over the 40 frames (camera-to-world, every
# component, quaternions up to sign); ATE bound as phase 4 holds each CORR_IMPL.
# Measured 0 on an H100: the exported programs issue the eager modules'
# kernels at the eager shapes, and the card's tracker is deterministic, so
# the two trajectories are held bit for bit.
EXPORT_POSE_ATOL = 0.0
EXPORT_FRAMES = 40
PROTOCOL_FRAMES = 30


def _count_segsum(fn):
    """fn wrapped to add up the segment-sum launches made inside its calls."""
    from dpvo_tpu_torch import kernels

    def counted(*args, **kw):
        before = kernels.LAUNCHES["segsum"] + kernels.LAUNCHES["segsum_bf16"]
        out = fn(*args, **kw)
        counted.launches += kernels.LAUNCHES["segsum"] + kernels.LAUNCHES["segsum_bf16"] - before
        return out

    counted.launches = 0
    return counted


def _pose_diff(a, b):
    """Largest component difference of two [T, 7] (t, q) trajectories, the
    quaternions taken up to sign."""
    sgn = np.sign(np.sum(a[:, 3:] * b[:, 3:], axis=1, keepdims=True))
    return float(max(np.abs(a[:, :3] - b[:, :3]).max(), np.abs(a[:, 3:] - sgn * b[:, 3:]).max()))


def phase_export_apps(torch, kernels, smi):
    """Phase 9: export, the demo, the synthetic evaluation and the protocol
    at full width (config/default.yaml, weights/vonet_synth.npz, 480x640,
    phase 3's scene), writing into a temporary directory. Returns the
    segment-sum launches inside the exported update."""
    import tempfile

    from dpvo_tpu_torch import DPVO, load_config
    from dpvo_tpu_torch.apps import demo, eval_synthetic, export_network
    from dpvo_tpu_torch.deploy.export import load_exported
    from dpvo_tpu_torch.eval.protocol import evaluate_sequences
    from dpvo_tpu_torch.lie import se3

    ht, wd = 480, 640
    cfg_path = os.path.join(ROOT, "config", "default.yaml")
    weights = os.path.join(ROOT, "weights", "vonet_synth.npz")
    cfg = load_config(cfg_path)
    scene, frames = render_main_scene(EXPORT_FRAMES)
    gt = se3.inv(torch.as_tensor(scene.poses[:EXPORT_FRAMES])).numpy()
    rng = np.random.default_rng(0)
    M, h, w = cfg.PATCHES_PER_FRAME, ht // cfg.RES, wd // cfg.RES
    draws = [(np.stack([rng.integers(1, w - 1, M), rng.integers(1, h - 1, M)], -1)
              .astype(np.float32), rng.uniform(size=M).astype(np.float32))
             for _ in range(EXPORT_FRAMES)]

    def track(slam):
        ms = []
        for t in range(EXPORT_FRAMES):
            t0 = time.perf_counter()
            slam(t, frames[t], scene.intrinsics.copy())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        poses, _ = slam.terminate()
        return poses, float(np.median(ms[15:]))

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 1. export, reload, the exported tracker against the eager one ----
        exp_dir = os.path.join(tmp, "exported")
        t0 = time.perf_counter()
        export_network.main(["--network", weights, "--config", cfg_path, "--outdir", exp_dir,
                             "--ht", str(ht), "--wd", str(wd)])
        export_s = time.perf_counter() - t0
        net = load_exported(exp_dir)
        nodes = sum("segment_sum" in str(n.target) for n in net.update_program.graph.nodes)
        print(f"export: {sorted(os.listdir(exp_dir))} in {export_s:.1f} s; update.pt2 holds "
              f"{nodes} dpvo_tpu_torch::segment_sum nodes; meta {net.meta}")
        if nodes == 0:
            raise AssertionError("export: the update program lost the segment-sum op")
        del net
        runs = {"eager": [], "exported": []}
        launches = []
        for name, network in (("eager", weights), ("exported", exp_dir)) * 2:
            slam = DPVO(cfg, network, ht, wd, draws=lambda f: draws[f])
            if name == "exported":
                counted = _count_segsum(slam.steps.exported._update)
                slam.steps.exported._update = counted
            runs[name].append(track(slam))
            if name == "exported":
                launches.append(counted.launches)
            del slam
            gc.collect()
        p_eager, p_exp = runs["eager"][0][0], runs["exported"][0][0]
        ate_eager, ate_exp = ate_rmse(p_eager[:, :3], gt[:, :3]), ate_rmse(p_exp[:, :3], gt[:, :3])
        diff = max(_pose_diff(p, p_eager) for p, _ in runs["eager"][1:] + runs["exported"])
        ms = {k: [f"{t:.3f}" for _, t in v] for k, v in runs.items()}
        print(f"export: exported and eager trackers over {EXPORT_FRAMES} frames, alternating "
              f"(eager, exported, eager, exported): largest pose difference from the first "
              f"eager run {diff:.6g} (bound {EXPORT_POSE_ATOL}), ATE {ate_exp:.6f} (eager "
              f"{ate_eager:.6f}), median frame ms over frames 15-{EXPORT_FRAMES - 1}: exported "
              f"{ms['exported']}, eager {ms['eager']}; segment-sum launches inside the "
              f"exported update: {launches} ({smi})")
        if min(launches) == 0:
            raise AssertionError("export: the exported update launched no segment sum")
        if not np.isfinite(p_exp).all() or ate_exp > IMPL_ATE_FACTOR * ate_eager:
            raise AssertionError("export: the exported tracker's ATE is beyond its bound")
        if diff > EXPORT_POSE_ATOL:
            raise AssertionError(f"export: the exported tracker's poses are {diff:.3g} from "
                                 "the eager tracker's")

        # ---- 2. the demo with every writer ----
        args = demo.parse_args(["--imagedir", "-", "--calib", "-", "--network", weights,
                                "--config", cfg_path, "--save_trajectory", "--save_ply",
                                "--save_colmap", "--outdir", tmp, "--name", "phase9"])
        out = demo.run(args, ((t, frames[t], scene.intrinsics.copy())
                              for t in range(EXPORT_FRAMES)))
        tum = np.loadtxt(os.path.join(tmp, "saved_trajectories", "phase9.txt"))
        pts, clr = out["slam"].point_cloud()
        finite = int((np.isfinite(pts).all(1) & (np.abs(pts) < 1e6).all(1)).sum())
        with open(os.path.join(tmp, "phase9.ply")) as f:
            ply = f.read().split("end_header\n")
        n_vertex = int(ply[0].split("element vertex ")[1].split()[0])
        cdir = os.path.join(tmp, "colmap_saves", "phase9")
        with open(os.path.join(cdir, "cameras.txt")) as f:
            cam = f.read().split()
        with open(os.path.join(cdir, "images.txt")) as f:
            images = [ln.split() for ln in f if ln.strip()]
        points3d = np.loadtxt(os.path.join(cdir, "points3D.txt"), ndmin=2)
        print(f"demo: {out['n_frames']} frames at {out['fps']:.3f} frames/s after the first "
              f"{demo.WARMUP}, peak device memory {out['peak_mib']:.1f} MiB ({smi}); TUM rows "
              f"{len(tum)}, PLY vertices {n_vertex} of {finite} finite points, colours "
              f"nonzero {int(clr.any(axis=1).sum())} of {len(clr)}, COLMAP camera {cam[1:4]}, "
              f"{len(images)} images, {len(points3d)} points")
        if len(tum) != EXPORT_FRAMES or tum.shape[1] != 8 or not np.isfinite(tum).all():
            raise AssertionError("demo: the TUM trajectory has not one finite row per frame")
        if n_vertex != finite or len(ply[1].splitlines()) != finite or not clr.any():
            raise AssertionError("demo: the PLY disagrees with point_cloud() or has no colour")
        if (cam[1:4] != ["PINHOLE", str(wd), str(ht)] or len(images) != out["slam"].n
                or points3d.shape != (finite, 8)):
            raise AssertionError("demo: the COLMAP model does not parse to the tracker's state")
        del out
        gc.collect()

    # ---- 3. the synthetic evaluation ----
    res = eval_synthetic.main(["--network", weights, "--config", cfg_path, "--ht", str(ht),
                               "--wd", str(wd), "--scenes", "2", "--trials", "1", "--n_frames",
                               str(EXPORT_FRAMES), "--depth", "4.0", "--tstep", "0.06"])
    ates = [e for v in res["scenes"].values() for e in v["trials"]]
    if not res["summary"]["all_initialized"] or not np.isfinite(ates).all():
        raise AssertionError("eval_synthetic: a scene did not initialize or an ATE is not finite")

    # ---- 4. the protocol: two trials over the plane scene ----
    seq = {"plane": lambda: ((float(t), frames[t], scene.intrinsics.copy())
                             for t in range(PROTOCOL_FRAMES))}
    truth = {"plane": (np.arange(PROTOCOL_FRAMES, dtype=np.float64), gt[:PROTOCOL_FRAMES, :3])}
    ev = evaluate_sequences(cfg, weights, seq, truth, trials=2, title="phase 9")
    trials = ev["trials"]["plane"]
    auc = float(np.maximum(1.0 - np.array(trials), 0.0).mean())
    if ev["avg"] != float(np.median(trials)) or ev["auc"] != auc or len(trials) != 2:
        raise AssertionError("protocol: AVG or AUC differs from its recomputation")
    return launches[0]


# Phase 10: GRADIENT_BIAS, the parallel layer and Timer. The exported
# GRADIENT_BIAS tracker runs this many of phase 3's frames; the centroid
# selection is held card against CPU on the first GB_SELECT_FRAMES frames.
GB_EXPORT_FRAMES = 10
GB_SELECT_FRAMES = 5
# alternating runs that price the selection (a patchify under each strategy)
# and the one-rank mesh (a global-BA round through gba and dist_gba)
COST_REPS = 20


def _launched(kernels):
    return {k: v for k, v in kernels.LAUNCHES.items() if v}


def phase_gradient_bias_parallel(torch, kernels, smi, main_ate, stream):
    """Phase 10 (GRADIENT_BIAS, the parallel layer, Timer), each item gated
    unless printed only:
    1. config/default.yaml with CENTROID_SEL_STRAT GRADIENT_BIAS, phase 3's
       weights and 40-frame scene: initialized, culled, finite poses; corr,
       segsum and SPD launched; on the first GB_SELECT_FRAMES frames the
       card's selected centroids equal the CPU selection from the same bf16
       image and candidates (torch.equal). The ATE beside phase 3's RANDOM
       ATE and a ms/frame smoke reading are printed; Timer times the frame
       loop and its all_times are printed; the patchify of one frame under
       RANDOM and under GRADIENT_BIAS, COST_REPS times each in turn, prices
       the selection (printed).
    2. That configuration exported (export_network.main) and tracked on
       GB_EXPORT_FRAMES frames: poses bit for bit the eager tracker's.
    3. A world-size-1 NCCL group and make_mesh(1, 1): phase 6's slam.yaml
       stream through DPVO(mesh=): global-BA rounds through dist_gba that
       launch segsum, poses bit for bit phase 6's run without a mesh. The
       last round's global BA through gba and through dist_gba, COST_REPS
       times each in turn, prices the one-rank mesh (printed).
    4. dist_ba_delta at item 1's last sliding-window BA (the main path's
       shape): bit for bit ba_delta, the SPD kernel launched.
    5. One training step through apps/train.py --mesh 1,1 at phase 8's
       shape: a finite loss; its parameters' difference from a step without
       a mesh on the same clip and draws printed.
    Returns the launches of each item."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from dpvo_tpu_torch import DPVO, load_config
    from dpvo_tpu_torch.apps import export_network
    from dpvo_tpu_torch.apps import train as train_app
    from dpvo_tpu_torch.ba import gba_sparse
    from dpvo_tpu_torch.ba import solver as ba_solver
    from dpvo_tpu_torch.lie import se3
    from dpvo_tpu_torch.models.patchifier import gradient_bias_centroids
    from dpvo_tpu_torch.parallel import dist_ba_delta, make_mesh
    from dpvo_tpu_torch.parallel.multihost import init_distributed
    from dpvo_tpu_torch.runtime.steps import PatchifyStep
    from dpvo_tpu_torch.utils import Timer
    from dpvo_tpu_torch.utils import timer as timer_mod

    dev = torch.device("cuda")
    ht, wd, n_frames = 480, 640, 40
    cfg_path = os.path.join(ROOT, "config", "default.yaml")
    weights = os.path.join(ROOT, "weights", "vonet_synth.npz")
    gb = {"CENTROID_SEL_STRAT": "GRADIENT_BIAS"}
    cfg = load_config(cfg_path, overrides=gb)
    M, c = cfg.PATCHES_PER_FRAME, cfg.P // 2
    scene, frames = render_main_scene(n_frames)
    gt = se3.inv(torch.as_tensor(scene.poses[:n_frames])).numpy()
    launches = {}

    # ---- 1. GRADIENT_BIAS at full width ----
    slam = DPVO(cfg, weights, ht, wd)
    selected, last_ba = [], {}
    patchify = slam.steps._patchify

    def recorded(image_u8, draws):
        out = patchify(image_u8, draws)
        if len(selected) < GB_SELECT_FRAMES:
            selected.append((image_u8.cpu(), draws.cpu(), out[3][:, :2, c, c].cpu()))
        return out

    real_ba = ba_solver.ba

    def keep_ba(*args, **kw):  # the last sliding-window BA's inputs, for item 4
        last_ba.update(args=tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args),
                       kw=dict(kw))
        return real_ba(*args, **kw)

    slam.steps._patchify = recorded
    ba_solver.ba = keep_ba
    timer_mod.all_times.clear()
    kernels.reset_launches()
    step_ms = []
    try:
        with Timer("phase 10 GRADIENT_BIAS frame loop", sync=dev):
            for t in range(n_frames):
                t0 = time.perf_counter()
                slam(t, frames[t], scene.intrinsics.copy())
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        ba_solver.ba = real_ba
    poses, _ = slam.terminate()
    torch.cuda.synchronize()
    launches["gradient_bias"] = _launched(kernels)
    same_sel = []
    for image_u8, draws, card in selected:
        img = (2.0 * (image_u8.to(torch.float32) / 255.0) - 0.5).to(torch.bfloat16)[None]
        same_sel.append(torch.equal(card, gradient_bias_centroids(img, draws[None], M)[0]))
    ate = ate_rmse(poses[:, :3], gt[:, :3])
    print(f"phase 10, GRADIENT_BIAS: initialized {slam.is_initialized}, keyframes {slam.n}, "
          f"culled {len(slam.delta)}; card selection == CPU selection on frames 0-"
          f"{len(selected) - 1}: {same_sel}; ATE {ate:.4f} (RANDOM, phase 3: {main_ate:.4f}; no "
          f"accuracy claim); smoke reading: median frame {np.median(step_ms[15:]):.3f} ms over "
          f"frames 15-{n_frames - 1}; launches {launches['gradient_bias']}")
    print(f"phase 10, Timer all_times (ms): "
          f"{ {k: [round(x, 3) for x in v] for k, v in timer_mod.all_times.items()} }")
    missing = [k for k in IMPL_KERNELS["xla"] + PATH_KERNELS
               if not launches["gradient_bias"].get(k)]
    if (not slam.is_initialized or not slam.delta or not np.isfinite(poses).all()
            or poses.shape != (n_frames, 7) or missing or len(same_sel) != GB_SELECT_FRAMES
            or not all(same_sel)):
        raise AssertionError(f"GRADIENT_BIAS: not initialized or culled, non-finite poses, "
                             f"kernels {missing} not launched, or a card selection that is not "
                             f"the CPU's ({same_sel})")
    # the selection's cost: the tracker's patchify of one frame under each
    # strategy, in turn (RANDOM on the first M of the 3M candidates)
    pf_gb = slam.steps.patchify
    pf_rnd = PatchifyStep(pf_gb.patchifier, pf_gb.fdt, M, "RANDOM")
    image_u8, cand = selected[-1][0].to(dev), selected[-1][1].to(dev)
    with torch.no_grad():
        pf_ms = alternating_ms([lambda: pf_rnd(image_u8, cand[:M]),
                                lambda: pf_gb(image_u8, cand)], COST_REPS)
    print(f"phase 10, GRADIENT_BIAS cost: patchify of a 480x640 frame, {COST_REPS} runs of each "
          f"in turn (median event pair): RANDOM {pf_ms[0]:.4f} ms, GRADIENT_BIAS "
          f"{pf_ms[1]:.4f} ms, difference {pf_ms[1] - pf_ms[0]:.4f} ms")
    del slam, pf_gb, pf_rnd
    gc.collect()

    # ---- 2. the GRADIENT_BIAS export against the eager tracker ----
    rng = np.random.default_rng(1)
    h, w = ht // cfg.RES, wd // cfg.RES
    draws = [(np.stack([rng.integers(1, w - 1, 3 * M), rng.integers(1, h - 1, 3 * M)], -1)
              .astype(np.float32), rng.uniform(size=M).astype(np.float32))
             for _ in range(GB_EXPORT_FRAMES)]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "gb")
        export_network.main(["--network", weights, "--config", cfg_path, "--outdir", out,
                             "--ht", str(ht), "--wd", str(wd), "--opts",
                             "CENTROID_SEL_STRAT", "GRADIENT_BIAS"])
        with open(os.path.join(out, "meta.json")) as f:
            meta = json.load(f)
        runs = []
        for network in (weights, out):
            s2 = DPVO(cfg, network, ht, wd, draws=lambda f: draws[f])
            for t in range(GB_EXPORT_FRAMES):
                s2(t, frames[t], scene.intrinsics.copy())
            runs.append(s2.terminate()[0])
            del s2
            gc.collect()
    diff = _pose_diff(runs[1], runs[0])
    print(f"phase 10, GRADIENT_BIAS export: meta centroid_sel_strat "
          f"{meta['centroid_sel_strat']}; exported against eager tracker over "
          f"{GB_EXPORT_FRAMES} frames: largest pose difference {diff:.6g}")
    if meta["centroid_sel_strat"] != "GRADIENT_BIAS" or diff != 0.0:
        raise AssertionError("GRADIENT_BIAS export: the strategy is not recorded or the "
                             "exported tracker is not the eager one bit for bit")

    # ---- 3. the mesh tracker on a world-size-1 NCCL group ----
    store = tempfile.mkdtemp()  # the group's FileStore, removed with the group
    init_distributed(f"file://{os.path.join(store, 'store')}", 1, 0, backend="nccl")
    mesh = make_mesh(1, 1)
    print(f"phase 10: process group {dist.get_backend()}, world size {dist.get_world_size()}, "
          f"mesh {mesh}")
    lc_cfg = load_config(os.path.join(ROOT, "config", "slam.yaml"),
                         overrides={"LOOP_CLOSURE": True})
    slam = DPVO(lc_cfg, weights, ht, wd, mesh=mesh)
    rounds, dist_calls, real_dist, last_gba = [], [], gba_sparse.dist_gba, {}
    real_round = slam.steps._global_ba

    def counted(*args, **kw):  # segsum launches inside each dist_gba call
        last_gba.update(args=tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                   for a in args), kw=kw)
        before = kernels.LAUNCHES["segsum"]
        out = real_dist(*args, **kw)
        dist_calls.append(kernels.LAUNCHES["segsum"] - before)
        return out

    def timed(*args):  # as phase 6 times a round's solve
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        real_round(*args)
        b.record()
        b.synchronize()
        rounds.append(a.elapsed_time(b))

    gba_sparse.dist_gba, slam.steps._global_ba = counted, timed
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        for t, image in enumerate(stream["frames"]):
            slam(t, image, stream["scene"].intrinsics.copy())
        lc_poses, _ = slam.terminate()
        torch.cuda.synchronize()
    finally:
        gba_sparse.dist_gba = real_dist
    launches["mesh_tracker"] = dict(_launched(kernels), segsum_gba=sum(dist_calls))
    same = np.array_equal(lc_poses, stream["lc_poses"])
    # the mesh's cost: the last round's global BA through gba and through
    # dist_gba, in turn
    if last_gba:
        g_args, g_kw = last_gba["args"], last_gba["kw"]
        gba_ms = alternating_ms([lambda: gba_sparse.gba(*g_args[1:], **g_kw),
                                 lambda: real_dist(*g_args, **g_kw)], COST_REPS)
        print(f"phase 10, mesh cost: the last global-BA round, {COST_REPS} runs of each in turn "
              f"(median event pair): gba {gba_ms[0]:.4f} ms, dist_gba on a one-rank mesh "
              f"{gba_ms[1]:.4f} ms, difference {gba_ms[1] - gba_ms[0]:.4f} ms")
    print(f"phase 10, mesh tracker (world size 1, NCCL): {len(stream['frames'])} frames in "
          f"{time.perf_counter() - t0:.1f} s, {len(dist_calls)} global-BA rounds through "
          f"dist_gba, poses bit for bit phase 6's: {same} (largest difference "
          f"{np.abs(lc_poses - stream['lc_poses']).max():.3g}); round ms (event pair around the "
          f"solve, as phase 6) {[round(x, 3) for x in rounds]}, phase 6's "
          f"{[round(r['ms'], 3) for r in stream['lc_rounds']]}; launches "
          f"{launches['mesh_tracker']}")
    if not dist_calls or not launches["mesh_tracker"].get("segsum") or not same:
        raise AssertionError("mesh tracker: no global-BA round through dist_gba, no segment sum, "
                             "or poses that are not phase 6's")
    del slam
    gc.collect()

    # ---- 4. dist_ba_delta at the main path's BA shape ----
    (poses0, ctr, intr, target, weight, valid, ii, jj, kd, t0_, nfree, bounds, lmbda) = \
        last_ba["args"]
    kw = last_ba["kw"]
    bkw = dict(W=kw["W"], Md=kw["Md"], ep=kw["ep"], lm=kw["lm"], res_clip=kw["res_clip"])
    want = ba_solver.ba_delta(ba_solver.BAProblem(poses0, ctr, intr, target, weight, valid, ii, jj,
                                                  kd, t0_, nfree, kw["kd_order"]),
                              bounds, lmbda, **bkw)
    kernels.reset_launches()
    got = dist_ba_delta(mesh, poses0, ctr, intr, target, weight, valid, ii, jj, kd, t0_, nfree,
                        bounds, lmbda, **bkw)
    torch.cuda.synchronize()
    launches["dist_ba_delta"] = _launched(kernels)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"phase 10, dist_ba_delta at {target.shape[0]} edges, W {kw['W']}, Md {kw['Md']} "
          f"(world size 1): bit for bit ba_delta: {equal}; launches {launches['dist_ba_delta']}")
    if not equal or not launches["dist_ba_delta"].get("spd_solve"):
        raise AssertionError("dist_ba_delta: not ba_delta's step, or no SPD solve launched")

    # ---- 5. one training step through apps/train.py --mesh 1,1 ----
    npz = os.path.join(ROOT, "weights", "vonet_synth.npz")
    argv = ["--dataset", "synthetic", "--ht", "480", "--wd", "640", "--n_frames", "15",
            "--unroll", "18", "--batch", "1", "--init_npz", npz, "--steps", "1",
            "--log_every", "1", "--npz_every", "1000000", "--ckpt_every", "1000000",
            "--name", "mesh"]
    nets = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in (("mesh", ["--mesh", "1,1"]), ("plain", [])):
            kernels.reset_launches()
            t0 = time.perf_counter()
            nets[name] = train_app.main(argv + extra + ["--outdir", os.path.join(tmp, name)])[0]
            torch.cuda.synchronize()
            if name == "mesh":  # phase 8's rows name the training path's sites
                n = _launched(kernels)
                launches["mesh_train"] = dict(n, segsum_train=n.get("segsum", 0),
                                              spd_train=n.get("spd_solve", 0))
                with open(os.path.join(tmp, name, "runs", "mesh", "metrics.jsonl")) as f:
                    row = json.loads(f.readline())
                sec = time.perf_counter() - t0
    dparam = max((a - nets["plain"].state_dict()[k]).abs().max().item()
                 for k, a in nets["mesh"].state_dict().items())
    print(f"phase 10, train --mesh 1,1: loss {row['loss']:.5g} gnorm {row['gnorm']:.5g} "
          f"({sec:.1f} s with set-up); largest parameter difference from the step without a "
          f"mesh {dparam:.3g} (1.53e-4 on an H100 when corr_bwd summed the maps with f32 "
          f"atomics); launches "
          f"{launches['mesh_train']}")
    if not np.isfinite(row["loss"]):
        raise AssertionError("train --mesh 1,1: the loss is not finite")
    dist.destroy_process_group()
    shutil.rmtree(store)
    return launches


# Phase 10, item 6: training's edge split, two gloo ranks on the one card (NCCL
# refuses two ranks on one device), each a process of its own, each taking
# the step EDGE_RUNS times (the first warms the process, the last is profiled)
EDGE_RANKS = 2
EDGE_RUNS = 3
EDGE_RANK_TIMEOUT_S = 600
EDGE_KERNELS = ("corr", "corr_bwd", "segsum", "segsum_bf16", "spd_solve")
# The split step against the single-process step, quantity by quantity (the
# parameters' update, as a fraction of their norm; the loss, the gradient
# norm and the last unroll step's metrics, relative): within the CPU test's
# tolerance (tests/test_torch_parallel.py::
# test_edge_split_train_step_matches_single_process) or within how far the
# single-process step itself moves when its weights are scaled by each of
# EDGE_SCALES, whichever is larger. The CPU's tolerances cannot tell a fault
# from rounding at full width: on an H100 (700 W) the scaled bf16 steps moved
# the loss by 2.6e-3 and 5.4e-3, the metrics by up to 4.0% and the update by
# 1.4e-5 of the norm (f32: up to 7.2e-4, 0.59%, 3.1e-6), where the split moved
# them by 4.4e-4, up to 1.5% and 7.0e-6 (f32: 5.6e-4, 0.28%, 2.0e-6).
EDGE_TOL = {"update": 1e-5, "loss": 1e-4, "flow": 1e-4, "tr": 1e-4, "ro": 1e-4, "px1": 1e-4,
            "gnorm": 1e-2}
EDGE_SCALES = (1 + 1e-6, 1 - 1e-6)


def _edge_inputs(torch, workdir):
    """Phase 8's full-width step from weights/vonet_synth.npz (Config(),
    bf16), its clip (SyntheticClipDataset seed 5) and one draw (generator
    seed 4), written to workdir/inputs.pt for the ranks; returns them."""
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.data.factory import SyntheticClipDataset
    from dpvo_tpu_torch.models.vonet import draw_inputs
    from dpvo_tpu_torch.runtime.weights import load_networks

    cfg = Config()
    clip = SyntheticClipDataset(n_frames=15, ht=480, wd=640, seed=5).sample()
    batch = {k: v[None] for k, v in zip(("images", "poses", "disps", "intrinsics"), clip)}
    draws = [draw_inputs(15, cfg.PATCHES_PER_FRAME, 480 // cfg.RES, 640 // cfg.RES, 18,
                         torch.Generator().manual_seed(4), strategy=cfg.CENTROID_SEL_STRAT)]
    state = load_networks(cfg, os.path.join(ROOT, "weights", "vonet_synth.npz")).state_dict()
    inputs = dict(batch=batch, draws=draws, state=state)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    return inputs


def edge_split_step(torch, kernels, inputs, mesh=None, scale=1.0, profiled=False):
    """One phase-8 train step on the card from inputs' state (its weights
    times ``scale``), batch and draws (a fresh optimizer), split over mesh's
    edge axis where given. Returns the parameters' update (flat, on the
    CPU), the metrics, the edge count of each correlation call of the
    forward pass, the kernels' launches, the step's seconds and peak
    memory, and (profiled) its busy share."""
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.models import vonet
    from dpvo_tpu_torch.runtime.weights import Networks
    from dpvo_tpu_torch.train import make_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False  # as the train entry point sets them
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config()
    nets = Networks(cfg)
    nets.load_state_dict(inputs["state"])
    nets = nets.to("cuda")
    with torch.no_grad():
        for p in nets.parameters():
            p.mul_(scale)
    flat = lambda n: torch.cat([v.detach().reshape(-1).to(torch.float32).cpu()
                                for _, v in sorted(n.state_dict().items())])
    before = flat(nets)
    tx, _ = make_optimizer(lr=8e-5, total_steps=240000)
    step = make_train_step(cfg, tx, STEPS=18, mesh=mesh)
    opt = tx.init({k: p.detach() for k, p in nets.named_parameters()})
    edges, real_corr = [], vonet.corr_features_train

    def counted(gmap, pyr1, pyr2, coords, *args, **kw):
        edges.append(coords.shape[0])
        return real_corr(gmap, pyr1, pyr2, coords, *args, **kw)

    vonet.corr_features_train = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    busy = None
    try:
        t0 = time.perf_counter()
        if profiled:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                nets, _, m = step(nets, opt, inputs["batch"], inputs["draws"])
                torch.cuda.synchronize()
        else:
            nets, _, m = step(nets, opt, inputs["batch"], inputs["draws"])
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    finally:
        vonet.corr_features_train = real_corr
    if profiled:
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        busy = busy_us / 1e6 / sec if busy_us else None
    return dict(update=flat(nets) - before, norm=before.norm().item(),
                metrics={k: float(v) for k, v in m.items()}, edges=edges[:18],
                launches=_launched(kernels), seconds=sec,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, busy=busy)


def edge_rank_main(rank: str, world: str, workdir: str):
    """One rank of phase 10's edge split (``python3 chip_smoke.py edge-rank
    RANK WORLD DIR``): joins a gloo group through a FileStore in DIR, takes
    inputs.pt's step EDGE_RUNS times on the split of a (1, WORLD) mesh and
    writes the runs to DIR/rank<RANK>.pt."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.parallel import make_mesh
    from dpvo_tpu_torch.parallel.multihost import init_distributed

    rank, world = int(rank), int(world)
    init_distributed(f"file://{os.path.join(workdir, 'store')}", world, rank, backend="gloo",
                     timeout_s=EDGE_RANK_TIMEOUT_S)
    try:
        mesh = make_mesh(1, world, device_type="cpu")
        inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
        runs = [edge_split_step(torch, kernels, inputs, mesh, profiled=i == EDGE_RUNS - 1)
                for i in range(EDGE_RUNS)]
        torch.save(runs, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def _edge_distance(run, ref):
    """run's distance from ref: the update's as a fraction of the
    parameters' norm, each metric's relative."""
    d = {"update": ((run["update"] - ref["update"]).norm() / ref["norm"]).item()}
    d.update({k: abs(run["metrics"][k] - v) / max(abs(v), 1e-30)
              for k, v in ref["metrics"].items()})
    return d


def phase_edge_split(torch, kernels):
    """Phase 10, item 6: phase 8's full-width step split over the edge axis
    of a (1, EDGE_RANKS) mesh, each rank a process on the one card (gloo on
    CUDA tensors), from one state and one draw, EDGE_RUNS times in each
    rank. Gated: each rank's runs launch EDGE_KERNELS; its correlation takes
    half of the last unroll step's edges; its update, loss and metrics lie
    within EDGE_TOL or the single-process step's own move under the weight
    scalings EDGE_SCALES of the single-process card step; its runs, and the
    ranks, give the same bits. Printed: each run's seconds, peak memory and
    (the last) busy share, beside the single-process step's (two processes
    share the card and its host). Returns rank 0's first run's launches
    (segsum's and SPD's also under phase 8's names, segsum_train and
    spd_train)."""
    import shutil
    import tempfile

    from dpvo_tpu_torch.models.vonet import build_schedule

    workdir = tempfile.mkdtemp()
    try:
        inputs = _edge_inputs(torch, workdir)
        single = edge_split_step(torch, kernels, inputs)
        scaled = {s: _edge_distance(edge_split_step(torch, kernels, inputs, scale=s), single)
                  for s in EDGE_SCALES}
        env = dict(os.environ, PYTHONPATH=ROOT)
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "edge-rank",
                                   str(r), str(EDGE_RANKS), workdir], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for r in range(EDGE_RANKS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=EDGE_RANK_TIMEOUT_S)[0].decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"edge split: rank {r} failed:\n{out[-4000:]}")
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                 for r in range(EDGE_RANKS)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    Es = len(build_schedule(15, 80, 18)[-1].kk)
    fmt = lambda d: "{" + ", ".join(f"{k} {v:.3g}" for k, v in sorted(d.items())) + "}"
    tol = {k: max([t] + [d[k] for d in scaled.values()]) for k, t in EDGE_TOL.items()}
    print(f"phase 10, edge split: the single-process step {single['seconds']:.3f} s, peak "
          f"{single['peak_gib']:.3f} GiB, {single['edges'][-1]} edges at the last unroll step; "
          + " ".join(f"{k} {v!r}" for k, v in sorted(single["metrics"].items())))
    for s, d in scaled.items():
        print(f"phase 10, edge split: the single-process step with its weights x {s!r}, its "
              f"distance from the step: {fmt(d)}")
    print(f"phase 10, edge split: bounds (the larger of the CPU test's and the scaled steps' "
          f"distances): {fmt(tol)}")
    bad = []
    for r, runs in enumerate(ranks):
        for i, run in enumerate(runs):
            d = _edge_distance(run, single)
            busy = "not measured" if run["busy"] is None else f"{100 * run['busy']:.1f}%"
            print(f"phase 10, edge split: rank {r} run {i}: {run['seconds']:.3f} s"
                  f"{' (profiled)' if i == EDGE_RUNS - 1 else ''}, peak "
                  f"{run['peak_gib']:.3f} GiB, busy {busy}; {run['edges'][-1]} of {Es} edges "
                  f"at the last unroll step; distance from the single-process step {fmt(d)}; "
                  f"launches {run['launches']}")
            if (min(run["launches"].get(k, 0) for k in EDGE_KERNELS) == 0
                    or run["edges"][-1] * EDGE_RANKS != Es or any(d[k] > tol[k] for k in tol)):
                bad.append((r, i))
    first = ranks[0][0]
    same = all(torch.equal(run["update"], first["update"]) and run["metrics"] == first["metrics"]
               for runs in ranks for run in runs)
    print(f"phase 10, edge split: every run of every rank bit for bit the first: {same}")
    if bad or not same:
        raise AssertionError(f"edge split: runs {bad} missed a kernel, half of the edges or the "
                             f"bounds, or the runs or ranks differ")
    n = first["launches"]  # phase 8's rows name the training path's sites
    return dict(n, segsum_train=n.get("segsum", 0), spd_train=n.get("spd_solve", 0))


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "dpvo_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dpvo_tpu_torch import kernels

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"phase 1: built {lib.name} in {time.perf_counter() - t0:.1f} s")
    print(lib.with_suffix(".log").read_text().strip())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)

    t0 = time.perf_counter()
    stats = phase_kernels(torch, kernels)
    print(f"phase 2: kernels agree with their plain versions ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    launches, main_ate = phase_main_path(torch, kernels)
    print(f"phase 3: main path ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    impl_launches = phase_corr_impls(torch, kernels)
    print(f"phase 4: every CORR_IMPL tracks ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_small_parity(torch)
    phase_lc_small_parity()
    gba = gba_card_vs_cpu(torch)
    print("global BA (tests/test_ba.py's problem), card against CPU: poses, depths {own_solve} "
          "with each side's dense solve, {cpu_solve} with both solves on the CPU; two card "
          "runs bit for bit equal: {repeat_equal}; segsum launches {segsum_launches}".format(**gba))
    if not gba["repeat_equal"] or gba["segsum_launches"] == 0:
        raise AssertionError("global BA: two card runs differ or no segment sum ran")
    print(f"phase 5: small-path parity ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    gba_segsum, stream = phase_loop_closure(torch, kernels)
    print(f"phase 6: loop closure ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    lc_sites = phase_classic_lc(torch, kernels, stream)
    print(f"phase 7: classic loop closure ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    train_launches = phase_training(torch, kernels)
    print(f"phase 8: training ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    export_launches = phase_export_apps(torch, kernels, smi)
    print(f"phase 9: export, demo, evaluation ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    p10 = phase_gradient_bias_parallel(torch, kernels, smi, main_ate, stream)
    p10["edge_train"] = phase_edge_split(torch, kernels)
    print(f"phase 10: GRADIENT_BIAS, the parallel layer, Timer, the edge split ok "
          f"({time.perf_counter() - t0:.1f} s)")

    cp_src, cp_tpu = "dpvo_tpu_torch/csrc/corr_pallas.cu", "dpvo_tpu/ops/corr_pallas.py"
    meta = {  # source, the TPU kernel's pallas_call, the run whose launches count
        "corr": ("dpvo_tpu_torch/csrc/corr.cu", f"{cp_tpu}:949", launches),
        "segsum": ("dpvo_tpu_torch/csrc/segsum.cu", "dpvo_tpu/ba/segsum_pallas.py:68", launches),
        "segsum_bf16": ("dpvo_tpu_torch/csrc/segsum.cu", "dpvo_tpu/ba/segsum_pallas.py:68",
                        launches),
        # the global BA's reductions (jax.ops.segment_sum in the JAX package)
        "segsum_gba": ("dpvo_tpu_torch/csrc/segsum.cu", "dpvo_tpu/ba/segsum_pallas.py:68",
                       {"segsum_gba": gba_segsum}),
        "spd_solve": ("dpvo_tpu_torch/csrc/spd_solve.cu", "dpvo_tpu/ba/spd_solve.py:81",
                      launches),
        # classic loop closure's call sites (phase 7's first run); the JAX
        # package's PGO sums are XLA scatters, its triplet BA's depth sum the
        # one-hot matmul (no kd_order)
        "segsum_pgo": ("dpvo_tpu_torch/csrc/segsum.cu", "dpvo_tpu/ba/segsum_pallas.py:68",
                       lc_sites),
        "segsum_triplet": ("dpvo_tpu_torch/csrc/segsum.cu", "dpvo_tpu/ba/segsum_pallas.py:68",
                           lc_sites),
        "spd_triplet": ("dpvo_tpu_torch/csrc/spd_solve.cu", "dpvo_tpu/ba/spd_solve.py:81",
                        lc_sites),
        # the training path (phase 8's entry-point run): the correlation's
        # backward pass (XLA's autodiff in the JAX package: no Pallas kernel),
        # and BA's segment sum and the pose solve forward and backward
        "corr_bwd": ("dpvo_tpu_torch/csrc/corr_bwd.cu",
                     "dpvo_tpu/ops/corr.py:287 (XLA autodiff of corr_features_xla)",
                     train_launches),
        "segsum_train": ("dpvo_tpu_torch/csrc/segsum.cu", "dpvo_tpu/ba/segsum_pallas.py:68",
                         {"segsum_train": train_launches["segsum"]}),
        "spd_train": ("dpvo_tpu_torch/csrc/spd_solve.cu", "dpvo_tpu/ba/spd_solve.py:81",
                      {"spd_train": train_launches["spd_solve"]}),
        "corr_window": (cp_src, f"{cp_tpu}:188", impl_launches["pallas"]),
        "corr_sw_fused": (cp_src, f"{cp_tpu}:336", impl_launches["pallas_sw"]),
        "corr_v3_fused": (cp_src, f"{cp_tpu}:620, {cp_tpu}:552", impl_launches["pallas_dma"]),
    }
    rows = []
    for name, s in stats.items():
        bound_ms, bound_by = s["bound"]
        rows.append({"name": name, "route": "cuda", "source": meta[name][0],
                     "replaces": meta[name][1], "launches": meta[name][2][name],
                     "max_abs_err": s["max_abs_err"], "ms": s["ms"], "kernel_ms": s["ms"],
                     "device_ms": s["device_ms"], "plain_ms": s["plain_ms"],
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": s["library_ms"]})
    # SoftAgg's sums inside phase 9's exported update (update.pt2 keeps the op)
    next(r for r in rows if r["name"] == "segsum_bf16")["export_launches"] = export_launches
    # phase 10's paths: each kernel's launches there, by path (segsum's f32
    # launches in the mesh tracker are its global-BA rounds' and its windowed
    # BA's alike)
    for r in rows:
        r["phase10_launches"] = {path: n[r["name"]] for path, n in p10.items()
                                 if n.get(r["name"])}
    print(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["edge-rank"]:
        sys.exit(edge_rank_main(*sys.argv[2:]))
    sys.exit(main())
