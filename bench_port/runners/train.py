"""The runner of training cells (``"runner": "train"``): the port's
training step, ``train/step.make_train_step`` with the optimizer of
``make_optimizer``, on one card, as ``apps/train.py`` runs it.

Set-up builds the kernels, makes the traffic's pool of clips and their
draws from the seed (``traffic/<kind>.py``), loads the configuration's
weights (the reference's loader: one state dict for both sides), builds
the networks, the optimizer state and the step, and drives that step
through the checked steps (3: each on a clip of its own); they warm up
every shape the window uses. The window is whole optimizer steps on the
wall clock, each ending in a synchronize, on the pool's next clips in
turn: it closes at the end of the first step that ends ``seconds`` or
more after it opened. ``frames`` is the clip frames of the window's
steps (frames x batch a step).

``correct``: the plain reference (``reference/train/``, f32, TF32 off)
follows the checked steps from the same weights and clips after the
window, once the program is freed. The checked steps are set-up's first
steps, not a step of the window: the window hands on the object that
they drove, and the reference follows the first three. Compared, each
with its limit in the configuration file:

  grad_gap   the first step's gradient as the optimizer took it (after
             the NaN zeroing and the clip), worked out of the program's
             Adam state after that step (mu / (1 - b1)): by the update
             operator's worst leaf, |‖program‖ - ‖reference‖| over the
             larger of the reference's norm of that leaf and the median
             leaf's (the encoders' bf16 convolutions read several times
             more noise a leaf, and their worst leaves, logged beside it,
             do not separate the program from the control: PERF.md)
  fnet_grad  the same gradient of the feature encoder (``patchifier.
             fnet.*``), whose only gradient is the correlation backward's
             (``csrc/corr_bwd.cu``): ‖program - reference‖ over
             ‖reference‖, its leaves taken together, so that a gradient
             sent to the wrong place reads as well as one of the wrong size
  param_gap  the parameters' change over the checked steps (the state the
             window starts from), by the worst leaf as ``grad_gap``, over
             every leaf whose reference gradient is at least a thousandth
             of the median leaf's (the others move under Adam by rounding
             alone)

Each checked step's loss has to be finite; its gap to the reference's is
logged, not compared (sound runs read up to the control's: PERF.md).

With ``trace`` one more step, on the pool's next clip once the window has
closed and its peak is read, runs under the CUDA-only profile
(``profile_window.py``), with the shapes of its correlation,
correlation-backward and segment-sum calls recorded (``harness.probed``);
``profile_frames`` is that step's clip frames;
``edge_rounds``, ``patchifies`` and ``passes`` (forward and a backward of
twice its work) count the model FLOP of the window's steps for
``mfu_pct``.

The tests' hooks: ``fault`` plants a fault in the program (``unchanged``:
every step leaves the parameters as they were; ``zero_update_grads``: the
update operator's gradients zeroed; ``no_clip``: the optimizer without
the global-norm clip; ``corr_bwd_scale``: the correlation backward's
gradients doubled; ``corr_bwd_shift``: its feature-map gradients handed
to the next frame's slot); ``control`` puts the reference in fp8 in the
program's place for the checked steps.
"""

from __future__ import annotations

import contextlib
import gc
import math
import statistics
import time

NUMBERS = ("grad_gap", "fnet_grad", "param_gap")
FAULTS = ("unchanged", "zero_update_grads", "no_clip", "corr_bwd_scale", "corr_bwd_shift")
NETS = {"fnet": "patchifier.fnet.", "inet": "patchifier.inet.", "update": "update."}


def _host(tensors: dict) -> dict:
    return {k: v.detach().double().cpu() for k, v in tensors.items()}


def _norms(tensors: dict) -> dict:
    import torch

    return {k: float(torch.linalg.vector_norm(v)) for k, v in tensors.items()}


def net_diff(prog: dict, ref: dict, prefix: str = "", keep=None) -> float:
    """‖program - reference‖ over ‖reference‖ of the leaves under
    ``prefix`` taken together; inf where it reads no finite number."""
    import torch

    keys = [k for k in ref if k.startswith(prefix) and (keep is None or k in keep)]
    num = math.sqrt(sum(float(torch.sum((prog[k] - ref[k]) ** 2)) for k in keys))
    den = math.sqrt(sum(float(torch.sum(ref[k] ** 2)) for k in keys))
    gap = num / den if den > 0 else math.inf
    return gap if math.isfinite(gap) else math.inf


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |‖p‖ - ‖r‖| over max(‖r‖, the median leaf's); a leaf
    that reads no finite number (a NaN on either side) reads inf."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    out = {}
    for k in keys:
        den = max(ref[k], med)
        gap = abs(prog[k] - ref[k]) / den if den > 0 else math.inf
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def kept(ref_grad_norms: dict) -> set:
    """The leaves whose first reference gradient is at least a thousandth
    of the median leaf's."""
    med = statistics.median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items() if v >= 1e-3 * med}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers of the program's readings against the reference's: each
    a dict of ``loss`` [per checked step], ``grad`` {leaf: tensor} and
    ``change`` {leaf: tensor}. ``grad_gap`` is the update operator's worst
    leaf (``update.*``); ``fnet_grad`` the feature encoder's gradient
    whole. Logged beside them, for each network: its worst and median
    leaf (``<net>_worst``, ``<net>_median``), the relative L2 of its
    gradient (``<net>_grad``), its median leaf's ‖program - reference‖
    over the larger of the leaf's and the median leaf's norm
    (``<net>_leafdiff``) and the reference's norm (``<net>_norm``); and
    the relative L2 of the change (``change_diff``)."""
    losses = [abs(p - r) / abs(r) if r else math.inf for p, r in zip(prog["loss"], ref["loss"])]
    ref_norms = _norms(ref["grad"])
    grads = leaf_gaps(_norms(prog["grad"]), ref_norms)
    keep = kept(ref_norms)
    changes = leaf_gaps(_norms(prog["change"]), _norms(ref["change"]), keep)
    worst = lambda gaps, net: max((k for k in gaps if k.startswith(net)), key=gaps.get)
    grad_leaf, param_leaf = worst(grads, NETS["update"]), worst(changes, "")
    row = dict(grad_gap=grads[grad_leaf], param_gap=changes[param_leaf],
               losses_finite=all(map(math.isfinite, prog["loss"])), loss_gaps=losses,
               grad_leaf=grad_leaf, param_leaf=param_leaf)
    med = statistics.median(ref_norms.values())
    for net, prefix in NETS.items():  # fnet_grad among them
        mine = [k for k in grads if k.startswith(prefix)]
        row.update({f"{net}_worst": max(grads[k] for k in mine),
                    f"{net}_median": statistics.median(grads[k] for k in mine),
                    f"{net}_grad": net_diff(prog["grad"], ref["grad"], prefix),
                    f"{net}_leafdiff": statistics.median(
                        net_diff(prog["grad"], ref["grad"], k, {k}) * ref_norms[k]
                        / max(ref_norms[k], med) for k in mine),
                    f"{net}_norm": math.sqrt(sum(ref_norms[k] ** 2 for k in mine))})
    row.update(all_grad=net_diff(prog["grad"], ref["grad"]),
               change_diff=net_diff(prog["change"], ref["change"], "", keep),
               left_out=sorted(set(ref_norms) - keep))
    return row


def verdict(row: dict, limits: dict):
    """(correct, numbers): each compared number within its limit, and every
    checked step's loss finite (the losses themselves are not compared:
    PERF.md gives their readings)."""
    numbers, ok = {}, row["losses_finite"]
    for k in NUMBERS:
        v, lim = row[k], limits.get(k)
        ok = ok and lim is not None and math.isfinite(v) and v <= lim
        numbers[k] = {"value": v if math.isfinite(v) else None, "limit": lim}
    return ok, numbers


def _card_setup(device):
    """On a card: the port's kernels built, and f32 kept f32 (no TF32), as
    ``apps/train.py`` sets it."""
    import torch

    if device.type == "cuda":
        from dpvo_tpu_torch import kernels

        kernels.build()
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def weights_state(config: dict, root, seed: int):
    """The configuration's weights as one state dict (the reference's
    loader), which both sides load; random from the seed where the file
    names none (the tests' small networks)."""
    from bench_port.reference.config import Config as RefConfig
    from bench_port.reference.runtime.weights import load_networks

    path = str(root / config["weights"]) if config.get("weights") else None
    nets = load_networks(RefConfig(**config["config"]), path, seed=seed & 0x7FFFFFFF)
    return {k: v.detach().clone() for k, v in nets.state_dict().items()}


def make_clips(config: dict, traffic: dict, seed: int, root, device):
    from bench_port.reference.models.patchifier import draw_count
    from bench_port.run import load_module

    c, r = config["config"], config["recipe"]
    gen = load_module(root, "traffic", traffic["kind"])
    return gen.make_clips(traffic, seed, config["ht"], config["wd"], r["n_frames"], r["batch"],
                          c["RES"], draw_count(c["CENTROID_SEL_STRAT"], c["PATCHES_PER_FRAME"]),
                          c["PATCHES_PER_FRAME"], r["unroll"], device)


@contextlib.contextmanager
def _planted(fault):
    """Within the block, the correlation backward's faults at its output
    (``ops/corr_cuda.corr_backward``, which ``CorrFeatures`` calls):
    ``corr_bwd_scale`` doubles the three gradients, ``corr_bwd_shift``
    hands each slot's feature-map gradients to the next slot."""
    if fault not in ("corr_bwd_scale", "corr_bwd_shift"):
        yield
        return
    from dpvo_tpu_torch.ops import corr_cuda as mod

    real = mod.corr_backward

    def wrong(*args, **kw):
        dgmap, dfm1, dfm2 = real(*args, **kw)
        if fault == "corr_bwd_scale":
            return 2 * dgmap, 2 * dfm1, 2 * dfm2
        return dgmap, dfm1.roll(1, 0), dfm2.roll(1, 0)

    mod.corr_backward = wrong
    try:
        yield
    finally:
        mod.corr_backward = real


class Program:
    """The port's networks, optimizer state and step, built once; the
    checked steps and the window drive the same object."""

    def __init__(self, config: dict, state: dict, device, fault=None):
        import torch

        from dpvo_tpu_torch.config import Config
        from dpvo_tpu_torch.runtime.weights import Networks
        from dpvo_tpu_torch.train import make_optimizer, make_train_step

        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        r = config["recipe"]
        self.cfg = Config(**config["config"])
        self.nets = Networks(self.cfg)
        self.nets.load_state_dict(state, strict=True)
        self.nets = self.nets.to(device)
        self.tx, _ = make_optimizer(lr=r["lr"], total_steps=r["total_steps"], clip=r["clip"])
        if fault == "no_clip":
            self.tx.clip = math.inf
        if fault == "zero_update_grads":
            for p in self.nets.update.parameters():
                p.register_hook(torch.zeros_like)
        self.lr_scale = 0.0 if fault == "unchanged" else 1.0
        self.fault = fault
        self.opt_state = self.tx.init({k: p.detach() for k, p in self.nets.named_parameters()})
        self.step_fn = make_train_step(self.cfg, self.tx, STEPS=r["unroll"],
                                       flow_weight=r["flow_weight"],
                                       pose_weight=r["pose_weight"])
        self.device = device

    def step(self, clip) -> dict:
        """One optimizer step on a clip (batch, draws); the step's metrics
        as device scalars."""
        batch, draws = clip
        with _planted(self.fault):
            self.nets, self.opt_state, metrics = self.step_fn(self.nets, self.opt_state, batch,
                                                              draws, lr_scale=self.lr_scale)
        return metrics

    def checked(self, clips) -> dict:
        """The checked steps' readings (``compare``), on clips[0..n)."""
        p0 = {k: p.detach().clone() for k, p in self.nets.named_parameters()}
        out = dict(loss=[], gnorm=[])
        for i, clip in enumerate(clips):
            metrics = self.step(clip)
            out["loss"].append(float(metrics["loss"]))  # waits for the step
            out["gnorm"].append(float(metrics["gnorm"]))
            if i == 0:
                b1 = self.tx.b1
                out["grad"] = _host({k: m / (1 - b1) for k, m in self.opt_state["mu"].items()})
        out["change"] = _host({k: p.detach() - p0[k] for k, p in self.nets.named_parameters()})
        return out


def reference_readings(config: dict, state: dict, clips, device, precision: str = "f32"):
    """The plain reference's readings of the checked steps (TF32 off)."""
    import torch

    from bench_port.reference.train.step import Trainer

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = Trainer(config["config"], None, config["recipe"], device, precision)
        ref.nets.load_state_dict(state, strict=True)
        p0 = {k: p.detach().clone() for k, p in ref.params.items()}
        out = dict(loss=[])
        for i, (batch, draws) in enumerate(clips):
            loss, g = ref.step(batch, draws)
            out["loss"].append(loss)
            if i == 0:
                out["grad"] = _host(g)
        out["change"] = _host({k: p.detach() - p0[k] for k, p in ref.params.items()})
        del ref
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def window_flops(config: dict) -> tuple:
    """A step's update rounds [(live edges, live groups of both SoftAggs)]
    and patchified frames, from the recipe's schedule."""
    import numpy as np

    from bench_port.reference.train.vonet import build_schedule

    c, r = config["config"], config["recipe"]
    rounds = [(len(st.kk), len(np.unique(st.kk)) + len(np.unique(st.ij_seg)))
              for st in build_schedule(r["n_frames"], c["PATCHES_PER_FRAME"], r["unroll"])]
    return rounds * r["batch"], r["n_frames"] * r["batch"]


def calibrate(config: dict, traffic: dict, seeds, control_seeds, fault_seeds, device, root,
              emit) -> dict:
    """The readings that the limits of ``correct`` are set from, for
    ``calibrate.py``: for each seed the program's checked steps (sound, and
    with each fault on ``fault_seeds``) and the control's (the reference in
    fp8, on ``control_seeds``), each against the f32 reference; ``emit``
    takes one dict a (seed, side). Returns each side's extreme of every
    number: the program's largest, the control's and each fault's
    smallest."""
    import torch

    _card_setup(device)
    n = traffic["checked_steps"]
    rows = []
    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        t0 = time.perf_counter()
        clips = make_clips(config, traffic, seed, root, device)[:n]
        state = weights_state(config, root, seed)
        sides = {}
        for fault in ((None,) if seed in seeds else ()) + (FAULTS if seed in fault_seeds else ()):
            prog = Program(config, state, device, fault)
            sides[fault or "program"] = prog.checked(clips)
            del prog
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        ref = reference_readings(config, state, clips, device)
        if seed in control_seeds:
            sides["control"] = reference_readings(config, state, clips, device, "fp8")
        ref_norms = _norms(ref["grad"])
        for side, mine in sides.items():
            rows.append(dict(seed=seed, side=side, **compare(mine, ref)))
            emit(dict(rows[-1], loss_program=mine["loss"], loss_reference=ref["loss"],
                      gnorm=mine.get("gnorm"),
                      grad_leaves=leaf_gaps(_norms(mine["grad"]), ref_norms),
                      change_leaves=leaf_gaps(_norms(mine["change"]), _norms(ref["change"]),
                                              kept(ref_norms)),
                      norms=dict(grad=ref_norms, change=_norms(ref["change"]))))
        emit(dict(seed=seed, seconds=time.perf_counter() - t0))
    numbers = sorted(k for k, v in rows[0].items() if isinstance(v, float)) if rows else []
    return {side: {k: (max if side == "program" else min)(r[k] for r in rows if r["side"] == side)
                   for k in numbers} for side in sorted({r["side"] for r in rows})}


def run(cell, config, traffic, seed, seconds, trace, device, root, log, started, fault=None,
        control=False) -> dict:
    import torch

    from bench_port import harness, profile_window

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    phases = {"imports": time.perf_counter() - started}
    _card_setup(device)
    phases["kernel build"] = time.perf_counter() - started
    clips = make_clips(config, traffic, seed, root, device)
    state = weights_state(config, root, seed)
    phases["clips, weights"] = time.perf_counter() - started
    n_checked = traffic["checked_steps"]
    prog = Program(config, state, device, fault)
    mine = prog.checked(clips[:n_checked])
    sync()
    phases["checked steps"] = time.perf_counter() - started
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - started
    log("set-up, seconds from the start to the end of each phase: "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))

    probe = harness.Probe()
    steps, failed, summary = 0, 0, None
    t_open = time.perf_counter()
    while True:
        loss = prog.step(clips[(n_checked + steps) % len(clips)])["loss"]
        sync()
        t1 = time.perf_counter()
        steps += 1
        failed += not math.isfinite(float(loss))
        if t1 - t_open >= seconds:
            break
    window_s = t1 - t_open
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace and cuda:
        # the profiled step comes once the window has closed: the
        # profiler's processing holds the host for seconds at its end
        log(f"nvidia-smi utilization.gpu before the profiled step: "
            f"{harness.smi_utilization()} %")
        with harness.probed(probe, ("segsum", "corr", "corr_bwd")):
            prof = profile_window.start()
            probe.profiling = True
            loss = prog.step(clips[(n_checked + steps) % len(clips)])["loss"]
            sync()
            probe.profiling = False
            prof.stop()
        summary = profile_window.summarize(prof)
        failed += not math.isfinite(float(loss))
    corr_bwd = [(*c[:-1], int(c[-1].sum())) for c in probe.corr_bwd]
    corr = harness.corr_shapes(probe.corr)
    rounds, frames = window_flops(config)
    ctx = dict(frames=frames * steps, window_s=window_s, setup_s=setup_s, peak_bytes=peak,
               profile=summary, segsum_calls=list(probe.segsum), corr_calls=corr,
               corr_bwd_calls=corr_bwd, profile_frames=frames if summary is not None else 0,
               edge_rounds=rounds * steps, patchifies=frames * steps, passes=3,
               config=config["config"], ht=config["ht"], wd=config["wd"])
    log(f"steps {steps} in a window of {window_s:.3f} s ({frames * steps / window_s:.4f} "
        f"frames/s){'' if summary is None else ', then one profiled step'}, non-finite losses "
        f"{failed}; setup {setup_s:.3f} s; peak {peak} bytes")
    del prog, probe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    theirs = reference_readings(config, state, clips[:n_checked], device)
    if control:
        mine = reference_readings(config, state, clips[:n_checked], device, "fp8")
    row = compare(mine, theirs)
    log(f"the reference's {n_checked} steps: {time.perf_counter() - t0:.3f} s; losses "
        f"program {mine['loss']} reference {theirs['loss']}; the program's gradient norms "
        f"{mine.get('gnorm')} (clip {config['recipe']['clip']})")
    log("check " + " ".join(f"{k}={v}" for k, v in row.items()))
    correct, numbers = verdict(row, config.get("limits", {}))
    return dict(ctx=ctx, attempted=steps + (summary is not None), failed=failed,
                correct=correct and not failed, checks=numbers, profile=summary, breakdown={})
