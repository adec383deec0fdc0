"""What decides ``correct``: each check's call, made again by the plain
reference (``reference/``) from the program's state before it, and the
program's state after it held to the reference's.

The reference tracker takes the program's estimated state between two
frames (poses, inverse depths, patches, hidden state, targets, weights,
topology, pending keyframe decisions) and computes again from the frames
and the draws what the program derived from them (feature maps, patch
features); the frame's features are compared by themselves. It runs in
f32 (TF32 off), or as the control in fp8 (``precision="fp8"``).

Numbers, each the largest over a run's checks:
  feat_gap    the call's new frame features (fmap, gmap, imap): the
              largest of |program - reference| / |reference| (L2 norms)
  net_gap     the edges' hidden state after a tracking call (a frame or a
              global-BA frame), the same measure
  flow_px     the edges' targets after a tracking call: RMS distance,
              pixels at 1/4 resolution
  weight_gap  the edges' confidence weights after a tracking call, relative
  pose_gap    the keyframe poses after a tracking call: |program -
              reference| over |reference - before the round| (the round's
              own move)
  depth_gap   the patches' inverse depths after a tracking call, the same
              measure
  init_net_gap, init_weight_gap
              net_gap and weight_gap after the initializing call (12
              update rounds from random depths, which carry rounding
              further than one round: its targets, poses and depths
              spread too widely to separate the control, PERF.md)
  structure   1 where the call left another graph (frame, patch or edge
              count, or edges) than the reference's, else 0

A keyframe decision that the checked call makes on its own flow
magnitude (the non-steady frames of loop closure decide inline) is
rounding's to tip where the program's and the reference's magnitudes lie
on either side of the threshold within KEYFRAME_BAND of each other: the
reference then takes the program's decision (``kf_followed``), and the
graph is compared exactly after it. Each row also gives ``kf_gap``, the
largest relative gap between the two sides' magnitudes of the call, and,
where the graphs differ, both sides' frame, patch and edge counts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

KEYFRAME_BAND = 0.01  # relative; the program read gaps up to 0.0017 (PERF.md)
NUMBERS = ("feat_gap", "net_gap", "flow_px", "weight_gap", "pose_gap", "depth_gap", "init_net_gap",
           "init_weight_gap", "structure")


def _rel(p, r, base=None) -> float:
    p, r = p.double(), r.double()
    d = torch.linalg.vector_norm(p - r).item()
    den = torch.linalg.vector_norm(r - base.double() if base is not None else r).item()
    if den > 0:
        return d / den
    return 0.0 if d == 0 else math.inf


def _drop_row(x, k, rows):
    return torch.cat([x[:k * rows], x[(k + 1) * rows:]])


def compare(check, ref, cfg) -> dict:
    """The numbers of one check: the program's snapshot after the call
    against the reference tracker ``ref`` after the same call."""
    a, st, tp = check.after, ref.state, ref.topo
    dev = st.poses.device
    out = dict.fromkeys(NUMBERS, 0.0)
    same = (a["n"] == tp.n and a["m"] == tp.m and len(a["topo"]["ii"]) == len(tp.ii)
            and all(np.array_equal(a["topo"][k], getattr(tp, k)) for k in ("ii", "jj", "kk")))
    if not same:
        out["structure"] = 1.0
        out.update(n_prog=a["n"], n_ref=tp.n, m_prog=a["m"], m_ref=tp.m,
                   edges_prog=len(a["topo"]["ii"]), edges_ref=len(tp.ii))
        return out
    n, m, E = tp.n, tp.m, len(tp.ii)
    g = lambda x: torch.as_tensor(x).to(dev)
    if check.features is not None and ref.mid is not None and "fmap" in ref.mid:
        out["feat_gap"] = max(_rel(g(p), r) for p, r in zip(
            check.features, (ref.mid["fmap"], ref.mid["gmap"], ref.mid["imap"])))
    if E:
        out["net_gap"] = _rel(g(a["net"]), st.net[:E])
        out["flow_px"] = torch.sqrt(((g(a["target"]).double() - st.target[:E].double()) ** 2)
                                    .sum(-1).mean()).item()
        out["weight_gap"] = _rel(g(a["weight"]), st.weight[:E])
    if check.kind == "init":
        out["init_net_gap"], out["init_weight_gap"] = out.pop("net_gap"), out.pop("weight_gap")
        out["flow_px"] = 0.0
        out["net_gap"] = out["weight_gap"] = 0.0
        return out
    mid = ref.mid or {}
    if "poses" in mid:
        P0, d0 = mid["poses"], mid["dvec"]
        if P0.shape[0] == n + 1:  # a keyframe was culled after the round
            k = n + 1 - cfg.KEYFRAME_INDEX
            P0, d0 = _drop_row(P0, k, 1), _drop_row(d0, k, cfg.PATCHES_PER_FRAME)
        out["pose_gap"] = _rel(g(a["poses"]), st.poses[:n], P0)
        out["depth_gap"] = _rel(g(a["dvec"]), st.dvec[:m], d0)
    return out


def run_reference(check, seq, cfg_dict, weights, ht, wd, device, precision="f32") -> dict:
    """The reference's numbers for one check (``compare``)."""
    from bench_port.reference.config import Config
    from bench_port.reference.runtime.dpvo import DPVO

    cfg = Config(**cfg_dict)
    ref = DPVO(cfg, weights, ht, wd, device, draws=seq.draws, precision=precision)
    ref.load_state(check.before, lambda f: seq.frames[f])
    ref.mid = None
    theirs = list(check.kf_mags or ())
    ref.follow = (theirs, KEYFRAME_BAND)
    ref(check.frame, seq.frames[check.frame], seq.intrinsics)
    out = compare(check, ref, cfg)
    gaps = [abs(a - b) / abs(b) for a, b in zip(theirs, ref.kf_mags) if b]
    out.update(kf_gap=max(gaps, default=0.0), kf_followed=ref.kf_followed)
    del ref
    return out


def judge(checks, seqs, cfg_dict, weights, ht, wd, device, precision="f32") -> list:
    """Each done check's numbers, with its sequence, kind and frame."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        rows = []
        for c in checks:
            if not c.done:
                continue
            with torch.no_grad():
                nums = run_reference(c, seqs[c.seq], cfg_dict, weights, ht, wd, device, precision)
            rows.append(dict(seq=c.seq, kind=c.kind, frame=c.frame, **nums))
        return rows
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def verdict(rows, limits: dict, expected: int):
    """(correct, numbers) where numbers maps each name to its largest
    reading over the checks and its limit; fewer checks than expected, a
    limit missing or a reading that is not finite is not correct."""
    numbers = {}
    ok = len(rows) >= expected and len(rows) > 0
    for k in NUMBERS:
        v = max((r[k] for r in rows), default=math.inf)
        lim = limits.get(k)
        ok = ok and lim is not None and v <= lim
        # a reading that is not finite (no check, or a zero reference) prints as null
        numbers[k] = {"value": v if math.isfinite(v) else None, "limit": lim}
    numbers["checks"] = {"value": len(rows), "limit": expected}
    return ok, numbers
