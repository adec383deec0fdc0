"""Proximity loop closure — the DPV-SLAM "fast" backend; port of
``dpvo_tpu/slam/proximity.py``.

PatchGraph.edges_loop (dpvo/patchgraph.py:65-91) and the numba NMS
reduce_edges (dpvo/loop_closure/optim_utils.py:24-60): every
GLOBAL_OPT_FREQ frames, propose edges from old patches (age <=
MAX_EDGE_AGE) into recent frames, keep the frame pairs whose mean
reprojection flow is below BACKEND_THRESH with over 75% of their patches
valid, then suppress to at most 1000 pairs at least MIN_SEPARATION frames
apart. The selected pairs' edges make the tracker run its global BA.

The flow of every candidate runs on the tracker's device; the per-pair
aggregation and the NMS run in NumPy on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from dpvo_tpu_torch.geom import projective as pops
from dpvo_tpu_torch.utils import trace

LC_CAND_MAX = 1 << 20  # candidate edges scored per proposal
MIN_SEPARATION = 30    # frames between the two frames of a pair (ref optim_utils.py:37)


def _lc_flow(poses, patches_ctr, intrinsics, ii, jj, kk):
    """Flow magnitude [E] and validity [E] of candidate edges, patches
    collapsed to their centre pixel (ref patchgraph.py:80, beta 0.5)."""
    mag, val = pops.flow_mag(poses, patches_ctr, intrinsics, ii, jj, kk, beta=0.5)
    return mag[:, 0, 0], val


def reduce_edges(flow_mag, ii, jj, max_num_edges=1000, nms=1):
    """Greedy NMS over candidate frame pairs, lowest flow first: at most
    max_num_edges pairs [K, 2] of (i, j), each j - i >= MIN_SEPARATION with
    flow below 1000; a kept (i, j) suppresses (i +- nms, j)."""
    es = []
    if ii.size == 0:
        return np.zeros((0, 2), np.int64)
    Ni, Nj = ii.max() + 1, jj.max() + 1
    ignore = np.zeros((Ni, Nj), bool)
    for idx in np.argsort(flow_mag):
        if len(es) >= max_num_edges:
            break
        i, j, mag = ii[idx], jj[idx], flow_mag[idx]
        if (j - i) < MIN_SEPARATION or mag >= 1000 or ignore[i, j]:
            continue
        es.append((i, j))
        for di in range(-nms, nms + 1):
            if 0 <= i + di < Ni:
                ignore[i + di, j] = True
    return np.asarray(es, np.int64).reshape(-1, 2)


def edges_loop(slam):
    """Propose loop-closure edges (kk, jj) for the tracker's current graph
    (ref patchgraph.py:65-91): the patches of frames [l - MAX_EDGE_AGE, l),
    l = n - REMOVAL_WINDOW, against frames [n - GLOBAL_OPT_FREQ, n -
    KEYFRAME_INDEX). Past LC_CAND_MAX candidates the oldest source frames
    are left out (the JAX package keeps the newest LC_CAND_MAX candidates,
    which splits a frame and stops its per-frame reshape)."""
    cfg = slam.cfg
    M = cfg.PATCHES_PER_FRAME
    n = slam.n
    none = np.zeros(0, np.int64), np.zeros(0, np.int64)
    l = n - cfg.REMOVAL_WINDOW
    if l <= 0:
        return none
    jj_r = np.arange(max(n - cfg.GLOBAL_OPT_FREQ, 0), n - cfg.KEYFRAME_INDEX)
    if len(jj_r) == 0:
        return none
    lo = max(l - cfg.MAX_EDGE_AGE, 0, l - LC_CAND_MAX // (len(jj_r) * M))
    kk_r = np.arange(lo * M, l * M)

    # candidates [frames, patches], row-major, built on the device
    dev = slam.device
    kk = torch.arange(lo * M, l * M, device=dev).repeat(len(jj_r))
    with trace.blocked("upload", "loop_frames", dev):
        jj = torch.as_tensor(jj_r, device=dev)
    jj = jj.repeat_interleave(len(kk_r))
    st = slam.state
    c = cfg.P // 2
    ctr = torch.cat([st.patches[:, :2, c:c + 1, c:c + 1], st.dvec[:, None, None, None]], 1)
    mag, val = _lc_flow(st.poses, ctr, st.intrinsics, kk // M, jj, kk)
    with trace.blocked("wait", "loop_flow", dev, 2):
        mag = mag.cpu().numpy().reshape(len(jj_r), -1)  # [frames, patches]
        val = val.cpu().numpy().reshape(len(jj_r), -1)

    # per frame pair, in M-patch blocks
    fl = mag.shape[1] // M
    mag_sum = (mag * val).reshape(len(jj_r), fl, M).sum(-1)
    num_val = np.maximum(val.reshape(len(jj_r), fl, M).sum(-1), 1)
    flow = np.where(num_val > (M * 0.75), mag_sum / num_val, np.inf)

    pair_ii = (kk_r.reshape(fl, M)[:, 0] // M)[None, :].repeat(len(jj_r), 0)
    pair_jj = jj_r[:, None].repeat(fl, 1)
    mask = flow < cfg.BACKEND_THRESH

    es = reduce_edges(flow[mask], pair_ii[mask], pair_jj[mask], max_num_edges=1000, nms=1)
    if len(es) == 0:
        return none
    ei, ej = es[:, 0], es[:, 1]
    kk_out = (ei[:, None] * M + np.arange(M)[None, :]).reshape(-1)
    jj_out = np.repeat(ej, M)
    return kk_out, jj_out
