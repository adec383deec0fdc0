"""Segment sum of the plain reference: ``index_add_`` in f32 (f64 stays
f64). Frozen from the port's plain version (``dpvo_tpu_torch/ba/
segsum.py:segment_sum_plain``) without its fixed summation order: on the
card ``index_add_`` adds with atomics, which moves a reference sum by
f32 rounding only."""

from __future__ import annotations

import torch


def segment_sum(payload, kd, order, Md: int):
    """out[s] = sum of payload[e] over edges with kd[e] == s, s < Md
    ([E, K] -> [Md, K], at least f32); ids outside [0, Md) are dropped and
    ``order`` is ignored."""
    kd = kd.long()
    idx = torch.where((kd < 0) | (kd >= Md), Md, kd)
    dt = torch.promote_types(payload.dtype, torch.float32)
    out = torch.zeros((Md + 1, payload.shape[1]), dtype=dt, device=payload.device)
    return out.index_add_(0, idx, payload.to(dt))[:Md]
