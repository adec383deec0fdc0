"""Sorted segment sum for BA assembly and SoftAgg's grouped sums: the
CUDA kernel's wrapper (``csrc/segsum.cu``) and its plain version.

Port of ``dpvo_tpu/ba/segsum_pallas.py:segment_sum_sorted``: the
depth-indexed reduction of ``ba/solver.assemble_normal_eqs``. The JAX
call site sorts the payload on the way in (``payload[kd_order]``); here
the kernel reads through ``order`` itself.
"""

from __future__ import annotations

import torch

from dpvo_tpu_torch import kernels


def segment_sum_plain(payload, kd, Md: int):
    """out[s] = sum of payload[e] over edges with kd[e] == s, s < Md, in
    f32 (ids outside [0, Md) dropped): [E, K] f32 or bf16 -> [Md, K] f32.
    ``index_add_`` on the CPU adds the rows one after another in edge
    order, which is the kernel's order (the stable sort keeps edge order
    within a segment), so the two give the same bits, at any thread
    count. On a CUDA tensor ``index_add_`` adds with atomics: the same
    sums in an order that varies."""
    kd = kd.long()
    idx = torch.where((kd < 0) | (kd >= Md), Md, kd)
    out = torch.zeros((Md + 1, payload.shape[1]), dtype=torch.float32, device=payload.device)
    return out.index_add_(0, idx, payload.float())[:Md]


def segment_sum(payload, kd, order, Md: int):
    """out[s] = sum of payload[e] over edges with kd[e] == s, s < Md, in
    f32; ids outside [0, Md) are dropped.

    payload [E, K] f32 or bf16; kd [E] ids; order [E] a stable argsort of
    kd (the kernel's contract: kd[order] is non-decreasing; the plain
    version does not need it). On the card kd and order are int32."""
    if payload.device.type == "cpu":
        return segment_sum_plain(payload, kd, Md)
    E, K = payload.shape
    if payload.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"segment_sum: payload must be f32 or bf16, got {payload.dtype}")
    if kd.dtype != torch.int32 or order.dtype != torch.int32:
        raise ValueError(f"segment_sum: kd/order must be int32, got {kd.dtype}/{order.dtype}")
    if kd.shape != (E,) or order.shape != (E,):
        raise ValueError("segment_sum: kd/order must be [E]")
    kernels.require_cuda("segment_sum", payload, kd, order)
    lib = kernels.load()
    out = torch.empty((Md, K), dtype=torch.float32, device=payload.device)
    bf16 = payload.dtype == torch.bfloat16
    rc = lib.dpvo_segment_sum(payload.data_ptr(), kd.data_ptr(), order.data_ptr(),
                              out.data_ptr(), E, K, Md, int(bf16), kernels.stream_ptr(payload))
    kernels.check("segment_sum", rc)
    kernels.count("segsum_bf16" if bf16 else "segsum")
    return out
