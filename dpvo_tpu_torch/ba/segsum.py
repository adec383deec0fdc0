"""Sorted segment sum for BA assembly: the CUDA kernel's wrapper
(``csrc/segsum.cu``) and its plain version.

Port of ``dpvo_tpu/ba/segsum_pallas.py:segment_sum_sorted``: the
depth-indexed reduction of ``ba/solver.assemble_normal_eqs``. The JAX
call site sorts the payload on the way in (``payload[kd_order]``); here
the kernel reads through ``order`` itself.
"""

from __future__ import annotations

import torch

from dpvo_tpu_torch import kernels


def segment_sum_plain(payload, kd, order, Md: int):
    """The one-hot matmul of ``dpvo_tpu/ba/solver.py:220-226`` over the
    sorted rows (f32): [E, K] -> [Md, K]."""
    kd_s = kd[order].long()
    oh = (kd_s[:, None] == torch.arange(Md, device=kd.device)[None, :]).to(torch.float32)
    return oh.T @ payload[order].to(torch.float32)


def segment_sum(payload, kd, order, Md: int):
    """out[s] = sum of payload[e] over edges with kd[e] == s, s < Md.

    payload [E, K] f32; kd [E] dense ids; order [E] a stable argsort of
    kd (the kernel's contract: kd[order] is non-decreasing). On the card
    kd and order are int32."""
    if payload.device.type == "cpu":
        return segment_sum_plain(payload, kd, order, Md)
    E, K = payload.shape
    if payload.dtype != torch.float32:
        raise ValueError(f"segment_sum: payload must be f32, got {payload.dtype}")
    if kd.dtype != torch.int32 or order.dtype != torch.int32:
        raise ValueError(f"segment_sum: kd/order must be int32, got {kd.dtype}/{order.dtype}")
    if kd.shape != (E,) or order.shape != (E,):
        raise ValueError("segment_sum: kd/order must be [E]")
    kernels.require_cuda("segment_sum", payload, kd, order)
    lib = kernels.load()
    out = torch.empty((Md, K), dtype=torch.float32, device=payload.device)
    rc = lib.dpvo_segment_sum(payload.data_ptr(), kd.data_ptr(), order.data_ptr(),
                              out.data_ptr(), E, K, Md, kernels.stream_ptr(payload))
    kernels.check("segment_sum", rc)
    kernels.LAUNCHES["segsum"] += 1
    return out
