"""Sorted segment sum for BA assembly and SoftAgg's grouped sums: the
CUDA kernel's wrapper (``csrc/segsum.cu``), its plain version, and the
``torch.library`` op ``dpvo_tpu_torch::segment_sum`` around both.

Port of ``dpvo_tpu/ba/segsum_pallas.py:segment_sum_sorted``: the
depth-indexed reduction of ``ba/solver.assemble_normal_eqs``. The JAX
call site sorts the payload on the way in (``payload[kd_order]``); here
the kernel reads through ``order`` itself. The op dispatches by device:
the plain version for CPU tensors, the kernel for CUDA tensors. Being an
op, it survives ``torch.export``: an exported update operator
(``deploy/export.py``) keeps it as a node and launches the kernel on the
card. Importing this module registers the op; a process that loads an
exported program imports it first. The gradient of a segment sum is a
gather of the output's gradient by segment id (the op's registered
autograd), the adjoint that XLA derives for the JAX package's sums: no
kernel of its own.

Summation order, the same in the kernel and the plain version: a
segment's rows, in the stable sorted order of their ids (edge order
within a segment), are cut into pieces of ``CHUNK`` rows counted from
the run's first row; each piece is summed row after row from 0.0 with
plain f32 adds, and the pieces' sums are then added in piece order. A
run of at most ``CHUNK`` rows is therefore the plain sequential sum. The
tracker's BA and SoftAgg, training's BA, SoftAgg and d gmap, the PGO and
the triplet BA have no longer runs of nonzero rows (padded edges add
exact zeros, which change no bit), so only the global BA's long runs are
split.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from dpvo_tpu_torch import kernels

# rows of a piece, fixed here and never derived from the card: 256 of the
# powers of two 128-512 timed on an H100 (PERF.md: 128 sums the global
# BA faster and BA's short runs slower)
CHUNK = 256


def segment_sum_plain(payload, kd, Md: int):
    """out[s] = sum of payload[e] over edges with kd[e] == s, s < Md, in
    f32 (ids outside [0, Md) dropped): [E, K] f32 or bf16 -> [Md, K] f32,
    in the order the module docstring sets out. ``index_add_`` on the CPU
    adds the rows one after another in index order, at any thread count;
    a segment of at most ``CHUNK`` rows takes one such sum in edge order
    (the stable sort keeps edge order within a segment). Where a segment
    is longer, a first ``index_add_`` sums the rows into one slot per
    (segment, piece) in edge order, and a second adds each segment's
    slots in piece order. On a CUDA tensor ``index_add_`` adds with
    atomics: the same sums in an order that varies."""
    kd = kd.long()
    E, K = payload.shape
    idx = torch.where((kd < 0) | (kd >= Md), Md, kd)
    dt = torch.promote_types(payload.dtype, torch.float32)  # f64 stays f64 (gradcheck)
    x = payload.to(dt)
    counts = torch.bincount(idx, minlength=Md + 1)[:Md]
    if Md == 0 or int(counts.max()) <= CHUNK:
        out = torch.zeros((Md + 1, K), dtype=dt, device=payload.device)
        return out.index_add_(0, idx, x)[:Md]
    # each row's place in its run: its sorted position less the run's start
    order = torch.argsort(idx, stable=True)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(E, device=kd.device)
    start = torch.cumsum(counts, 0) - counts
    pieces = (counts + CHUNK - 1) // CHUNK
    first = torch.cumsum(pieces, 0) - pieces  # each segment's first (segment, piece) slot
    n = int(pieces.sum())
    keep = idx < Md
    safe = torch.where(keep, idx, 0)
    slot = torch.where(keep, first[safe] + (pos - start[safe]) // CHUNK, n)
    partial = torch.zeros((n + 1, K), dtype=dt, device=payload.device).index_add_(0, slot, x)
    seg = torch.repeat_interleave(torch.arange(Md, device=kd.device), pieces)
    return torch.zeros((Md, K), dtype=dt, device=payload.device).index_add_(0, seg, partial[:n])


def segment_sum_backward(g, kd, Md: int, dtype):
    """d payload [E, K] of a segment sum from d out [Md, K]: g[kd[e]] where
    kd[e] is in [0, Md), else zero; in ``dtype``."""
    kd = kd.long()
    keep = (kd >= 0) & (kd < Md)
    rows = g[torch.where(keep, kd, torch.zeros_like(kd))]
    return torch.where(keep[:, None], rows, torch.zeros_like(rows)).to(dtype)


@torch.library.custom_op("dpvo_tpu_torch::segment_sum", mutates_args=(), device_types="cpu")
def _segment_sum_op(payload: torch.Tensor, kd: torch.Tensor, order: Optional[torch.Tensor],
                    Md: int) -> torch.Tensor:
    return segment_sum_plain(payload, kd, Md)


@_segment_sum_op.register_kernel("cuda")
def _segment_sum_cuda(payload, kd, order, Md):
    return _segment_sum_kernel(payload, kd, order, Md)


@_segment_sum_op.register_fake
def _segment_sum_fake(payload, kd, order, Md):
    return payload.new_empty((Md, payload.shape[1]),
                             dtype=torch.promote_types(payload.dtype, torch.float32))


def _setup_context(ctx, inputs, output):
    payload, kd, _, Md = inputs
    ctx.save_for_backward(kd)
    ctx.Md, ctx.dtype = Md, payload.dtype


def _backward(ctx, g):
    (kd,) = ctx.saved_tensors
    return segment_sum_backward(g, kd, ctx.Md, ctx.dtype), None, None, None


_segment_sum_op.register_autograd(_backward, setup_context=_setup_context)


def segment_sum(payload, kd, order, Md: int):
    """out[s] = sum of payload[e] over edges with kd[e] == s, s < Md, in
    f32; ids outside [0, Md) are dropped. Differentiable in payload.

    payload [E, K] f32 or bf16; kd [E] ids; order [E] a stable argsort of
    kd (the kernel's contract: kd[order] is non-decreasing; the plain
    version does not need it, and takes None). On the card kd and order
    are int32. A request on any other device than the CPU or a card
    raises here, before the op is dispatched (the op's fake version would
    otherwise answer it); the kernel's wrapper checks the rest."""
    if payload.device.type not in ("cpu", "cuda"):
        raise ValueError(f"segment_sum: the kernel takes CUDA tensors, got {payload.device}")
    return torch.ops.dpvo_tpu_torch.segment_sum(payload, kd, order, Md)


def _check_kernel_args(payload, kd, order):
    if order is None:
        raise ValueError("segment_sum: the kernel needs the stable order of kd")
    E = payload.shape[0]
    if payload.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"segment_sum: payload must be f32 or bf16, got {payload.dtype}")
    if kd.dtype != torch.int32 or order.dtype != torch.int32:
        raise ValueError(f"segment_sum: kd/order must be int32, got {kd.dtype}/{order.dtype}")
    if kd.shape != (E,) or order.shape != (E,):
        raise ValueError("segment_sum: kd/order must be [E]")
    kernels.require_cuda("segment_sum", payload, kd, order)


# per (device, stream): the kernel's arrival counters (int64, zero between
# launches: the warp that completes a long run resets its counter) and its
# partial sums (one row per CHUNK sorted positions), grown as needed
_workspaces = {}
_workspace_lock = threading.Lock()


def _workspace(device, stream: int, tiles: int, K: int):
    key = (device.index, stream)
    with _workspace_lock:
        arrivals, partials = _workspaces.get(key, (None, None))
        if arrivals is None or arrivals.numel() < tiles:
            arrivals = torch.zeros(max(1024, 1 << (tiles - 1).bit_length()), dtype=torch.int64,
                                   device=device)
        if partials is None or partials.numel() < tiles * K:
            partials = torch.empty(max(1 << 16, 1 << (tiles * K - 1).bit_length()),
                                   dtype=torch.float32, device=device)
        _workspaces[key] = arrivals, partials
    return arrivals, partials


def _segment_sum_kernel(payload, kd, order, Md: int):
    _check_kernel_args(payload, kd, order)
    E, K = payload.shape
    lib = kernels.load()
    out = torch.empty((Md, K), dtype=torch.float32, device=payload.device)
    bf16 = payload.dtype == torch.bfloat16
    stream = kernels.stream_ptr(payload)
    arrivals, partials = _workspace(payload.device, stream, -(-E // CHUNK), K)
    rc = lib.dpvo_segment_sum(payload.data_ptr(), kd.data_ptr(), order.data_ptr(),
                              out.data_ptr(), partials.data_ptr(), arrivals.data_ptr(), E, K, Md,
                              CHUNK, int(bf16), stream)
    kernels.check("segment_sum", rc)
    kernels.count("segsum_bf16" if bf16 else "segsum")
    return out
