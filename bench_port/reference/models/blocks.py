"""Building blocks of the update operator — port of
``dpvo_tpu/models/blocks.py``.

Submodule names follow the flax parameter tree (``Dense_0``, ``MLP2_0``)
so the weight import maps keys one to one.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from bench_port.reference.ba.segsum import segment_sum

GRAD_CLIP = 0.01


class _GradientClip(torch.autograd.Function):
    """Identity forward; backward NaN-zeroing + clamp to +-0.01."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        return g.clamp(-GRAD_CLIP, GRAD_CLIP)


def gradient_clip(x):
    return _GradientClip.apply(x)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with the reference's eps=1e-3."""

    def __init__(self, dim: int, eps: float = 1e-3):
        super().__init__(dim, eps=eps)


class MLP2(nn.Module):
    """Linear-ReLU-Linear."""

    def __init__(self, dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, dim)
        self.Dense_1 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.Dense_1(F.relu(self.Dense_0(x)))


class GatedResidual(nn.Module):
    """x + sigmoid(W_g x) * MLP(x)."""

    def __init__(self, dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, dim)
        self.MLP2_0 = MLP2(dim)

    def forward(self, x):
        return x + torch.sigmoid(self.Dense_0(x)) * self.MLP2_0(x)


def grouped_sum(x, seg, num_segments: int, order=None):
    """out[s] = sum of the rows x[e] with seg[e] == s, s < num_segments, in
    f32 (rows of a larger seg are dropped); x f32 or bf16, whose values
    convert to f32 exactly. On the card through the sorted segment-sum
    kernel (``ba/segsum.py``), which reads a bf16 x as it is: a fixed
    summation order, so the card gives the same bits on every run, where
    ``index_add_`` sums with float atomics in an order that varies. On the
    CPU its plain version, whose ``index_add_`` there adds the rows one
    after another: the same bits as the kernel. The order is the segment
    sum's: row after row in edge order within pieces of ``CHUNK`` rows,
    the pieces then in order; SoftAgg's groups (<= 96 rows with a nonzero
    payload) take one piece, the sequential sum. order: a stable argsort of
    seg for the kernel, computed here when not given. Differentiable in x
    (the op ``ba/segsum.segment_sum``)."""
    if order is None and x.device.type != "cpu":
        order = torch.argsort(seg, stable=True).to(seg.dtype)
    return segment_sum(x.contiguous(), seg, order, num_segments)


def segment_softmax(x, seg, num_segments: int, valid=None, group=None):
    """Softmax over groups of rows. x [E, C]; seg [E] in [0, num_segments);
    rows with valid=False contribute nothing and receive weight 0. group
    (``parallel.shard.EdgeSplit``): the groups' rows lie on the ranks of a
    split unroll, x holding this rank's; each group's maximum (without a
    gradient) and sum are taken over the ranks."""
    if valid is not None:
        seg = torch.where(valid, seg, torch.full_like(seg, num_segments))
    ns = num_segments + 1
    idx = seg[:, None].expand_as(x).long()
    m = torch.full((ns, x.shape[1]), float("-inf"), dtype=x.dtype, device=x.device)
    m = m.scatter_reduce(0, idx, x, reduce="amax", include_self=True)  # order-free: max
    if group is not None:
        m = group.max(m)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(x - m[seg])
    if valid is not None:
        e = e * valid[:, None].to(e.dtype)
    den = grouped_sum(e, seg, ns).to(e.dtype)
    if group is not None:
        den = group.sum(den)[0]
    return e / torch.clamp(den[seg], min=1e-9)


class SoftAgg(nn.Module):
    """Grouped attention pooling, expanded back to rows:

        w = scatter_softmax(g(x), groups)
        y = scatter_sum(f(x) * w, groups)
        out = h(y)[groups]

    At ``num_segments >= 256`` (the default configuration's case) the
    softmax is shifted by the global per-channel max over valid rows and
    both grouped sums ride one f32-accumulated reduction of a payload
    rounded to the module dtype, as the JAX one-hot matmul does; below
    that (the tiny configuration's patch groups), ``segment_softmax``.
    Every grouped sum goes through ``grouped_sum`` (the sorted segment-sum
    kernel on the card), so the tracker is reproducible run to run.

    In a training unroll split over the mesh's edge axis, x holds this
    rank's rows and ``group`` is the split (``parallel.shard.EdgeSplit``):
    the branch is still chosen by the whole unroll's ``num_segments``, and
    the global per-channel max is taken over the ranks (the same bits as in
    one process). ``shared`` > 0 says that the groups' rows lie on several
    ranks (the frame pairs): the grouped sums then cover the groups [0,
    shared) only and are summed over the ranks. Otherwise every group lies
    on this rank whole (the patches) and its sums stay local.
    """

    def __init__(self, dim: int, matmul_threshold: int = 256):
        super().__init__()
        self.dim = dim
        self.matmul_threshold = matmul_threshold
        self.Dense_0 = nn.Linear(dim, dim)
        self.Dense_1 = nn.Linear(dim, dim)
        self.Dense_2 = nn.Linear(dim, dim)

    def forward(self, x, seg, num_segments: int, valid=None, order=None, group=None,
                shared: int = 0):
        fx = self.Dense_0(x)
        gx = self.Dense_1(x)
        n = shared or num_segments  # the rows of the grouped sums

        def gsum(*args):
            out = grouped_sum(*args)
            return group.sum(out)[0] if shared else out

        if num_segments >= self.matmul_threshold:
            g32 = gx.to(torch.float32)
            masked = g32 if valid is None else torch.where(
                valid[:, None], g32, torch.full_like(g32, float("-inf")))
            m = masked.amax(dim=0)
            if group is not None:
                m = group.max(m)
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            e = torch.exp(g32 - m[None])
            if valid is not None:
                e = e * valid[:, None].to(e.dtype)
            # invalid rows carry e = 0, so they add nothing to their group
            payload = torch.cat([fx.to(torch.float32) * e, e], dim=1).to(x.dtype)
            sums = gsum(payload, seg, n, order)
            y = (sums[:, : self.dim] / torch.clamp(sums[:, self.dim:], min=1e-9)).to(x.dtype)
        else:
            w = segment_softmax(gx.to(torch.float32), seg, n, valid,
                                group if shared else None).to(x.dtype)
            seg_safe = seg if valid is None else torch.where(
                valid, seg, torch.full_like(seg, n))
            y = gsum(fx * w, seg_safe, n).to(x.dtype)
        return self.Dense_2(y)[seg]
