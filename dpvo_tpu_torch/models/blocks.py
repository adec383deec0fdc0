"""Building blocks of the update operator — port of
``dpvo_tpu/models/blocks.py``.

Submodule names follow the flax parameter tree (``Dense_0``, ``MLP2_0``)
so the weight import maps keys one to one.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

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


def segment_softmax(x, seg, num_segments: int, valid=None):
    """Softmax over groups of rows. x [E, C]; seg [E] in [0, num_segments);
    rows with valid=False contribute nothing and receive weight 0."""
    if valid is not None:
        seg = torch.where(valid, seg, torch.full_like(seg, num_segments))
    ns = num_segments + 1
    idx = seg[:, None].expand_as(x)
    m = torch.full((ns, x.shape[1]), float("-inf"), dtype=x.dtype, device=x.device)
    m = m.scatter_reduce(0, idx, x, reduce="amax", include_self=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(x - m[seg])
    if valid is not None:
        e = e * valid[:, None].to(e.dtype)
    den = torch.zeros((ns, x.shape[1]), dtype=e.dtype, device=x.device).index_add_(0, seg, e)
    return e / torch.clamp(den[seg], min=1e-9)


class SoftAgg(nn.Module):
    """Grouped attention pooling, expanded back to rows:

        w = scatter_softmax(g(x), groups)
        y = scatter_sum(f(x) * w, groups)
        out = h(y)[groups]

    At ``num_segments >= 256`` (the runtime's case) the softmax is
    shifted by the global per-channel max over valid rows and both
    grouped sums ride one f32-accumulated reduction (``index_add_``) of
    a payload rounded to the module dtype, as the JAX one-hot matmul
    does; below that, ``segment_softmax``.
    """

    def __init__(self, dim: int, matmul_threshold: int = 256):
        super().__init__()
        self.dim = dim
        self.matmul_threshold = matmul_threshold
        self.Dense_0 = nn.Linear(dim, dim)
        self.Dense_1 = nn.Linear(dim, dim)
        self.Dense_2 = nn.Linear(dim, dim)

    def forward(self, x, seg, num_segments: int, valid=None):
        fx = self.Dense_0(x)
        gx = self.Dense_1(x)
        if num_segments >= self.matmul_threshold:
            g32 = gx.to(torch.float32)
            masked = g32 if valid is None else torch.where(
                valid[:, None], g32, torch.full_like(g32, float("-inf")))
            m = masked.amax(dim=0)
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            e = torch.exp(g32 - m[None])
            if valid is not None:
                e = e * valid[:, None].to(e.dtype)
            payload = torch.cat([fx.to(torch.float32) * e, e], dim=1).to(x.dtype)
            sums = torch.zeros((num_segments, 2 * self.dim), dtype=torch.float32,
                               device=x.device).index_add_(0, seg, payload.to(torch.float32))
            y = (sums[:, : self.dim] / torch.clamp(sums[:, self.dim:], min=1e-9)).to(x.dtype)
        else:
            w = segment_softmax(gx.to(torch.float32), seg, num_segments, valid).to(x.dtype)
            seg_safe = seg if valid is None else torch.where(
                valid, seg, torch.full_like(seg, num_segments))
            y = torch.zeros((num_segments + 1, self.dim), dtype=x.dtype,
                            device=x.device).index_add_(0, seg_safe, fx * w)[:num_segments]
        return self.Dense_2(y)[seg]
