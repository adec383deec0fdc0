"""Feature encoders — ``nn.Module`` port of ``dpvo_tpu/models/extractor.py``.

BasicEncoder4: 7x7/s2 stem + two 2-block residual stages (stride 1, 2)
+ 1x1 head, giving 1/4-resolution features. The public ``forward``
keeps the JAX package's NHWC layout; the convolutions run NCHW inside.
Submodule names follow the flax parameter tree (``Conv_0``,
``ResidualBlock_2.Conv_2``, ...) so ``runtime/weights.params_from_jax``
maps keys one to one.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

STEM_DIM = 32


class InstanceNorm(nn.Module):
    """Per-sample, per-channel spatial normalization, no affine, eps 1e-5,
    computed in f32 and returned in the input dtype (NCHW)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=(-2, -1), keepdim=True)
        var = x32.var(dim=(-2, -1), unbiased=False, keepdim=True)
        return ((x32 - mean) / torch.sqrt(var + self.eps)).to(x.dtype)


def _norm(norm_fn: str) -> nn.Module:
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "none":
        return nn.Identity()
    raise NotImplementedError(norm_fn)


class ResidualBlock(nn.Module):
    """conv3x3-norm-relu x2 with an optional strided 1x1 shortcut (NCHW)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance", stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.Conv_1 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm = _norm(norm_fn)
        self.Conv_2 = (nn.Conv2d(in_planes, planes, 1, stride=stride)
                       if stride != 1 or in_planes != planes else None)

    def forward(self, x):
        y = F.relu(self.norm(self.Conv_0(x)))
        y = F.relu(self.norm(self.Conv_1(y)))
        if self.Conv_2 is not None:
            x = self.norm(self.Conv_2(x))
        return F.relu(x + y)


class BasicEncoder4(nn.Module):
    """1/4-resolution encoder: [B, H, W, 3] -> [B, H/4, W/4, output_dim]."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "instance"):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, STEM_DIM, 7, stride=2, padding=3)
        self.norm = _norm(norm_fn)
        self.ResidualBlock_0 = ResidualBlock(STEM_DIM, STEM_DIM, norm_fn, 1)
        self.ResidualBlock_1 = ResidualBlock(STEM_DIM, STEM_DIM, norm_fn, 1)
        self.ResidualBlock_2 = ResidualBlock(STEM_DIM, 2 * STEM_DIM, norm_fn, 2)
        self.ResidualBlock_3 = ResidualBlock(2 * STEM_DIM, 2 * STEM_DIM, norm_fn, 1)
        self.Conv_1 = nn.Conv2d(2 * STEM_DIM, output_dim, 1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.norm(self.Conv_0(x)))
        x = self.ResidualBlock_0(x)
        x = self.ResidualBlock_1(x)
        x = self.ResidualBlock_2(x)
        x = self.ResidualBlock_3(x)
        return self.Conv_1(x).permute(0, 2, 3, 1)
