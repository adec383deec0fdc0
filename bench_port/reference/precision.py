"""The control's precision: values rounded to float8 e4m3, the step below
the configuration's bf16, with a per-tensor scale that maps the largest
magnitude to e4m3's largest finite value (448), as fp8 inference scales."""

from __future__ import annotations

import torch
import torch.nn as nn

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under its per-tensor scale, in x's dtype."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


def _round_input(module, args):
    return (fp8_round(args[0]),) + tuple(args[1:])


def fp8_products(nets: nn.Module):
    """Round every convolution's and dense layer's weight (in place) and
    input (at each call) to e4m3: the products an fp8 network computes,
    accumulated in f32."""
    with torch.no_grad():
        for mod in nets.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                mod.weight.copy_(fp8_round(mod.weight))
                mod.register_forward_pre_hook(_round_input)
