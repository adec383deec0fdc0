"""Network container and weight import from the JAX package's ``.npz``.

``dpvo_tpu/runtime/weights.py:save_params`` writes one array per flax
parameter under a ``keystr`` path such as
``['patchifier']['params']['fnet']['ResidualBlock_2']['Conv_2']['kernel']``.
The port's modules carry the flax names, so the translation is
mechanical: Conv HWIO -> OIHW, Dense [in, out] -> Linear [out, in],
flax LayerNorm ``scale``/``bias`` -> ``weight``/``bias`` (its inner
``LayerNorm_0`` level dropped). ``params_to_jax`` is the inverse, key for
key (training snapshots in the ``save_params`` format, which both
packages' trackers load). ``init_networks`` draws a fresh start from
flax's initialisers' distributions (not their draws).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from dpvo_tpu_torch.config import Config
from dpvo_tpu_torch.models.patchifier import Patchifier
from dpvo_tpu_torch.models.update import Update

_PART = re.compile(r"\['([^'\]]*)'\]")


class Networks(nn.Module):
    """The two trained networks of the tracker."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.patchifier = Patchifier(patch_size=cfg.P, dim=cfg.DIM, fdim=cfg.FDIM)
        self.update = Update(dim=cfg.DIM, corr_width=cfg.CORR_WIDTH)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def params_from_jax(flat: Dict[str, np.ndarray]) -> "OrderedDict[str, torch.Tensor]":
    """State dict of ``Networks`` from the flat flax keys; every key is
    consumed exactly once, or this raises."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key, arr in flat.items():
        parts = _PART.findall(key)
        if "".join(f"['{p}']" for p in parts) != key or len(parts) < 4 or parts[1] != "params":
            raise KeyError(f"not a flax parameter path: {key}")
        path, leaf = [parts[0]] + parts[2:-1], parts[-1]
        a = np.asarray(arr, np.float32)
        if leaf == "kernel" and a.ndim == 4:
            name, a = "weight", a.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and a.ndim == 2:
            name, a = "weight", a.T
        elif leaf == "scale" and a.ndim == 1:
            name = "weight"
        elif leaf == "bias" and a.ndim == 1:
            name = "bias"
        else:
            raise KeyError(f"unexpected parameter {key} with shape {a.shape}")
        if len(path) >= 2 and path[-1] == "LayerNorm_0" and path[-2].startswith("LayerNorm_"):
            path = path[:-1]
        tkey = ".".join(path + [name])
        if tkey in out:
            raise KeyError(f"two flax parameters map to {tkey}")
        out[tkey] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The flat flax keys and layouts of a ``Networks`` state dict (the
    inverse of ``params_from_jax``): OIHW -> HWIO, Linear [out, in] ->
    Dense [in, out], a LayerNorm's weight -> ``scale`` under its inner
    ``LayerNorm_0``."""
    out: Dict[str, np.ndarray] = {}
    for tkey, t in state.items():
        *path, name = tkey.split(".")
        a = t.detach().to("cpu", torch.float32).numpy()
        if name == "weight" and a.ndim == 4:
            leaf, a = "kernel", a.transpose(2, 3, 1, 0)
        elif name == "weight" and a.ndim == 2:
            leaf, a = "kernel", a.T
        elif name == "weight" and a.ndim == 1 and path[-1].startswith("LayerNorm_"):
            leaf = "scale"
        elif name == "bias" and a.ndim == 1:
            leaf = "bias"
        else:
            raise KeyError(f"unexpected parameter {tkey} with shape {a.shape}")
        if path[-1].startswith("LayerNorm_"):
            path = path + ["LayerNorm_0"]
        parts = [path[0], "params"] + path[1:] + [leaf]
        out["".join(f"['{p}']" for p in parts)] = np.ascontiguousarray(a)
    return out


def save_npz(path: str, state: Dict[str, torch.Tensor]):
    """Write a state dict in the JAX package's ``save_params`` format."""
    np.savez(path, **params_to_jax(state))


LECUN_TRUNC = 0.87962566103423978  # std of the standard normal truncated to [-2, 2]


def init_networks(cfg: Config, generator: torch.Generator) -> Networks:
    """Networks with flax's default initialisers' distributions: Dense and
    Conv kernels lecun_normal (a normal truncated to +-2 std, std
    1/sqrt(fan_in) after the truncation), biases zero, LayerNorm scale one
    and bias zero."""
    nets = Networks(cfg)
    with torch.no_grad():
        for name, p in nets.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:  # LayerNorm scale
                p.fill_(1.0)
            else:
                fan_in = p[0].numel()  # Linear [out, in]: in; Conv OIHW: I*H*W
                std = (1.0 / fan_in) ** 0.5 / LECUN_TRUNC
                torch.nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
    return nets


def load_networks(cfg: Config, network=None, seed: int = 0) -> Networks:
    """Networks with weights from an ``.npz`` path, a flat flax dict, or
    (``network=None``) random initialisation from ``seed``. Loading is
    strict: a missing or unexpected parameter raises."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        nets = Networks(cfg)
    if network is not None:
        flat = load_npz(network) if isinstance(network, str) else network
        nets.load_state_dict(params_from_jax(flat), strict=True)
    return nets
