"""Network container and weight import from the JAX package's ``.npz``.

``dpvo_tpu/runtime/weights.py:save_params`` writes one array per flax
parameter under a ``keystr`` path such as
``['patchifier']['params']['fnet']['ResidualBlock_2']['Conv_2']['kernel']``.
The port's modules carry the flax names, so the translation is
mechanical: Conv HWIO -> OIHW, Dense [in, out] -> Linear [out, in],
flax LayerNorm ``scale``/``bias`` -> ``weight``/``bias`` (its inner
``LayerNorm_0`` level dropped). A frozen copy of the loading half of the
port's ``runtime/weights.py``.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from bench_port.reference.config import Config
from bench_port.reference.models.patchifier import Patchifier
from bench_port.reference.models.update import Update

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
