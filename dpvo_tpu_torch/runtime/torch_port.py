"""Import the reference's trained encoder weights — port of
``dpvo_tpu/runtime/torch_port.py``.

The reference ships its trained fnet/inet encoders as ONNX graphs
(``onnx_models/{fnet,inet}.onnx``) whose initializers carry plain torch
state-dict names such as ``fnet.layer2.0.conv1.weight``. This module reads
the ONNX protobuf directly (no onnx package: only
``ModelProto.graph.initializer``) and loads the tensors into the port's
Patchifier, whose submodules carry the flax names:

  reference                  port (``models/extractor.py``)
  fnet.conv1.*            -> fnet.Conv_0            (7x7/s2 stem)
  fnet.layer1.{0,1}.*     -> fnet.ResidualBlock_{0,1}
  fnet.layer2.{0,1}.*     -> fnet.ResidualBlock_{2,3}
  ...conv1/conv2          ->   Conv_0 / Conv_1
  ...downsample.0         ->   Conv_2
  fnet.conv2.*            -> fnet.Conv_1            (1x1 head)
  (same for inet)

Both sides are torch convolutions, so the OIHW kernels go in as they are.
The instance norms carry no parameters. The update operator's weights do
not port: its correlation features use the canonical layout of the JAX
package, which the reference's update does not read.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# --- minimal protobuf wire-format reader (ModelProto subset) ---


def _read_varint(b: bytes, i: int):
    x = 0
    s = 0
    while True:
        v = b[i]
        i += 1
        x |= (v & 0x7F) << s
        if not v & 0x80:
            return x, i
        s += 7


def _fields(b: bytes):
    i = 0
    while i < len(b):
        tag, i = _read_varint(b, i)
        fn, wt = tag >> 3, tag & 7
        if wt == 2:
            ln, i = _read_varint(b, i)
            yield fn, b[i:i + ln]
            i += ln
        elif wt == 0:
            v, i = _read_varint(b, i)
            yield fn, v
        elif wt == 5:
            yield fn, b[i:i + 4]
            i += 4
        elif wt == 1:
            yield fn, b[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")


_ONNX_DTYPES = {1: np.float32, 6: np.int32, 7: np.int64, 10: np.float16}


def parse_onnx_weights(path: str) -> Dict[str, np.ndarray]:
    """Extract {initializer name: array} from an ONNX file."""
    with open(path, "rb") as f:
        data = f.read()
    graph = None
    for fn, v in _fields(data):
        if fn == 7:  # ModelProto.graph
            graph = v
    if graph is None:
        raise ValueError(f"{path}: no graph")
    out = {}
    for fn, v in _fields(graph):
        if fn != 5:  # GraphProto.initializer
            continue
        name, dims, dtype, raw = None, [], 1, b""
        for f2, v2 in _fields(v):
            if f2 == 1:
                dims.append(v2)
            elif f2 == 2:
                dtype = v2
            elif f2 == 8:
                name = v2.decode()
            elif f2 == 9:
                raw = v2
        arr = np.frombuffer(raw, _ONNX_DTYPES[dtype]).reshape(dims)
        out[name] = arr.astype(np.float32)
    return out


# --- mapping onto the port's Patchifier ---

_BLOCKS = (("layer1.0", 0), ("layer1.1", 1), ("layer2.0", 2), ("layer2.1", 3))


def encoder_state(tensors: Dict[str, np.ndarray], net: str) -> Dict[str, np.ndarray]:
    """The state dict of the port's encoder ``net`` ("fnet" or "inet"),
    popped from the reference's tensors (a missing one raises KeyError)."""
    out = {}

    def conv(src, dst):
        for leaf in ("weight", "bias"):
            out[f"{dst}.{leaf}"] = tensors.pop(f"{net}.{src}.{leaf}")

    conv("conv1", "Conv_0")
    conv("conv2", "Conv_1")
    for tname, bi in _BLOCKS:
        conv(f"{tname}.conv1", f"ResidualBlock_{bi}.Conv_0")
        conv(f"{tname}.conv2", f"ResidualBlock_{bi}.Conv_1")
        if f"{net}.{tname}.downsample.0.weight" in tensors:
            conv(f"{tname}.downsample.0", f"ResidualBlock_{bi}.Conv_2")
    return out


def port_reference_encoders(nets, fnet_onnx: str, inet_onnx: str):
    """Replace the fnet/inet weights of ``Networks`` nets (in place, and
    returned) with the reference's trained encoders. Every initializer of
    the encoder is consumed exactly once and every shape must match the
    module's, or this raises."""
    for net, path in (("fnet", fnet_onnx), ("inet", inet_onnx)):
        tensors = parse_onnx_weights(path)
        ported = encoder_state(tensors, net)
        leftover = [k for k in tensors if k.startswith(net + ".")]
        if leftover:
            raise ValueError(f"unmapped reference tensors: {leftover}")
        module = getattr(nets.patchifier, net)
        own = module.state_dict()
        for k, arr in ported.items():
            if k not in own:
                raise ValueError(f"{net}.{k}: no such parameter in the port's encoder")
            if tuple(own[k].shape) != tuple(arr.shape):
                raise ValueError(f"{net}.{k}: shape {arr.shape} != {tuple(own[k].shape)}")
        module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(a))
                                for k, a in ported.items()}, strict=True)
    return nets
