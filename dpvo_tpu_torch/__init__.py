"""dpvo_tpu_torch — the PyTorch/CUDA port of dpvo_tpu for NVIDIA Hopper.

A second package beside the JAX one (``dpvo_tpu/``, the reference it is
tested against); it imports neither JAX nor anything of ``dpvo_tpu``.
Plain tensor code is PyTorch; each TPU (Pallas) kernel on the ported
path is a CUDA C++ kernel written for ``sm_90a`` (``csrc/``, built at
first use by ``kernels.py``), with a plain PyTorch version beside it
that runs for CPU tensors.

Layers (mirroring ``dpvo_tpu``):
  lie/      SE(3)/SO(3)/Sim(3)          geom/     projective ops
  ops/      patchify + correlation      models/   encoders + update operator
  ba/       window and global BA        runtime/  VO state machine (DPVO)
  slam/     both loop closures          eval/     ATE, writers, protocol
  train/    losses, optimizer, steps    data/     clips, readers, TartanAir
  deploy/   torch.export programs       apps/     entry points, viewer
  parallel/ process mesh, distributed BA
  utils/    synthetic scenes, numpy SE(3), optional imports, Timer
"""

from dpvo_tpu_torch.config import Config, load_config  # noqa: F401


def __getattr__(name):
    # DPVO on first use: a reader or viewer process, which the spawn context
    # starts by importing this package, then imports no torch
    if name == "DPVO":
        from dpvo_tpu_torch.runtime.dpvo import DPVO
        return DPVO
    raise AttributeError(f"module 'dpvo_tpu_torch' has no attribute {name!r}")
