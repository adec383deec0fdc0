"""Device-resident VO state — port of ``dpvo_tpu/runtime/state.py``.

A small dataclass of tensors. Unlike the JAX package's immutable tuple,
the step functions update these buffers in place. Edge topology lives on
the host (``runtime/topology.py``); the active edges' payloads occupy
the first ``len(topology.ii)`` rows of ``net``/``target``/``weight``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dpvo_tpu_torch.config import Config


@dataclass
class VOState:
    poses: torch.Tensor        # [N, 7] world-to-camera (t, q)
    patches: torch.Tensor      # [N*M, 3, P, P]; depth plane = ingest-time init
    dvec: torch.Tensor         # [N*M] live inverse depth, one per patch
    intrinsics: torch.Tensor   # [N, 4] (fx, fy, cx, cy) at 1/4 res
    colors: torch.Tensor       # [N, M, 3] uint8 patch colours, BGR (viewer/export)
    imap: torch.Tensor         # [pmem*M, DIM]        patch context
    gmap: torch.Tensor         # [pmem*M, FDIM, P, P] patch matching features
    fmap1: torch.Tensor        # [mem, h, w, FDIM]    frame features, 1x (NHWC)
    fmap2: torch.Tensor        # [mem, h/4, w/4, FDIM] frame features, 4x (NHWC)
    net: torch.Tensor          # [E_MAX, DIM] update-operator hidden state
    target: torch.Tensor       # [E_MAX, 2]
    weight: torch.Tensor       # [E_MAX, 2]
    target_inac: torch.Tensor  # [E_INAC_MAX, 2] retired edges (for global BA)
    weight_inac: torch.Tensor  # [E_INAC_MAX, 2]


def make_state(cfg: Config, ht: int, wd: int, device) -> VOState:
    """Allocate zero state for images of (ht, wd) pixels."""
    N, M, P = cfg.BUFFER_SIZE, cfg.PATCHES_PER_FRAME, cfg.P
    h, w = ht // cfg.RES, wd // cfg.RES
    fdt = torch.bfloat16 if cfg.MIXED_PRECISION else torch.float32
    pmem = cfg.MAX_EDGE_AGE if cfg.LOOP_CLOSURE else cfg.PMEM

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    poses = z(N, 7)
    poses[:, 6] = 1.0
    return VOState(
        poses=poses,
        patches=z(N * M, 3, P, P),
        dvec=z(N * M),
        intrinsics=z(N, 4),
        colors=z(N, M, 3, dtype=torch.uint8),
        imap=z(pmem * M, cfg.DIM, dtype=fdt),
        gmap=z(pmem * M, cfg.FDIM, P, P, dtype=fdt),
        fmap1=z(cfg.MEM, h, w, cfg.FDIM, dtype=fdt),
        fmap2=z(cfg.MEM, h // 4, w // 4, cfg.FDIM, dtype=fdt),
        net=z(cfg.E_MAX, cfg.DIM, dtype=fdt),
        target=z(cfg.E_MAX, 2),
        weight=z(cfg.E_MAX, 2),
        target_inac=z(cfg.E_INAC_MAX, 2),
        weight_inac=z(cfg.E_INAC_MAX, 2),
    )
