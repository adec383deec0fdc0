"""Configuration for the PyTorch/CUDA port.

A copy of ``dpvo_tpu/config.py`` (the reference package's frozen
dataclass, its ``DEFAULT``/``FAST`` profiles, ``load_config`` and the
``K=V`` override coercion) kept here so the port imports nothing of the
JAX package. The capacity knobs (``E_MAX``, ``W_OPT_MAX``, ...) keep
their meaning: the port allocates its buffers with them and sizes the
pose system and the depth reduction by them, so both packages solve the
same padded problems. ``CORR_IMPL`` selects the correlation variant as
in the JAX tracker (``runtime/steps.py:StepFunctions``): ``auto`` and
``xla`` the exact windows, ``pallas``, ``pallas_sw``, ``pallas_dma`` and
``pallas_fused`` the functions of the JAX kernels of those names. The
TPU-only pipelining knobs (``PIPELINE_DEPTH``, ``E_BUCKETS``) are
accepted so the same YAML files load, and are ignored: the port applies
the keyframe decision inline and runs on the live edge count.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import yaml


@dataclass(frozen=True)
class Config:
    # ---- buffers / patch budget ----
    BUFFER_SIZE: int = 4096
    PATCHES_PER_FRAME: int = 80
    REMOVAL_WINDOW: int = 20
    OPTIMIZATION_WINDOW: int = 12
    PATCH_LIFETIME: int = 12

    # ---- patch selection ----
    CENTROID_SEL_STRAT: str = "RANDOM"   # RANDOM | GRADIENT_BIAS (not ported)

    # ---- keyframing ----
    KEYFRAME_INDEX: int = 4
    KEYFRAME_THRESH: float = 12.5
    KEYFRAME_SYNC: bool = False          # accepted, ignored (always inline)
    PIPELINE_DEPTH: int = 1              # accepted, ignored (always inline)

    # ---- motion model ----
    MOTION_MODEL: str = "DAMPED_LINEAR"
    MOTION_DAMPING: float = 0.5

    MIXED_PRECISION: bool = True         # bf16 feature maps / update operator

    # ---- loop closure (not ported yet; must stay off) ----
    LOOP_CLOSURE: bool = False
    BACKEND_THRESH: float = 64.0
    MAX_EDGE_AGE: int = 1000
    GLOBAL_OPT_FREQ: int = 15
    CLASSIC_LOOP_CLOSURE: bool = False
    LOOP_CLOSE_WINDOW_SIZE: int = 3
    LOOP_RETR_THRESH: float = 0.04

    # ---- network architecture constants ----
    P: int = 3
    DIM: int = 384
    FDIM: int = 128
    RES: int = 4
    CORR_RADIUS: int = 3
    CORR_LEVELS: int = 2

    # ---- capacities ----
    E_MAX: int = 36864
    E_INAC_MAX: int = 131072
    W_OPT_MAX: int = 16
    M_OPT_MAX: int = 2048
    GBA_POSES_MAX: int = 2048
    GBA_DEPTHS_MAX: int = 65536
    GBA_EDGES_MAX: int = 172032
    GBA_KPAIRS_MAX: int = 3145728
    PMEM: int = 36
    MEM: int = 36

    # ---- solver details ----
    BA_LMBDA: float = 1e-4
    BA_EP: float = 1.0
    BA_LM: float = 1e-4
    BA_RESIDUAL_CLIP: float = 128.0
    BA_BORDER: float = 64.0
    BA_MIN_Z: float = 0.2
    BA_ITERS: int = 2
    GBA_ITERS: int = 2

    # ---- correlation variant: auto | xla | pallas | pallas_sw | pallas_dma | pallas_fused
    # (auto = xla, exact windows; see runtime/steps.py:CORR_IMPLS) ----
    CORR_IMPL: str = "auto"
    # ---- accepted for YAML compatibility, ignored by the port ----
    E_BUCKETS: str = "auto"

    @property
    def CORR_WIDTH(self) -> int:
        """Flattened canonical corr-feature width fed to the update
        operator: P^2 patch pixels x CORR_LEVELS x (2r+2)^2 window."""
        return self.P * self.P * self.CORR_LEVELS * (2 * self.CORR_RADIUS + 2) ** 2

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT = Config()
FAST = Config(
    PATCHES_PER_FRAME=48,
    REMOVAL_WINDOW=16,
    OPTIMIZATION_WINDOW=7,
    PATCH_LIFETIME=11,
    KEYFRAME_THRESH=15.0,
    W_OPT_MAX=12,
    E_MAX=16384,
)


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    """Load a Config from a YAML profile plus ``K=V`` overrides."""
    cfg = Config()
    if path:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        cfg = cfg.replace(**{k: _coerce(cfg, k, v) for k, v in data.items()})
    if overrides:
        cfg = cfg.replace(**{k: _coerce(cfg, k, v) for k, v in overrides.items()})
    return cfg


def _coerce(cfg: Config, key: str, val):
    if not hasattr(cfg, key):
        raise KeyError(f"Unknown config key: {key}")
    cur = getattr(cfg, key)
    if isinstance(cur, bool):
        if isinstance(val, str):
            return val.lower() in ("1", "true", "yes", "on")
        return bool(val)
    return type(cur)(val)
