"""DPVO runtime — host orchestrator of the port, after
``dpvo_tpu/runtime/dpvo.py``.

Sequencing: patchify -> ingest -> (motion probe until initialized) ->
edge append -> update (operator + sliding-window BA) -> keyframe cull
and edge retirement. The keyframe decision is applied inline, before the
next frame, which gives the trajectory of the JAX runtime at
``PIPELINE_DEPTH=1``. Loop closure is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dpvo_tpu_torch.ba.spd_solve import MAX_N as SPD_MAX_N
from dpvo_tpu_torch.config import Config
from dpvo_tpu_torch.lie import se3
from dpvo_tpu_torch.models.patchifier import random_centroids
from dpvo_tpu_torch.runtime.state import make_state
from dpvo_tpu_torch.runtime.steps import StepFunctions, edge_tensors
from dpvo_tpu_torch.runtime.topology import Topology
from dpvo_tpu_torch.runtime.weights import load_networks


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one this raises instead of
    running on the CPU (pass ``device="cpu"`` for that)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("DPVO: no CUDA device is available; pass device='cpu' to run on "
                           "the CPU")
    return dev


Draws = Callable[[int], Tuple[object, object]]


class DPVO:
    """Track a monocular camera through an image stream.

        slam = DPVO(cfg, network, ht, wd)              # device=None: the card
        for t, image, intrinsics in stream: slam(t, image, intrinsics)
        poses, tstamps = slam.terminate()

    ``draws(frame) -> (centroids [M,2], depth_init [M])`` replaces the
    two random draws of frame ``frame`` (the call index): the patch
    centroids (integer x in [1, w-1), y in [1, h-1) at 1/4 resolution)
    and the random inverse depths used before initialization. By default
    they come from a CPU ``torch.Generator`` seeded with ``seed``, so the
    draws do not depend on the device.
    """

    def __init__(self, cfg: Config, network=None, ht: int = 480, wd: int = 640, device=None,
                 seed: int = 0, draws: Optional[Draws] = None):
        if cfg.LOOP_CLOSURE or cfg.CLASSIC_LOOP_CLOSURE:
            raise NotImplementedError("loop closure is not ported yet")
        if cfg.CENTROID_SEL_STRAT != "RANDOM":
            raise NotImplementedError(f"CENTROID_SEL_STRAT={cfg.CENTROID_SEL_STRAT} is not "
                                      "ported yet (RANDOM only)")
        self.cfg = cfg
        self.ht, self.wd = ht, wd
        self.device = resolve_device(device)
        if self.device.type == "cuda" and 6 * cfg.W_OPT_MAX > SPD_MAX_N:
            raise ValueError(f"DPVO: the card's pose solve takes 6 * W_OPT_MAX <= {SPD_MAX_N} "
                             f"unknowns (csrc/spd_solve.cu), got W_OPT_MAX {cfg.W_OPT_MAX}")
        if self.device.type == "cuda" and not cfg.MIXED_PRECISION:
            # f32 mode means f32: cuDNN would otherwise run convs in TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        fdt = torch.bfloat16 if cfg.MIXED_PRECISION else torch.float32
        self.nets = load_networks(cfg, network, seed).to(self.device, fdt).eval()
        self.steps = StepFunctions(cfg, self.nets, self.device)
        self.state = make_state(cfg, ht, wd, self.device)
        self.topo = Topology(cfg)
        self._gen = torch.Generator().manual_seed(seed)
        self.draws = draws if draws is not None else self._random_draws

        self.is_initialized = False
        self.counter = 0     # total frames seen
        self.tlist = []      # wall timestamps per frame
        self.tstamps = []    # counter value per kept keyframe
        self.delta = {}      # counter -> (anchor counter, rel pose np[7])

    @property
    def n(self) -> int:
        return self.topo.n

    @property
    def m(self) -> int:
        return self.topo.m

    def _random_draws(self, frame: int):
        M = self.cfg.PATCHES_PER_FRAME
        h, w = self.ht // self.cfg.RES, self.wd // self.cfg.RES
        centroids = random_centroids(M, h, w, self._gen)
        return centroids, torch.rand(M, generator=self._gen)

    def _edges(self, **kw):
        es = self.topo.edge_set(pad=len(kw["ii"]) if "ii" in kw else len(self.topo.ii), **kw)
        return edge_tensors(es, self.device)

    # ---------------- per-frame tracking ----------------

    @torch.no_grad()
    def __call__(self, tstamp, image: np.ndarray, intrinsics: np.ndarray):
        """Track one frame. image [H,W,3] uint8 RGB; intrinsics [4]."""
        cfg = self.cfg
        if (self.n + 1) >= cfg.BUFFER_SIZE - (cfg.KEYFRAME_INDEX + 5):
            raise RuntimeError(f"Buffer size {cfg.BUFFER_SIZE} too small; increase BUFFER_SIZE")
        if tuple(image.shape[:2]) != (self.ht, self.wd):
            raise ValueError(f"frame size {tuple(image.shape[:2])} != ({self.ht}, {self.wd}) "
                             "the tracker was built for")

        self.tlist.append(float(tstamp))
        if len(self.tstamps) == self.n:
            self.tstamps.append(self.counter)
        else:  # a probe-rejected frame previously occupied row n
            self.tstamps[self.n] = self.counter
        *_, a, b, c = [1.0] * 3 + self.tlist
        fac = (c - b) / (b - a) if b != a else 1.0
        centroids, depth_init = self.draws(self.counter)
        self.counter += 1

        image_t = torch.as_tensor(np.ascontiguousarray(image)).to(self.device)
        centroids = torch.as_tensor(centroids, dtype=torch.float32).to(self.device)
        depth_init = torch.as_tensor(depth_init, dtype=torch.float32)
        fmap, gmap, imap, patches = self.steps._patchify(image_t, centroids)
        self.steps._ingest(self.state, self.n, fmap, gmap, imap, patches, intrinsics, fac,
                           self.is_initialized, self.n > 1, depth_init)

        if self.n > 0 and not self.is_initialized:
            if self._motion_probe() < 2.0:
                # not enough motion: drop the frame, chain its pose to the previous one
                self.delta[self.counter - 1] = (self.counter - 2, se3.identity().numpy())
                return

        self.topo.add_frame()
        kk_f, jj_f = self.topo.edges_forw()
        kk_b, jj_b = self.topo.edges_back()
        self._append(np.concatenate([kk_f, kk_b]), np.concatenate([jj_f, jj_b]))

        if self.n == 8 and not self.is_initialized:
            self.is_initialized = True
            for _ in range(12):
                self.update()
        elif self.is_initialized:
            self.update()
            self.keyframe()

    def _append(self, kk, jj):
        cfg = self.cfg
        overflow = len(self.topo.ii) + len(kk) - cfg.E_MAX
        if overflow > 0:
            # retire the oldest active edges into the inactive store
            print(f"warning: E_MAX={cfg.E_MAX} reached; retiring {overflow} oldest edges")
            rm = np.zeros(len(self.topo.ii), bool)
            rm[:overflow] = True
            self._remove(rm, store=True)
        start, count = self.topo.append(kk, jj)
        span = min(cfg.E_MAX, cfg.PATCHES_PER_FRAME * 2 * cfg.PATCH_LIFETIME)
        for off in range(0, count, span):
            self.steps._zero_edges(self.state, start + off, min(span, count - off))

    def _motion_probe(self) -> float:
        """Median predicted flow of the last frame's patches against the
        new frame."""
        M = self.cfg.PATCHES_PER_FRAME
        kk = np.arange(self.m - M, self.m)
        jj = np.full(M, self.n)
        return float(self.steps._probe(self.state, self._edges(ii=kk // M, jj=jj, kk=kk)))

    # ---------------- optimization round ----------------

    @torch.no_grad()
    def update(self):
        if len(self.topo.ii) == 0:
            return
        cfg = self.cfg
        t0 = max(self.n - cfg.OPTIMIZATION_WINDOW, 1) if self.is_initialized else 1
        nfree = max(self.n - t0, 0)
        if nfree > cfg.W_OPT_MAX:
            raise RuntimeError(f"free poses {nfree} exceed W_OPT_MAX {cfg.W_OPT_MAX}")
        self.steps._update(self.state, self._edges(), t0, nfree)

    # ---------------- keyframing ----------------

    @torch.no_grad()
    def keyframe(self):
        """Mean flow between frames n-KI-1 and n-KI+1 in both directions,
        then the cull / retirement decision."""
        cfg = self.cfg
        i = self.n - cfg.KEYFRAME_INDEX - 1
        j = self.n - cfg.KEYFRAME_INDEX + 1
        mags = []
        t = lambda x: torch.as_tensor(x, device=self.device)
        for a, b in ((i, j), (j, i)):
            sel = (self.topo.ii == a) & (self.topo.jj == b)
            kk = self.topo.kk[sel][: cfg.PATCHES_PER_FRAME]
            if len(kk) == 0:
                mags.append(torch.zeros((), device=self.device))
                continue
            mags.append(self.steps._flowmag_pair(self.state, t(np.full(len(kk), a)),
                                                 t(np.full(len(kk), b)), t(kk), 0.5))
        self._keyframe_decide(float((mags[0] + mags[1]) / 2))

    def _keyframe_decide(self, m: float):
        cfg = self.cfg
        M = cfg.PATCHES_PER_FRAME
        if m < cfg.KEYFRAME_THRESH:
            k = self.n - cfg.KEYFRAME_INDEX
            pair = self.state.poses[k - 1:k + 1].cpu()
            dP = se3.mul(pair[1], se3.inv(pair[0])).numpy()
            self.delta[self.tstamps[k]] = (self.tstamps[k - 1], dP)
            # drop edges touching frame k (not stored), renumber, shift buffers
            self._remove((self.topo.ii == k) | (self.topo.jj == k), store=False)
            self.topo.shift_frame(k)
            del self.tstamps[k]
            self.steps._keyframe_shift(self.state, k, self.n)

        # retire edges whose patches fell out of the optimization window
        to_remove = (self.topo.kk // M) < self.n - cfg.REMOVAL_WINDOW
        if to_remove.any():
            self._remove(to_remove, store=True)

    def _remove(self, mask, store: bool):
        keep = np.nonzero(~np.asarray(mask, bool)[: len(self.topo.ii)])[0]
        _, src, dst = self.topo.remove(mask, store=store)
        t = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=self.device)
        if len(src) > 0:
            self.steps._store_inactive(self.state, t(src), t(dst))
        self.steps._compact_edges(self.state, t(keep))

    # ---------------- termination ----------------

    def get_pose(self, t: int, traj: Dict[int, np.ndarray]) -> np.ndarray:
        if t in traj:
            return traj[t]
        t0, dP = self.delta[t]
        base = self.get_pose(t0, traj)
        out = se3.mul(torch.as_tensor(dP, dtype=torch.float32),
                      torch.as_tensor(base, dtype=torch.float32)).numpy()
        traj[t] = out
        return out

    @torch.no_grad()
    def terminate(self) -> Tuple[np.ndarray, np.ndarray]:
        """12 final update rounds; returns camera-to-world poses [T,7] for
        every frame (culled ones through their relative-pose chain) and
        the timestamps."""
        for _ in range(12):
            self.update()
        poses_kf = self.state.poses[: self.n].cpu().numpy()
        traj = {self.tstamps[i]: poses_kf[i] for i in range(self.n)}
        poses = np.stack([self.get_pose(t, traj) for t in range(self.counter)])
        poses = se3.inv(torch.as_tensor(poses)).numpy()
        return poses, np.asarray(self.tlist, np.float64)
