"""DPVO runtime — host orchestrator of the port, after
``dpvo_tpu/runtime/dpvo.py``.

Sequencing: patchify -> ingest -> (motion probe until initialized) ->
edge append -> update (operator + sliding-window BA) -> keyframe flow
magnitude; the keyframe cull and edge retirement it decides follow later.

The JAX tracker keeps up to ``PIPELINE_DEPTH`` steady frames in flight
and applies each frame's keyframe decision when it drains that frame: at
the start of a later call, once ``PIPELINE_DEPTH`` frames are pending,
with the frame count of that moment (``dpvo_tpu/runtime/dpvo.py:
_drain_one``). The port computes each frame synchronously, but applies
the same decisions at the same moments, so it tracks the JAX trajectory
at every depth: a steady frame queues its flow magnitude with the frame
count and the pose pair of its dispatch, and ``__call__`` decides from
the queue's head. ``KEYFRAME_SYNC`` decides right after the frame, as
the reference DPVO does; ``terminate``, the non-steady branch of
``__call__`` and ``update()`` drain the queue first, as the JAX
tracker's ``_flush_pending`` does.

Proximity loop closure (``LOOP_CLOSURE``, DPV-SLAM's backend): a frame
takes the non-steady branch when a global BA is due (``GLOBAL_OPT_FREQ``
frames since the last proximity batch, or an active edge older than the
removal window); there ``slam/proximity.edges_loop`` proposes loop edges
every ``GLOBAL_OPT_FREQ`` frames, and each round of ``update()`` with such
edges active runs the update operator and then a global BA over the
inactive and active edges (``_run_global_ba``: the scale-gauge guard,
then ``ba/gba_sparse.gba``) in place of the sliding-window BA, once per
frame count; ``terminate`` proposes a last batch and runs 12 such rounds.
Loop edges stay out of the removal window while their target frame is in
the optimization window.

Classic loop closure (``CLASSIC_LOOP_CLOSURE``, ``slam/long_term.py``):
each frame's image goes to the retrieval (``long_term_lc(image, n)``)
before tracking; after tracking an initialized frame takes one candidate's
geometry and PGO (``attempt_loop_closure``) and applies a finished
correction (``lc_callback`` -> ``apply_pgo_result``); a culled keyframe
leaves the retrieval (``keyframe(k)``), and ``terminate`` finishes the
candidates before the proximity batch. Its ORB detector needs OpenCV, or
the caller's ``detect(image) -> (pts, desc)``.

A ``network`` directory written by ``deploy/export.py`` (it holds
``patchify.pt2``) runs the exported patchify and update programs in place
of the modules, after its ``meta.json`` is checked against the tracker's
geometry and configuration, as the JAX tracker runs its StableHLO
directory. ``viz=True`` starts the viewer process (``apps/viewer.py``)
and sends it each image and, every 10 frames once initialized, the poses
and the point cloud.

The oracle hook: ``slam.oracle = fn(slam, es) -> (target, weight)``,
numpy [E, 2] for the host ``EdgeSet`` es, replaces the network's
prediction in every round (the sliding-window BA then runs on them, and
the global BA when due); a set oracle sends every frame through the
non-steady branch, as in the JAX tracker.
"""

from __future__ import annotations

import itertools
import os
from collections import deque
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dpvo_tpu_torch.ba.gba_sparse import build_sparse_indices
from dpvo_tpu_torch.ba.spd_solve import MAX_N as SPD_MAX_N
from dpvo_tpu_torch.config import Config
from dpvo_tpu_torch.lie import se3
from dpvo_tpu_torch.models.patchifier import draw_count, random_candidates
from dpvo_tpu_torch.runtime.state import make_state
from dpvo_tpu_torch.runtime.steps import EDGE_UPLOADS, StepFunctions, edge_tensors
from dpvo_tpu_torch.runtime.topology import Topology, dense_rank
from dpvo_tpu_torch.runtime.weights import load_networks
from dpvo_tpu_torch.slam.long_term import LongTermLoopClosure
from dpvo_tpu_torch.slam.proximity import edges_loop
from dpvo_tpu_torch.slam.retrieval import Detect
from dpvo_tpu_torch.utils import trace


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one this raises instead of
    running on the CPU (pass ``device="cpu"`` for that)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("DPVO: no CUDA device is available; pass device='cpu' to run on "
                           "the CPU")
    return dev


Draws = Callable[[int], Tuple[object, object]]
_TRACKERS = itertools.count()  # each tracker's identity in its spans' request


class DPVO:
    """Track a monocular camera through an image stream.

        slam = DPVO(cfg, network, ht, wd)              # device=None: the card
        for t, image, intrinsics in stream: slam(t, image, intrinsics)
        poses, tstamps = slam.terminate()

    ``draws(frame) -> (points [K,2], depth_init [M])`` replaces the two
    random draws of frame ``frame`` (the call index): the patch points
    (integer x in [1, w-1), y in [1, h-1) at 1/4 resolution; with
    ``CENTROID_SEL_STRAT`` RANDOM the M centroids, with GRADIENT_BIAS the
    3M candidates the patchify scores by image gradient and keeps M of)
    and the random inverse depths used before initialization. By default
    they come from a CPU ``torch.Generator`` seeded with ``seed``, so the
    draws do not depend on the device. ``detect``: classic loop closure's
    keypoint detector (``slam/retrieval.OrbRetrieval``), OpenCV's ORB when
    None. ``network``: an ``.npz`` path, a flat flax dict, an export
    directory (``deploy/export.py``), or None for random weights.

    ``mesh``: a (data, edge) mesh of processes (``parallel.make_mesh``); the
    global BA of loop closure then splits its rows and kpairs over the
    edge axis (``ba/gba_sparse.dist_gba``). Every rank of the mesh runs its
    own tracker on the same frames with the same draws and ends with the
    same trajectory; ``device`` is the rank's own card (or the CPU under a
    gloo group).

    With the recorder on (``utils/trace.py``), each call is a ``frame``
    span, request (tracker, frame counter), and ``terminate`` one of
    request (tracker, "terminate"), with the steps inside them as spans;
    every blocking fetch and upload is a ``wait.*`` / ``upload.*`` span and
    counts ``sync.*``, on or off.
    """

    def __init__(self, cfg: Config, network=None, ht: int = 480, wd: int = 640, device=None,
                 seed: int = 0, draws: Optional[Draws] = None, detect: Optional[Detect] = None,
                 viz: bool = False, mesh=None):
        self.cfg = cfg
        self.ht, self.wd = ht, wd
        self.device = resolve_device(device)
        exported = None
        if isinstance(network, str) and os.path.isdir(network):
            exported = _load_export_dir(network, cfg, ht, wd, self.device)
            network = os.path.join(network, "params.npz")
        if self.device.type == "cuda" and 6 * cfg.W_OPT_MAX > SPD_MAX_N:
            raise ValueError(f"DPVO: the card's pose solve takes 6 * W_OPT_MAX <= {SPD_MAX_N} "
                             f"unknowns (csrc/spd_solve.cu), got W_OPT_MAX {cfg.W_OPT_MAX}")
        if self.device.type == "cuda" and not cfg.MIXED_PRECISION:
            # f32 mode means f32: cuDNN would otherwise run convs in TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        fdt = torch.bfloat16 if cfg.MIXED_PRECISION else torch.float32
        self.nets = load_networks(cfg, network, seed).to(self.device, fdt).eval()
        self.steps = StepFunctions(cfg, self.nets, self.device, exported=exported, mesh=mesh)
        self.state = make_state(cfg, ht, wd, self.device)
        self.topo = Topology(cfg)
        self._gen = torch.Generator().manual_seed(seed)
        self.draws = draws if draws is not None else self._random_draws
        self.trace_id = next(_TRACKERS)

        self.is_initialized = False
        self.counter = 0     # total frames seen
        self.tlist = []      # wall timestamps per frame
        self.tstamps = []    # counter value per kept keyframe
        self.delta = {}      # counter -> (anchor counter, rel pose np[7])
        # steady frames whose keyframe decision is pending: (flow magnitude,
        # n at dispatch, poses[n - KEYFRAME_INDEX - 1 : n - KEYFRAME_INDEX + 1])
        self._inflights = deque()
        self.ran_global_ba = set()   # frame counts n at which a global BA ran
        self.last_global_ba = -1000  # n of the last proximity-edge batch
        self._norm_clamp_hits = 0
        # fn(slam, EdgeSet) -> (target, weight) numpy [E, 2], or None
        self.oracle = None
        # classic loop closure; without OpenCV and a detector this raises
        self.long_term_lc = (LongTermLoopClosure(cfg, self, detect=detect)
                             if cfg.CLASSIC_LOOP_CLOSURE else None)
        self.viewer = None
        if viz:
            from dpvo_tpu_torch.apps.viewer import Viewer

            self.viewer = Viewer()

    @property
    def n(self) -> int:
        return self.topo.n

    @property
    def m(self) -> int:
        return self.topo.m

    def poses_np(self) -> np.ndarray:
        """The live keyframes' poses [n, 7], the pending keyframe decisions
        applied first."""
        self._drain()
        with trace.blocked("wait", "poses", self.device):
            return self.state.poses[: self.n].cpu().numpy()

    @torch.no_grad()
    def point_cloud(self) -> Tuple[np.ndarray, np.ndarray]:
        """World points [m, 3] f32 and their BGR colours [m, 3] uint8 of the
        live patches (PLY / COLMAP export, the viewer), the pending keyframe
        decisions applied first."""
        self._drain()
        pts = self.steps._point_cloud(self.state, self.m)
        with trace.blocked("wait", "point_cloud", self.device, 2):
            return pts.cpu().numpy(), self.state.colors.reshape(-1, 3)[: self.m].cpu().numpy()

    def _random_draws(self, frame: int):
        M = self.cfg.PATCHES_PER_FRAME
        h, w = self.ht // self.cfg.RES, self.wd // self.cfg.RES
        points = random_candidates(draw_count(self.cfg.CENTROID_SEL_STRAT, M), h, w, self._gen)
        return points, torch.rand(M, generator=self._gen)

    def _edges(self, **kw):
        es = self.topo.edge_set(pad=len(kw["ii"]) if "ii" in kw else len(self.topo.ii), **kw)
        return self._upload_edges(es)

    def _upload_edges(self, es):
        with trace.blocked("upload", "edge_set", self.device, EDGE_UPLOADS):
            return edge_tensors(es, self.device)

    # ---------------- per-frame tracking ----------------

    @torch.no_grad()
    def __call__(self, tstamp, image: np.ndarray, intrinsics: np.ndarray):
        """Track one frame. image [H,W,3] uint8 RGB; intrinsics [4]."""
        with trace.span("frame", request=(self.trace_id, self.counter)):
            self._frame(tstamp, image, intrinsics)

    def _frame(self, tstamp, image: np.ndarray, intrinsics: np.ndarray):
        cfg = self.cfg
        if (self.n + 1) >= cfg.BUFFER_SIZE - (cfg.KEYFRAME_INDEX + 5):
            raise RuntimeError(f"Buffer size {cfg.BUFFER_SIZE} too small; increase BUFFER_SIZE")
        if tuple(image.shape[:2]) != (self.ht, self.wd):
            raise ValueError(f"frame size {tuple(image.shape[:2])} != ({self.ht}, {self.wd}) "
                             "the tracker was built for")
        # retire frames beyond the pipeline depth: apply their decisions
        while len(self._inflights) >= max(cfg.PIPELINE_DEPTH, 1):
            self._drain_one()
        if self.viewer is not None:
            self.viewer.update_image(image)
            if (self.counter + 1) % 10 == 0 and self.is_initialized:
                pts, clr = self.point_cloud()
                self.viewer.update_state(self.poses_np(), pts, clr)
        if self.long_term_lc is not None:
            self.long_term_lc(image, self.n)
        run_gba = cfg.LOOP_CLOSURE and (
            self.n + 1 - self.last_global_ba >= cfg.GLOBAL_OPT_FREQ
            or (self.topo.ii < self.n + 1 - cfg.REMOVAL_WINDOW - 1).any())
        steady = self.is_initialized and self.oracle is None and not run_gba
        if not steady:  # the JAX tracker's non-fused branch
            self._drain()

        self.tlist.append(float(tstamp))
        if len(self.tstamps) == self.n:
            self.tstamps.append(self.counter)
        else:  # a probe-rejected frame previously occupied row n
            self.tstamps[self.n] = self.counter
        *_, a, b, c = [1.0] * 3 + self.tlist
        fac = (c - b) / (b - a) if b != a else 1.0
        points, depth_init = self.draws(self.counter)
        self.counter += 1

        with trace.span("patchify"):
            with trace.blocked("upload", "image", self.device, 2):
                image_t = torch.as_tensor(np.ascontiguousarray(image)).to(self.device)
                points = torch.as_tensor(points, dtype=torch.float32).to(self.device)
            depth_init = torch.as_tensor(depth_init, dtype=torch.float32)
            fmap, gmap, imap, patches, clr = self.steps._patchify(image_t, points)
        with trace.span("ingest"):
            self.steps._ingest(self.state, self.n, fmap, gmap, imap, patches, clr, intrinsics,
                               fac, self.is_initialized, self.n > 1, depth_init)

        if self.n > 0 and not self.is_initialized:
            if self._motion_probe() < 2.0:
                # not enough motion: drop the frame, chain its pose to the previous one
                self.delta[self.counter - 1] = (self.counter - 2, se3.identity().numpy())
                return

        with trace.span("topology"):
            self.topo.add_frame()
        if cfg.LOOP_CLOSURE and self.n - self.last_global_ba >= cfg.GLOBAL_OPT_FREQ:
            with trace.span("loop.proposal"):
                lkk, ljj = edges_loop(self)
            if len(lkk) > 0:
                self.last_global_ba = self.n
                with trace.span("topology"):
                    self._append(lkk, ljj)

        with trace.span("topology"):
            kk_f, jj_f = self.topo.edges_forw()
            kk_b, jj_b = self.topo.edges_back()
            kk_new, jj_new = np.concatenate([kk_f, kk_b]), np.concatenate([jj_f, jj_b])
            if steady:
                self._cap_depths(kk_new)
            self._append(kk_new, jj_new)

        if self.n == 8 and not self.is_initialized:
            self.is_initialized = True
            for _ in range(12):
                self.update()
        elif steady:
            self._update()  # the steady frame: no drain, as the JAX fused step
            self.keyframe()
        elif self.is_initialized:
            self.update()
            self.keyframe()
            self._drain()  # decided inline, as the JAX tracker's non-fused frame
        if self.long_term_lc is not None and self.is_initialized:
            self.long_term_lc.attempt_loop_closure(self.n)
            self.long_term_lc.lc_callback()

    def _cap_depths(self, kk_new):
        """The steady frame's depth-variable guard (the JAX fused frame's):
        loop edges are exempt from the removal window and can hold old
        patches, so before the new frame's edges kk_new are appended, the
        edges on the oldest patches beyond M_OPT_MAX distinct ones are
        retired into the inactive store (the global BA still sees them)."""
        uniq = dense_rank(np.concatenate([self.topo.kk, kk_new]))[0]
        over = len(uniq) - self.cfg.M_OPT_MAX
        if over > 0:
            print(f"warning: M_OPT_MAX={self.cfg.M_OPT_MAX} reached; retiring edges on {over} "
                  "oldest patches")
            self._remove(np.isin(self.topo.kk, uniq[:over]), store=True)

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
        with trace.span("motion_probe"):
            kk = np.arange(self.m - M, self.m)
            jj = np.full(M, self.n)
            mag = self.steps._probe(self.state, self._edges(ii=kk // M, jj=jj, kk=kk))
            with trace.blocked("wait", "motion_probe", self.device):
                return float(mag)

    # ---------------- optimization round ----------------

    @torch.no_grad()
    def update(self):
        """One optimization round outside the steady frame (initialization,
        terminate): the pending keyframe decisions are applied first."""
        self._drain()
        self._update()

    def _update(self):
        if len(self.topo.ii) == 0:
            return
        cfg = self.cfg
        t0 = max(self.n - cfg.OPTIMIZATION_WINDOW, 1) if self.is_initialized else 1
        nfree = max(self.n - t0, 0)
        if nfree > cfg.W_OPT_MAX:
            raise RuntimeError(f"free poses {nfree} exceed W_OPT_MAX {cfg.W_OPT_MAX}")
        run_gba = (cfg.LOOP_CLOSURE
                   and (self.topo.ii < self.n - cfg.REMOVAL_WINDOW - 1).any()
                   and self.n not in self.ran_global_ba)
        with trace.span("topology"):
            es = self.topo.edge_set(pad=len(self.topo.ii))
            edges = self._upload_edges(es)
        if self.oracle is not None:
            target, weight = self.oracle(self, es)
            t = lambda x: torch.as_tensor(np.asarray(x, np.float32)[: es.count],
                                          device=self.device)
            with trace.blocked("upload", "oracle", self.device, 2):
                target, weight = t(target), t(weight)
            self.steps._ba_only(self.state, edges, target, weight, t0, nfree)
            if run_gba:  # the global BA reads the oracle's stored targets
                self._run_global_ba()
        elif run_gba:
            self.steps._update_noba(self.state, edges)
            self._run_global_ba()
        else:
            self.steps._update(self.state, edges, t0, nfree)

    def _run_global_ba(self):
        """Full-history BA over the inactive and active edges (ref
        dpvo.py:695-716), after the scale-gauge guard. Frees every pose from
        the oldest edge's frame, at most GBA_POSES_MAX of them (older poses
        anchor the gauge)."""
        with trace.span("gba.round") as rnd:
            self._global_ba_round(rnd)
        self.ran_global_ba.add(self.n)

    def _global_ba_round(self, rnd):
        cfg = self.cfg
        with trace.span("gba.normalize"):
            s = self.steps._normalize(self.state, self.n, self.m)
            with trace.blocked("wait", "gauge", self.device):
                s_norm = float(s)
        # sustained saturation of the [0.25, 4] clamp: a heavy-tailed depth
        # distribution, whose scale may drift
        if s_norm <= 0.2501 or s_norm >= 3.999:
            self._norm_clamp_hits += 1
            if self._norm_clamp_hits in (1, 10, 100):
                print(f"warning: normalize gauge rescale clamped (s={s_norm:.3g}, "
                      f"hit #{self._norm_clamp_hits}) — depth distribution has a "
                      "heavy tail; trajectory scale may drift")
        with trace.span("gba.sparsity"):
            ges, pos, ninac = self.topo.global_edge_set()
            E = ges["count"]
            t0 = int(min(ges["ii"].min(), self.n - 1)) if E else 0
            t0 = max(t0, max(self.n - cfg.GBA_POSES_MAX, 0))
            nfree = self.n - t0
            idx = build_sparse_indices(ges["ii"], ges["jj"], ges["kd"], t0, nfree,
                                       W=max(nfree, 1), R_MAX=2 * cfg.GBA_EDGES_MAX,
                                       KP_MAX=cfg.GBA_KPAIRS_MAX)
        rnd.set(E=E, kpairs=len(idx["p1"]), nfree=nfree, ninac=ninac)
        with trace.span("gba.solve"):
            self.steps._global_ba(self.state, ges, pos, ninac, t0, nfree, idx)

    # ---------------- keyframing ----------------

    @torch.no_grad()
    def keyframe(self):
        """Mean flow between frames n-KI-1 and n-KI+1 in both directions,
        queued with n and the pose pair of a cull of frame n-KI; the
        cull / retirement decision is applied when the queue drains it."""
        cfg = self.cfg
        with trace.span("keyframe"):
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
                with trace.blocked("upload", "keyframe", self.device, 3):
                    edges = t(np.full(len(kk), a)), t(np.full(len(kk), b)), t(kk)
                mags.append(self.steps._flowmag_pair(self.state, *edges, 0.5))
            # one fetch, as the JAX step's out_small: the magnitude and the pair
            small = torch.cat([((mags[0] + mags[1]) / 2).reshape(1),
                               self.state.poses[i:i + 2].reshape(-1)])
            with trace.blocked("wait", "keyframe", self.device):
                small = small.cpu()
            self._inflights.append((float(small[0]), self.n, small[1:].reshape(2, 7)))
        if cfg.KEYFRAME_SYNC:
            self._drain()

    def _drain_one(self):
        """Apply the oldest pending keyframe decision with the current
        frame count. Its pose pair indexes rows of the dispatch-time count:
        it holds only if no frame was added or culled since (always at depth
        1 or with KEYFRAME_SYNC); otherwise the rows are read now."""
        m, n_disp, pair = self._inflights.popleft()
        with trace.span("keyframe.decide"):
            self._keyframe_decide(m, pose_pair=pair if n_disp == self.n else None)

    def _drain(self):
        while self._inflights:
            self._drain_one()

    def _keyframe_decide(self, m: float, pose_pair=None):
        """Cull keyframe n-KI if the flow magnitude m is below threshold,
        then retire edges beyond the removal window. pose_pair [2, 7] is
        poses[k-1:k+1] of the cull's k, read here when not given."""
        cfg = self.cfg
        M = cfg.PATCHES_PER_FRAME
        if m < cfg.KEYFRAME_THRESH:
            k = self.n - cfg.KEYFRAME_INDEX
            pair = pose_pair
            if pair is None:
                with trace.blocked("wait", "cull_pair", self.device):
                    pair = self.state.poses[k - 1:k + 1].cpu()
            dP = se3.mul(pair[1], se3.inv(pair[0])).numpy()
            self.delta[self.tstamps[k]] = (self.tstamps[k - 1], dP)
            # drop edges touching frame k (not stored), renumber, shift buffers
            self._remove((self.topo.ii == k) | (self.topo.jj == k), store=False)
            self.topo.shift_frame(k)
            del self.tstamps[k]
            self.steps._keyframe_shift(self.state, k, self.n)
            if self.long_term_lc is not None:
                self.long_term_lc.keyframe(k)

        # retire edges whose patches fell out of the optimization window,
        # loop edges into the optimization window excepted
        to_remove = (self.topo.kk // M) < self.n - cfg.REMOVAL_WINDOW
        if cfg.LOOP_CLOSURE:
            lc = ((self.topo.jj - self.topo.ii) > 30) & (
                self.topo.jj > self.n - cfg.OPTIMIZATION_WINDOW)
            to_remove &= ~lc
        if to_remove.any():
            self._remove(to_remove, store=True)

    def _remove(self, mask, store: bool):
        keep = np.nonzero(~np.asarray(mask, bool)[: len(self.topo.ii)])[0]
        _, src, dst = self.topo.remove(mask, store=store)
        t = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=self.device)
        if len(src) > 0:
            with trace.blocked("upload", "remove", self.device, 2):
                src, dst = t(src), t(dst)
            self.steps._store_inactive(self.state, src, dst)
        with trace.blocked("upload", "remove", self.device, int(len(keep) > 0)):
            keep = t(keep)
        self.steps._compact_edges(self.state, keep)

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

    def _rescale_deltas(self, scales: np.ndarray):
        """After a Sim(3) PGO: scale each culled frame's stored relative
        translation by the scale of the keyframe its chain ends at."""
        t2s = {self.tstamps[i]: float(scales[i]) for i in range(min(self.n, len(scales)))}
        for t, (t0, dP) in self.delta.items():
            t_src = t
            while t_src in self.delta:
                t_src, _ = self.delta[t_src]
            dP = np.asarray(dP, np.float32).copy()
            dP[:3] *= t2s.get(t_src, 1.0)
            self.delta[t] = (t0, dP)

    @torch.no_grad()
    def apply_pgo_result(self, corrected: np.ndarray):
        """Rewrite the poses of keyframes < m from a finished PGO's Sim(3)
        poses corrected [m, 8] (t, q, s), and divide their patches' inverse
        depths by s."""
        self._drain()
        m = len(corrected)
        self._rescale_deltas(corrected[:, 7])
        q = corrected[:, 3:7] / np.linalg.norm(corrected[:, 3:7], axis=-1, keepdims=True)
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        with trace.blocked("upload", "pgo", self.device, 2):
            poses, scales = t(np.concatenate([corrected[:, :3], q], 1)), t(corrected[:, 7])
        self.steps._apply_pgo(self.state, poses, scales, m)

    @torch.no_grad()
    def terminate(self) -> Tuple[np.ndarray, np.ndarray]:
        """Apply the pending keyframe decisions, finish classic loop
        closure's candidates (CLASSIC_LOOP_CLOSURE), propose a last batch of
        loop edges (LOOP_CLOSURE), then 12 final update rounds, each with a
        global BA while loop edges are active; returns camera-to-world poses
        [T,7] for every frame (culled ones through their relative-pose chain)
        and the timestamps."""
        with trace.span("terminate", request=(self.trace_id, "terminate")):
            return self._terminate()

    def _terminate(self):
        self._drain()
        if self.long_term_lc is not None:
            self.long_term_lc.terminate(self.n)
        if self.cfg.LOOP_CLOSURE:
            with trace.span("loop.proposal"):
                lkk, ljj = edges_loop(self)
            if len(lkk) > 0:
                with trace.span("topology"):
                    self._append(lkk, ljj)
        for _ in range(12):
            self.ran_global_ba.discard(self.n)
            self.update()
        with trace.blocked("wait", "terminate", self.device):
            poses_kf = self.state.poses[: self.n].cpu().numpy()
        traj = {self.tstamps[i]: poses_kf[i] for i in range(self.n)}
        poses = np.stack([self.get_pose(t, traj) for t in range(self.counter)])
        poses = se3.inv(torch.as_tensor(poses)).numpy()
        if self.viewer is not None:
            self.viewer.join()
        return poses, np.asarray(self.tlist, np.float64)


def _load_export_dir(path: str, cfg: Config, ht: int, wd: int, device):
    """The exported network of directory path (``deploy/export.py``),
    checked against the tracker's geometry, configuration and device."""
    if not os.path.exists(os.path.join(path, "patchify.pt2")):
        if os.path.exists(os.path.join(path, "patchify.shlo")):
            raise ValueError(f"{path} holds the JAX package's StableHLO artifacts, which the "
                             "port cannot run; export the network with python -m "
                             "dpvo_tpu_torch.apps.export_network")
        raise ValueError(f"{path} is a directory without an exported network (patchify.pt2)")
    from dpvo_tpu_torch.deploy.export import load_exported, read_meta

    me = read_meta(path)
    want = {"ht": ht, "wd": wd, "e_max": cfg.E_MAX, "mixed_precision": bool(cfg.MIXED_PRECISION),
            "m_opt_max": cfg.M_OPT_MAX, "patches_per_frame": cfg.PATCHES_PER_FRAME,
            "dim": cfg.DIM, "fdim": cfg.FDIM, "device": device.type,
            "centroid_sel_strat": cfg.CENTROID_SEL_STRAT}
    mism = {k: me.get(k) for k, v in want.items() if me.get(k) != v}
    if mism:
        raise ValueError(f"exported network {path} was exported for {mism}, incompatible with "
                         f"this tracker's { {k: want[k] for k in mism} }")
    print(f"running the exported network of {path}")
    return load_exported(path)
