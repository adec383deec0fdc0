"""The reference tracker: a frozen copy of ``dpvo_tpu_torch/runtime/
dpvo.py`` (the host orchestration: patchify, ingest, motion probe, edge
append, update with the sliding-window BA, keyframe decisions, proximity
loop closure and its global BA), on the plain steps of this package, in
f32, or with every network product and stored feature rounded to fp8
(``precision="fp8"``, the control). Classic loop closure, the viewer, the
exported programs and the mesh are left out.

``load_state`` puts a tracker of the program in this one's place between
two frames: the estimated state (poses, inverse depths, patches, the
edges' hidden state, targets and weights, the topology and the pending
keyframe decisions) is taken as it is, and what the program derived from
the frames (feature maps, patch features) is computed again here from
the frames and the draws. ``__call__`` keeps in ``self.mid`` the poses
and inverse depths just before its optimization round.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from bench_port.reference.ba.gba_sparse import build_sparse_indices
from bench_port.reference.config import Config
from bench_port.reference.lie import se3
from bench_port.reference.precision import fp8_products, fp8_round
from bench_port.reference.ops.corr import avg_pool2d_nhwc
from bench_port.reference.runtime.state import make_state
from bench_port.reference.runtime.steps import StepFunctions, edge_tensors
from bench_port.reference.runtime.topology import Topology, dense_rank
from bench_port.reference.runtime.weights import load_networks
from bench_port.reference.slam.proximity import edges_loop


Draws = Callable[[int], Tuple[object, object]]


class DPVO:
    """The reference tracker: ``slam(t, image, intrinsics)`` tracks one
    frame, ``terminate()`` returns camera-to-world poses [T, 7].
    ``network``: an ``.npz`` path or a flat dict of its arrays;
    ``draws(frame) -> (points [K, 2], depth_init [M])`` as the program's."""

    def __init__(self, cfg: Config, network, ht: int, wd: int, device, draws: Draws,
                 precision: str = "f32"):
        self.cfg = cfg
        self.ht, self.wd = ht, wd
        self.device = torch.device(device)
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}: f32 or fp8")
        self.nets = load_networks(cfg, network).to(self.device, torch.float32).eval()
        self.fp8 = precision == "fp8"
        if self.fp8:
            fp8_products(self.nets)
        self.rnd = fp8_round if self.fp8 else (lambda x: x)
        self.steps = StepFunctions(cfg, self.nets, self.device, torch.float32, rnd=self.rnd)
        self.state = make_state(cfg, ht, wd, self.device, torch.float32)
        self.topo = Topology(cfg)
        self.draws = draws

        self.is_initialized = False
        self.counter = 0
        self.tlist = []
        self.tstamps = []
        self.delta = {}
        self._inflights = deque()
        self.ran_global_ba = set()
        self.last_global_ba = -1000
        self._norm_clamp_hits = 0
        self.mid = None
        # judging: (the program's magnitudes of its keyframe() calls in the
        # checked call, the band); the reference's own magnitudes; the
        # decisions that followed the program's (``_keyframe_decide``)
        self.follow = None
        self.kf_mags = []
        self.kf_followed = 0

    @property
    def n(self) -> int:
        return self.topo.n

    @property
    def m(self) -> int:
        return self.topo.m

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
        # retire frames beyond the pipeline depth: apply their decisions
        while len(self._inflights) >= max(cfg.PIPELINE_DEPTH, 1):
            self._drain_one()
        run_gba = cfg.LOOP_CLOSURE and (
            self.n + 1 - self.last_global_ba >= cfg.GLOBAL_OPT_FREQ
            or (self.topo.ii < self.n + 1 - cfg.REMOVAL_WINDOW - 1).any())
        steady = self.is_initialized and not run_gba
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

        image_t = torch.as_tensor(np.ascontiguousarray(image)).to(self.device)
        points = torch.as_tensor(points, dtype=torch.float32).to(self.device)
        depth_init = torch.as_tensor(depth_init, dtype=torch.float32)
        fmap, gmap, imap, patches, clr = self._features(image_t, points)
        self.mid = dict(fmap=fmap, gmap=gmap, imap=imap)
        self.steps._ingest(self.state, self.n, fmap, gmap, imap, patches, clr, intrinsics, fac,
                           self.is_initialized, self.n > 1, depth_init)

        if self.n > 0 and not self.is_initialized:
            if self._motion_probe() < 2.0:
                # not enough motion: drop the frame, chain its pose to the previous one
                self.delta[self.counter - 1] = (self.counter - 2, se3.identity().numpy())
                return

        self.topo.add_frame()
        if cfg.LOOP_CLOSURE and self.n - self.last_global_ba >= cfg.GLOBAL_OPT_FREQ:
            lkk, ljj = edges_loop(self)
            if len(lkk) > 0:
                self.last_global_ba = self.n
                self._append(lkk, ljj)

        kk_f, jj_f = self.topo.edges_forw()
        kk_b, jj_b = self.topo.edges_back()
        kk_new, jj_new = np.concatenate([kk_f, kk_b]), np.concatenate([jj_f, jj_b])
        if steady:
            self._cap_depths(kk_new)
        self._append(kk_new, jj_new)
        self.mid.update(poses=self.state.poses[:self.n].clone(),
                        dvec=self.state.dvec[:self.m].clone())

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

    def _features(self, image_t, points):
        """Patchify one frame; the control rounds the stored features."""
        fmap, gmap, imap, patches, clr = self.steps._patchify(image_t, points)
        return self.rnd(fmap), self.rnd(gmap), self.rnd(imap), patches, clr

    def load_state(self, snap: dict, frame_of: Callable[[int], np.ndarray]):
        """Take a program tracker's state between two frames (``snap``, as
        the benchmark's ``snapshot`` reads it) and compute again the feature
        maps and patch features that the program derived: each live row's
        frame (``frame_of(call index)``, the image [H, W, 3] uint8) is
        patchified at its draws, for the rows the next call can read."""
        cfg, st, dev = self.cfg, self.state, self.device
        M = cfg.PATCHES_PER_FRAME
        n, m = int(snap["n"]), int(snap["m"])
        tp = self.topo
        tp.n, tp.m = n, m
        for k in ("ii", "jj", "kk", "ii_inac", "jj_inac", "kk_inac"):
            setattr(tp, k, np.asarray(snap["topo"][k], np.int64).copy())
        tp.inac_head, tp.inac_count = int(snap["topo"]["inac_head"]), int(snap["topo"]["inac_count"])
        self.is_initialized = bool(snap["is_initialized"])
        self.counter = int(snap["counter"])
        self.tlist = list(snap["tlist"])
        self.tstamps = list(snap["tstamps"])
        self.delta = dict(snap["delta"])
        self._inflights = deque((float(a), int(b), torch.as_tensor(c).clone(), None)
                                for a, b, c in snap["inflights"])
        self.ran_global_ba = set(snap["ran_global_ba"])
        self.last_global_ba = int(snap["last_global_ba"])
        f32 = lambda x: torch.as_tensor(x).to(dev, torch.float32)
        st.poses[:n] = f32(snap["poses"])
        st.intrinsics[:n] = f32(snap["intrinsics"])
        st.patches[:m] = f32(snap["patches"])
        st.dvec[:m] = f32(snap["dvec"])
        E = len(tp.ii)
        st.net[:E] = self.rnd(f32(snap["net"]))
        st.target[:E] = f32(snap["target"])
        st.weight[:E] = f32(snap["weight"])
        st.target_inac.copy_(f32(snap["target_inac"]))
        st.weight_inac.copy_(f32(snap["weight_inac"]))
        # the rows whose features the next call can read: the frames of the
        # active edges and of the new frame's edges, and under loop closure
        # every row whose patches a proposal can take
        rows = set(tp.ii.tolist()) | set(tp.jj.tolist())
        rows |= set(range(max(n - cfg.PATCH_LIFETIME - 1, 0), n))
        if cfg.LOOP_CLOSURE:
            rows |= set(range(max(n - cfg.MAX_EDGE_AGE - cfg.REMOVAL_WINDOW, 0), n))
        pmem = self.steps.pmem
        for r in sorted(rows):
            f = self.tstamps[r]
            points, _ = self.draws(f)
            image_t = torch.as_tensor(np.ascontiguousarray(frame_of(f))).to(dev)
            points = torch.as_tensor(points, dtype=torch.float32).to(dev)
            fmap, gmap, imap, _, _ = self._features(image_t, points)
            slot = (r % pmem) * M
            st.imap[slot:slot + M] = imap
            st.gmap[slot:slot + M] = gmap
            if r > n - cfg.MEM:
                st.fmap1[r % cfg.MEM] = fmap
                st.fmap2[r % cfg.MEM] = avg_pool2d_nhwc(fmap, 4)

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
        kk = np.arange(self.m - M, self.m)
        jj = np.full(M, self.n)
        return float(self.steps._probe(self.state, self._edges(ii=kk // M, jj=jj, kk=kk)))

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
        es = self.topo.edge_set(pad=len(self.topo.ii))
        edges = edge_tensors(es, self.device)
        if run_gba:
            self.steps._update_noba(self.state, edges)
            self._run_global_ba()
        else:
            self.steps._update(self.state, edges, t0, nfree)

    def _run_global_ba(self):
        """Full-history BA over the inactive and active edges (ref
        dpvo.py:695-716), after the scale-gauge guard. Frees every pose from
        the oldest edge's frame, at most GBA_POSES_MAX of them (older poses
        anchor the gauge)."""
        cfg = self.cfg
        ges, pos, ninac = self.topo.global_edge_set()
        s_norm = float(self.steps._normalize(self.state, self.n, self.m))
        # sustained saturation of the [0.25, 4] clamp: a heavy-tailed depth
        # distribution, whose scale may drift
        if s_norm <= 0.2501 or s_norm >= 3.999:
            self._norm_clamp_hits += 1
            if self._norm_clamp_hits in (1, 10, 100):
                print(f"warning: normalize gauge rescale clamped (s={s_norm:.3g}, "
                      f"hit #{self._norm_clamp_hits}) — depth distribution has a "
                      "heavy tail; trajectory scale may drift")
        E = ges["count"]
        t0 = int(min(ges["ii"].min(), self.n - 1)) if E else 0
        t0 = max(t0, max(self.n - cfg.GBA_POSES_MAX, 0))
        nfree = self.n - t0
        idx = build_sparse_indices(ges["ii"], ges["jj"], ges["kd"], t0, nfree,
                                   W=max(nfree, 1), R_MAX=2 * cfg.GBA_EDGES_MAX,
                                   KP_MAX=cfg.GBA_KPAIRS_MAX)
        self.steps._global_ba(self.state, ges, pos, ninac, t0, nfree, idx)
        self.ran_global_ba.add(self.n)

    # ---------------- keyframing ----------------

    @torch.no_grad()
    def keyframe(self):
        """Mean flow between frames n-KI-1 and n-KI+1 in both directions,
        queued with n and the pose pair of a cull of frame n-KI; the
        cull / retirement decision is applied when the queue drains it."""
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
        # one fetch, as the JAX step's out_small: the magnitude and the pair
        small = torch.cat([((mags[0] + mags[1]) / 2).reshape(1),
                           self.state.poses[i:i + 2].reshape(-1)]).cpu()
        self.kf_mags.append(float(small[0]))
        self._inflights.append((float(small[0]), self.n, small[1:].reshape(2, 7),
                                len(self.kf_mags) - 1))
        if cfg.KEYFRAME_SYNC:
            self._drain()

    def _drain_one(self):
        """Apply the oldest pending keyframe decision with the current
        frame count. Its pose pair indexes rows of the dispatch-time count:
        it holds only if no frame was added or culled since (always at depth
        1 or with KEYFRAME_SYNC); otherwise the rows are read now."""
        m, n_disp, pair, own = self._inflights.popleft()
        self._keyframe_decide(m, pose_pair=pair if n_disp == self.n else None, own=own)

    def _drain(self):
        while self._inflights:
            self._drain_one()

    def _cull(self, m: float, own=None) -> bool:
        """Whether the magnitude m culls (``_keyframe_decide``)."""
        thresh = self.cfg.KEYFRAME_THRESH
        cull = m < thresh
        if own is not None and self.follow is not None and own < len(self.follow[0]):
            theirs, band = self.follow[0][own], self.follow[1]
            if (theirs < thresh) != cull and abs(theirs - m) <= band * abs(m):
                cull = not cull
                self.kf_followed += 1
        return cull

    def _keyframe_decide(self, m: float, pose_pair=None, own=None):
        """Cull keyframe n-KI if the flow magnitude m is below threshold,
        then retire edges beyond the removal window. pose_pair [2, 7] is
        poses[k-1:k+1] of the cull's k, read here when not given. ``own``:
        the index of a magnitude this tracker computed in the call (None
        for one taken from the program's state). Judging (``follow``), an
        own magnitude on the other side of the threshold from the
        program's, within the band of it, is a decision that rounding
        tips: the program's is taken."""
        cfg = self.cfg
        M = cfg.PATCHES_PER_FRAME
        if self._cull(m, own):
            k = self.n - cfg.KEYFRAME_INDEX
            pair = pose_pair if pose_pair is not None else self.state.poses[k - 1:k + 1].cpu()
            dP = se3.mul(pair[1], se3.inv(pair[0])).numpy()
            self.delta[self.tstamps[k]] = (self.tstamps[k - 1], dP)
            # drop edges touching frame k (not stored), renumber, shift buffers
            self._remove((self.topo.ii == k) | (self.topo.jj == k), store=False)
            self.topo.shift_frame(k)
            del self.tstamps[k]
            self.steps._keyframe_shift(self.state, k, self.n)

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
        """Apply the pending keyframe decisions, finish classic loop
        closure's candidates (CLASSIC_LOOP_CLOSURE), propose a last batch of
        loop edges (LOOP_CLOSURE), then 12 final update rounds, each with a
        global BA while loop edges are active; returns camera-to-world poses
        [T,7] for every frame (culled ones through their relative-pose chain)
        and the timestamps."""
        self._drain()
        if self.cfg.LOOP_CLOSURE:
            lkk, ljj = edges_loop(self)
            if len(lkk) > 0:
                self._append(lkk, ljj)
        for _ in range(12):
            self.ran_global_ba.discard(self.n)
            self.update()
        poses_kf = self.state.poses[: self.n].cpu().numpy()
        traj = {self.tstamps[i]: poses_kf[i] for i in range(self.n)}
        poses = np.stack([self.get_pose(t, traj) for t in range(self.counter)])
        poses = se3.inv(torch.as_tensor(poses)).numpy()
        return poses, np.asarray(self.tlist, np.float64)
