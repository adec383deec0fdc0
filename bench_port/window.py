"""The measured window: one camera stream tracking the cell's sequences
in turn, each with a new ``DPVO(cfg, weights, ht, wd, draws=...)`` fed
every frame through ``DPVO.__call__`` and closed with ``terminate()``,
each frame sent when the last returned (a closed loop), on a CUDA stream
of its own.

The window is whole sequences on the wall clock: it opens before the
first tracker is built and closes at the end of the first ``terminate()``
that ends ``seconds`` or more after the opening, so every tracker's
construction, frames and terminate (in DPV-SLAM its final global-BA
rounds) are inside it. A frame's latency is the host clock from the call
to the end of the stream's synchronize after it.

With ``trace``, the tracker instance's layer methods are wrapped in CUDA
event pairs (spans) in frames and terminates alike, the update rounds
and patchifies counted, and ``profile_seconds`` of frame calls from
``seconds - profile_seconds`` on the clock profiled on the device
(``profile_window.py``, a segment a sequence, terminates left out) with
the shapes of the correlation and segment-sum calls made there recorded;
the window does not close before that profile is whole.

At the calls that the cell's checks draw from the seed, the tracker's
state is copied to the host before and after the call (``snapshot``)
with the frame's new features, for ``judge.py``; the copies after the
call are made once its latency is taken.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from bench_port.harness import Probe

LAYERS = ("patchify", "edge_forward", "window_ba", "global_ba")


def snapshot(slam) -> dict:
    """The tracker's state on the host: what a call reads and writes of
    it, as ``reference/runtime/dpvo.DPVO.load_state`` takes it."""
    st, tp = slam.state, slam.topo
    n, m, E = tp.n, tp.m, len(tp.ii)
    cpu = lambda x: x.detach().to("cpu", copy=True)
    return dict(
        n=n, m=m, counter=slam.counter, is_initialized=slam.is_initialized,
        tlist=list(slam.tlist), tstamps=list(slam.tstamps), delta=dict(slam.delta),
        inflights=[(a, b, torch.as_tensor(c).clone()) for a, b, c, *_ in slam._inflights],
        ran_global_ba=set(slam.ran_global_ba), last_global_ba=slam.last_global_ba,
        topo=dict(ii=tp.ii.copy(), jj=tp.jj.copy(), kk=tp.kk.copy(), ii_inac=tp.ii_inac.copy(),
                  jj_inac=tp.jj_inac.copy(), kk_inac=tp.kk_inac.copy(),
                  inac_head=tp.inac_head, inac_count=tp.inac_count),
        poses=cpu(st.poses[:n]), intrinsics=cpu(st.intrinsics[:n]), patches=cpu(st.patches[:m]),
        dvec=cpu(st.dvec[:m]), net=cpu(st.net[:E]), target=cpu(st.target[:E]),
        weight=cpu(st.weight[:E]), target_inac=cpu(st.target_inac),
        weight_inac=cpu(st.weight_inac))


def will_run_global_ba(slam) -> bool:
    """Whether the next call takes the loop-closure branch
    (``DPVO.__call__``'s ``run_gba``)."""
    cfg, n = slam.cfg, slam.n
    return bool(cfg.LOOP_CLOSURE and (
        n + 1 - slam.last_global_ba >= cfg.GLOBAL_OPT_FREQ
        or (slam.topo.ii < n + 1 - cfg.REMOVAL_WINDOW - 1).any()))


@dataclass
class Check:
    """One compared call: ``kind`` init (the call that initializes),
    frame (call t) or gba (the first call from t on that runs a global
    BA), in the sequence ``seq``, on its first pass."""
    kind: str
    seq: int
    t: int
    frame: int = -1
    before: dict = None
    after: dict = None
    features: tuple = None
    done: bool = False
    kf_mags: list = None   # the magnitudes of the call's keyframe() calls


def plan_checks(specs, seed_seq, T: int):
    """The checks of a run, drawn from the seed: each spec ``{"kind",
    "seq", "from", "to"}`` at a frame in [from, to) (to: T - 20 by default)
    of sequence ``seq`` (0 by default), no two of one sequence at one frame."""
    rng = np.random.default_rng(seed_seq)
    out, taken = [], set()
    for spec in specs:
        q, lo = spec.get("seq", 0), spec.get("from", 0)
        hi = max(spec.get("to", T - 20), lo + 1)
        t = 0
        if spec["kind"] != "init":
            t = int(rng.choice([f for f in range(lo, hi) if (q, f) not in taken]))
            taken.add((q, t))
        out.append(Check(spec["kind"], q, t))
    return out


class StreamRun:
    """The camera stream of a run."""

    def __init__(self, seqs, make_tracker, device, trace: bool, probe: Probe, checks,
                 warm_frames: int, profile_seconds: float = 0.0, on_profile=None):
        self.seqs = seqs
        self.make_tracker = make_tracker
        self.device = device
        self.cuda = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.trace = trace
        self.probe = probe
        self.checks = checks
        self.warm_frames = warm_frames
        self.profile_seconds = profile_seconds if self.cuda is not None else 0.0
        self.on_profile = on_profile   # called once, before the first profiled frame
        self.latencies = []      # s, each frame in the window
        self.spans = {k: [] for k in LAYERS}   # event pairs of the window's calls
        self.gba_host_s = []     # host s of each global-BA round in the window (trace)
        self.edge_rounds = []    # live edges and depth groups of the update rounds (trace)
        self.patchifies = 0      # the frames' patchify calls (trace)
        self.sequences = 0       # sequences terminated
        self.profiles = []       # profile_window summaries, a segment each
        self.profiled_frames = 0
        self.profiled_s = 0.0     # host s of the profiled frames
        self.window_s = 0.0
        self._prof = None
        self._frame_spans = None
        self._capture = None

    def _sync(self):
        if self.cuda is not None:
            self.cuda.synchronize()

    def _ctx(self):
        return torch.cuda.stream(self.cuda) if self.cuda is not None else contextlib.nullcontext()

    # ---- instance wrappers ----

    def _event_pair(self, name, fn):
        def timed(*a, **k):
            if self._frame_spans is None or self.cuda is None:
                return fn(*a, **k)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            self._frame_spans.append((name, e0, e1))
            return out
        return timed

    def instrument(self, slam):
        steps = slam.steps
        real_patchify = steps._patchify

        def patchify(*a, **k):
            out = real_patchify(*a, **k)
            if self._capture is not None:  # copied to the host after the call
                self._capture.features = tuple(x.detach() for x in out[:3])
            if self._frame_spans is not None:
                self._frame_spans.append(("patchify_call", None, None))
            return out

        steps._patchify = patchify
        real_keyframe = slam.keyframe

        def keyframe():
            real_keyframe()
            if self._capture is not None and slam._inflights:
                self._capture.kf_mags.append(float(slam._inflights[-1][0]))

        slam.keyframe = keyframe
        if not self.trace:
            return
        real_edge = steps._edge_forward

        def edge_forward(state, es, net=None):
            if self._frame_spans is not None:
                self._frame_spans.append(("round", (int(es["count"]), int(es["n_depths"])), None))
            return real_edge(state, es, net)

        steps._edge_forward = edge_forward
        real_corr = steps._corr

        def corr(state, coords, es):
            if self.probe.profiling:
                E = int(coords.shape[0])
                tp = slam.topo
                if E == len(tp.ii):
                    nframes, nrows = len(np.unique(tp.jj)), len(np.unique(tp.kk))
                else:  # the motion probe's edges: one frame's patches into the next
                    nframes, nrows = 1, E
                _, H1, W1, C = state.fmap1.shape
                self.probe.add("corr", (E, nframes, nrows, H1, W1, C))
            return real_corr(state, coords, es)

        steps._corr = corr
        for name, attr in (("patchify", "_patchify"), ("edge_forward", "_edge_forward"),
                           ("window_ba", "_window_ba")):
            setattr(steps, attr, self._event_pair(name, getattr(steps, attr)))
        real_gba = slam._run_global_ba

        def global_ba():
            t0 = time.perf_counter()
            self._event_pair("global_ba", real_gba)()
            self._sync()
            if self._frame_spans is not None:
                self._frame_spans.append(("global_ba_host", time.perf_counter() - t0, None))

        slam._run_global_ba = global_ba

    @staticmethod
    def release(slam):
        """Take the wrappers off the tracker: each closes over the tracker
        or its steps, a reference cycle that would keep a finished
        tracker's device memory until the garbage collector ran."""
        for obj, attrs in ((slam, ("keyframe", "_run_global_ba")),
                           (slam.steps, ("_patchify", "_edge_forward", "_corr", "_window_ba"))):
            for attr in attrs:
                obj.__dict__.pop(attr, None)

    # ---- the device profile, a segment a sequence ----

    def _profile_on(self):
        from bench_port import profile_window

        if self._prof is None:
            if self.on_profile is not None:
                self.on_profile()
                self.on_profile = None
            self._prof = profile_window.start()
            self.probe.profiling = True

    def _profile_off(self):
        from bench_port import profile_window

        if self._prof is not None:
            self.probe.profiling = False
            self._sync()
            self._prof.stop()
            self.profiles.append(profile_window.summarize(self._prof))
            self._prof = None

    # ---- set-up and window ----

    def warm(self):
        """Set-up: a tracker on the first frames of the first sequence,
        then (loop closure) one global-BA round, and the terminate, so that
        every library handle and allocation the window uses exists; with
        ``trace``, the profiler's first start."""
        from bench_port import profile_window

        with self._ctx():
            seq = self.seqs[0]
            slam = self.make_tracker(seq)
            self.instrument(slam)
            for t in range(min(self.warm_frames, len(seq.frames))):
                slam(t, seq.frames[t], seq.intrinsics)
            if slam.cfg.LOOP_CLOSURE and len(slam.topo.ii):
                slam._run_global_ba()
            slam.terminate()
            self._sync()
            self.release(slam)
        if self.trace and self.cuda is not None:
            profile_window.start().stop()

    def run(self, seconds: float):
        """Track whole sequences until ``seconds`` of the wall clock have
        passed; ``window_s`` is the window's length."""
        with self._ctx():
            self._window(seconds)

    def _window(self, seconds: float):
        Q = len(self.seqs)
        q, rep = 0, 0
        t_open = time.perf_counter()
        while True:
            seq = self.seqs[q]
            slam = self.make_tracker(seq)
            self.instrument(slam)
            self._track(slam, seq, q, rep, t_open, seconds)
            self._profile_off()
            self._frame_spans = [] if self.trace else None
            slam.terminate()
            self._sync()
            self._keep(self._frame_spans)
            self._frame_spans = None
            self.release(slam)
            del slam
            self.sequences += 1
            q = (q + 1) % Q
            rep += q == 0
            if (time.perf_counter() - t_open >= seconds
                    and self.profiled_s >= self.profile_seconds):
                break
        self.window_s = time.perf_counter() - t_open

    def _keep(self, spans):
        for name, a, b in spans or ():
            if name == "global_ba_host":
                self.gba_host_s.append(a)
            elif name == "round":
                self.edge_rounds.append(a)
            elif name == "patchify_call":
                self.patchifies += 1
            else:
                self.spans[name].append((a, b))

    def _open_check(self, slam, q, rep, t):
        if rep:
            return None
        for c in self.checks:
            if c.done or c.seq != q or t < c.t:
                continue
            if c.kind == "frame" and t == c.t:
                return c
            if c.kind == "init" and not slam.is_initialized and slam.n == 7:
                return c
            if c.kind == "gba" and will_run_global_ba(slam):
                return c
        return None

    def _track(self, slam, seq, q, rep, t_open, seconds):
        """Every frame of one sequence; the device profiled over frames
        from ``seconds - profile_seconds`` on the clock until
        ``profile_seconds`` of them are profiled."""
        for t in range(len(seq.frames)):
            if self.profiled_s < self.profile_seconds:
                if time.perf_counter() - t_open >= seconds - self.profile_seconds:
                    self._profile_on()
            elif self._prof is not None:
                self._profile_off()
            chk = self._open_check(slam, q, rep, t)
            if chk is not None:
                chk.before, chk.features, chk.frame, chk.kf_mags = snapshot(slam), None, t, []
                rounds = len(slam.ran_global_ba)
                self._capture = chk
            self._frame_spans = [] if self.trace else None
            t0 = time.perf_counter()
            slam(t, seq.frames[t], seq.intrinsics)
            self._sync()
            dt = time.perf_counter() - t0
            spans, self._frame_spans, self._capture = self._frame_spans, None, None
            self.latencies.append(dt)
            if self._prof is not None:  # the profile holds this frame
                self.profiled_frames += 1
                self.profiled_s += dt
            self._keep(spans)
            if chk is not None:
                if chk.features is not None:
                    chk.features = tuple(x.to("cpu", copy=True) for x in chk.features)
                kept = {"frame": True, "init": slam.is_initialized,
                        "gba": len(slam.ran_global_ba) > rounds}[chk.kind]
                if kept:
                    chk.after, chk.done = snapshot(slam), True
