"""The tracker's sliding-window BA replayed as CUDA graphs.

On a card, ``ba/solver.ba`` (two Gauss-Newton iterations around the
segment-sum and SPD kernels) is ~640 small launches a call, and the card
idles while the host dispatches them. Here the BA is captured once per
edge-count bucket and then replayed. The capture is cut at each
iteration's segment sum: a bucket holds BA_ITERS + 1 graphs, and the
segment sums between them run as eager calls of ``ba/segsum.segment_sum``,
the same kernel on the same rows (so a profile sees each of them, and its
shapes, as it sees the eager BA's). The SPD solves launch inside the
graphs.

A graph replays fixed addresses and shapes. So every graph of a cache
reads one set of static device buffers of E_MAX rows, and each call
copies its E live edges in on the device and pads them to its bucket
(E rounded up to a multiple of ``BUCKET``) with rows that add exact
zeros: weight 0 and valid False; ii = jj = 0; kd = Md - 1, the largest
id, and kd_order the identity over the pad, so that kd[kd_order] stays
non-decreasing and the live rows keep their places in each segment's
run. t0 and nfree are 0-d device tensors, which the solver reads on the
device alone. The patch centres before the replay and the write-back to
the tracker's state after it run eagerly. The arithmetic is
``ba/solver.ba``'s; a padded call differs from the live-length one only
where cuBLAS sums B6 = Jw^T Jw and v6 over the longer edge axis in
another order.

The graph before a segment sum copies its payload [B, K] into a handoff
buffer; the segment sum takes its first E rows, the live edges', as the
eager BA's call does (the pad's rows would only add zeros); and the graph
after it reads the sums [Md, K] from there. The
handoff buffer lives only during a call: it is taken from a memory pool
of its own at the start of each call and given back at the end, so it
lands at the one address the graphs were captured with and holds no
memory between calls (a call that finds it elsewhere recaptures).

One cache serves one device and configuration for the whole process,
the trackers that run there one after another included (the benchmark
builds a new tracker for every sequence). Its key holds everything its
graphs bake in. Its graphs share one memory pool, scratch alone: each
graph's results go to static buffers before its capture ends, and its
first capture is of E_MAX rows, so that the smaller buckets' scratch fits
in the blocks that the largest left (captured as they come, from small to
large, each would add blocks of its own). Every call
runs on the cache's stream, under the cache's lock: the stream of its
first caller, or a side stream where that is the legacy default stream,
which cannot capture. A call from another stream is ordered after that
stream's work before, and that stream after the call's, so the graphs,
their scratch and the libraries' workspaces they were captured with
serve one call at a time. The first capture of a cache follows one eager
run of the padded BA, which creates the libraries' handles outside any
capture.

Counters (``utils/trace.py``): ``window_ba.replay``, every call that
replays, a capturing one included; ``window_ba.capture``, each capture
(E_MAX's first one included); the steps count ``window_ba.eager`` for each call that takes the
eager BA. A replay counts the SPD launches that its capture noted
(``kernels.recorded``); each segment sum counts its own.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, NamedTuple, Optional

import torch

from dpvo_tpu_torch import kernels
from dpvo_tpu_torch.ba import segsum
from dpvo_tpu_torch.ba import solver as ba_solver
from dpvo_tpu_torch.config import Config
from dpvo_tpu_torch.utils import trace

# edge rows a bucket: at most BUCKET - 1 padded rows, under 5% of the BA's
# work at the steady edge count of the published configuration (~41k)
BUCKET = 2048

_caches: Dict[tuple, "WindowGraphs"] = {}
_caches_lock = threading.Lock()


def write_centres(out, state, d2p, c: int):
    """The first len(d2p) rows of out [Md, 3] <- (x, y, inverse depth) at
    the centres of the patches d2p."""
    nd = d2p.shape[0]
    out[:nd, :2] = state.patches[d2p, :2, c, c]
    out[:nd, 2] = state.dvec[d2p]
    return out


def lookup(cfg: Config, device, Md: int, nfree: int) -> Optional["WindowGraphs"]:
    """The graphs of this device and configuration, or None where the call
    takes the eager BA: off a card, with more depth variables than
    M_OPT_MAX (a non-steady round's live count), or with more free poses
    than the window holds."""
    W = cfg.W_OPT_MAX
    if device.type != "cuda" or Md != cfg.M_OPT_MAX or nfree > W or W > cfg.BUFFER_SIZE:
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device.index, cfg.E_MAX, Md, cfg.BUFFER_SIZE, W, cfg.BA_ITERS, cfg.BA_LMBDA,
           cfg.BA_EP, cfg.BA_LM, cfg.BA_RESIDUAL_CLIP, cfg.BA_BORDER,
           torch.backends.cuda.matmul.allow_tf32)
    with _caches_lock:
        graphs = _caches.get(key)
        if graphs is None:
            graphs = _caches[key] = WindowGraphs(cfg, device, Md)
    return graphs


class _Graph(NamedTuple):
    pieces: tuple         # CUDA graphs, BA_ITERS + 1: the BA cut at its segment sums
    launches: dict        # kernel -> launches a replay inside the pieces


class WindowGraphs:
    def __init__(self, cfg: Config, device, Md: int):
        self.cfg, self.device, self.Md = cfg, device, Md
        E, N = cfg.E_MAX, cfg.BUFFER_SIZE
        self.K = 6 * cfg.W_OPT_MAX + 2     # a segment sum's columns

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.ii, self.jj = z(E, dtype=torch.int32), z(E, dtype=torch.int32)
        self.kd, self.kd_order = z(E, dtype=torch.int32), z(E, dtype=torch.int32)
        self.valid = z(E, dtype=torch.bool)
        self.target, self.weight = z(E, 2), z(E, 2)
        self.ctr = z(Md, 3)
        self.poses, self.intrinsics = z(N, 7), z(N, 4)   # the graph updates poses in place
        self.depths = z(Md)
        self.t0, self.nfree = z(dtype=torch.int64), z(dtype=torch.int64)
        self.graphs: Dict[int, _Graph] = {}               # by padded edge rows
        self.pool = None          # the graphs' scratch
        self.handoff_pool = None  # the handoff buffer's, between calls
        self.handoff_ptr = None
        self.stream = None
        self.lock = threading.Lock()

    def run(self, state, es, target, weight, t0: int, nfree: int):
        """One window BA: the edges es with their target and weight [E, 2],
        poses t0 .. t0 + nfree - 1 free; writes the poses and the live depth
        variables' inverse depths into state."""
        nd = es["n_depths"]
        d2p = es["dense2patch"][:nd]
        caller = torch.cuda.current_stream(self.device)
        with self.lock:
            if self.stream is None:
                self.stream = caller if caller.cuda_stream != 0 else torch.cuda.Stream(self.device)
                self.handoff_pool = torch.cuda.MemPool()
            stream = self.stream
            if stream != caller:
                stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                E = target.shape[0]
                B = self.load(state, es, target, weight, t0, nfree)
                with torch.cuda.use_mem_pool(self.handoff_pool, self.device):
                    handoff = torch.empty(self.cfg.E_MAX * self.K + self.Md * self.K,
                                          device=self.device)
                if handoff.data_ptr() != self.handoff_ptr:
                    self.graphs.clear()
                    self.handoff_ptr = handoff.data_ptr()
                if B not in self.graphs:
                    self._capture(B, handoff)
                payload, sums = self._views(handoff, E)
                kd, order = self.kd[:E], self.kd_order[:E]
                for k, piece in enumerate(self.graphs[B].pieces):
                    if k:   # the live rows' depth sums: the eager BA's call
                        sums.copy_(segsum.segment_sum(payload, kd, order, self.Md))
                    piece.replay()
                del handoff, payload, sums
                trace.count("window_ba.replay")
                for name, n in self.graphs[B].launches.items():
                    kernels.count(name, n)
                state.poses.copy_(self.poses)
                state.dvec[d2p] = self.depths[:nd]
            if stream != caller:
                caller.wait_stream(stream)

    def load(self, state, es, target, weight, t0: int, nfree: int) -> int:
        """Copy a call's inputs into the static buffers, its E edges padded
        to the bucket; returns the bucket's rows B."""
        cfg = self.cfg
        E = target.shape[0]
        B = min(-(-E // BUCKET) * BUCKET, cfg.E_MAX)
        for buf, src in ((self.ii, es["ii"]), (self.jj, es["jj"]), (self.kd, es["kd"]),
                         (self.kd_order, es["kd_order"]), (self.valid, es["valid"]),
                         (self.target, target), (self.weight, weight)):
            buf[:E].copy_(src)
        if B > E:
            for buf in (self.ii, self.jj, self.valid, self.target, self.weight):
                buf[E:B].zero_()
            self.kd[E:B].fill_(self.Md - 1)
            torch.arange(E, B, out=self.kd_order[E:B])
        write_centres(self.ctr.zero_(), state, es["dense2patch"][:es["n_depths"]], cfg.P // 2)
        self.poses.copy_(state.poses)
        self.intrinsics.copy_(state.intrinsics)
        self.t0.fill_(t0)
        self.nfree.fill_(nfree)
        return B

    @torch.no_grad()
    def _solve(self, B: int, segsum_call=segsum.segment_sum):
        cfg = self.cfg
        return ba_solver.ba(
            self.poses, self.ctr, self.intrinsics, self.target[:B], self.weight[:B],
            self.valid[:B], self.ii[:B], self.jj[:B], self.kd[:B], self.t0, self.nfree,
            ba_solver.ba_bounds(self.intrinsics, cfg.BA_BORDER), cfg.BA_LMBDA,
            W=cfg.W_OPT_MAX, Md=self.Md, iterations=cfg.BA_ITERS, ep=cfg.BA_EP, lm=cfg.BA_LM,
            res_clip=cfg.BA_RESIDUAL_CLIP, clamp_mode="runtime", kd_order=self.kd_order[:B],
            segsum=segsum_call)

    def _views(self, handoff, rows: int):
        """(payload [rows, K], sums [Md, K]) of the handoff buffer."""
        K = self.K
        return handoff[:rows * K].view(rows, K), handoff[self.cfg.E_MAX * K:].view(self.Md, K)

    def _capture(self, B: int, handoff):
        """Capture the BA over the first B rows of the static buffers, on the
        current stream, cut at each segment sum: the piece before one copies
        its payload into the handoff buffer, the piece after reads the sums
        from there. The last piece writes its poses into ``poses`` and its
        depths into ``depths``. A cache's first capture is of E_MAX rows,
        whatever B is: the later, smaller captures' scratch then fits in the
        blocks that its scratch left in the pool."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self._solve(B)    # the libraries' handles, made outside any capture
        if not self.graphs and B != self.cfg.E_MAX:
            self._capture(self.cfg.E_MAX, handoff)
        payload, sums = self._views(handoff, B)
        pieces = []

        def begin():
            pieces.append(torch.cuda.CUDAGraph())
            pieces[-1].capture_begin(pool=self.pool, capture_error_mode="thread_local")

        def cut(p, kd, order, Md):
            payload.copy_(p)
            pieces[-1].capture_end()
            begin()
            return sums

        with kernels.recorded() as launches:
            begin()
            try:
                poses, depths = self._solve(B, cut)
                self.poses.copy_(poses)
                self.depths.copy_(depths)
                del poses, depths
            except BaseException:
                with contextlib.suppress(Exception):
                    pieces[-1].capture_end()
                raise
            pieces[-1].capture_end()
        trace.count("window_ba.capture")
        self.graphs[B] = _Graph(tuple(pieces), launches)
