"""Host-side patch-graph topology manager — NumPy integer bookkeeping.

A copy of ``dpvo_tpu/runtime/topology.py`` (without the global-BA edge
set, which waits for the loop-closure port). Its edge sets also carry
``ij_order``, the stable sort by pair that the update operator's pair
aggregation reads.

The reference mutates edge index tensors on the GPU
(dpvo/dpvo.py:480-568 append/remove_factors, :601-693 keyframe). Under
XLA the cheap, shape-changing integer work moves to the host; the
device sees only fixed-shape padded index arrays plus permutations for
payload compaction. Per frame this is O(E log E) NumPy — microseconds
next to the device step.

Invariants mirrored from the reference:
  - patch kk belongs to frame kk // M (index_ is the identity map,
    ref dpvo.py:940, patchgraph.py:34)
  - circular feature slots: patch kk -> kk % (M*pmem), frame jj ->
    jj % mem (ref dpvo.py:456-459)
  - inactive edges only reference frames older than any frame the
    keyframe step can delete (their indices never need fixing; the
    reference relies on the same invariant silently)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from dpvo_tpu_torch.config import Config


def _meshgrid_flat(a, b):
    """All pairs of (a, b) — (ref flatmeshgrid, dpvo/utils.py:85-99)."""
    A, B = np.meshgrid(a, b, indexing="ij")
    return A.reshape(-1), B.reshape(-1)


def dense_rank(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(uniq_sorted, inverse) == np.unique(values, return_inverse=True)
    computed in O(E + range) via bincount + cumsum instead of a sort.

    The active graph's kk / frame indices span a bounded window (the
    removal window plus loop-closure horizon), so `range` is small and
    this is ~7x faster than np.unique at E=37k on the 1-core host —
    the per-frame pack path calls it several times (see
    DPVO._fused_frame)."""
    if len(values) == 0:
        return np.zeros(0, values.dtype), np.zeros(0, np.int64)
    off = values.min()
    cnt = np.bincount(values - off)
    present = cnt > 0
    rank = np.cumsum(present) - present
    return np.nonzero(present)[0] + off, rank[values - off]


def pair_rank(ii: np.ndarray, jj: np.ndarray) -> np.ndarray:
    """Dense group id of each (ii, jj) pair in lexicographic order —
    same result as np.unique(ii * 2^20 + jj, return_inverse=True)[1]
    (the reference pair hash; frame indices stay < 2^20) but via two
    dense_rank passes instead of an int64 sort."""
    if len(ii) == 0:
        return np.zeros(0, np.int64)
    _, ir = dense_rank(ii)
    _, jr = dense_rank(jj)
    return dense_rank(ir * (jr.max() + 1) + jr)[1]


def neighbors(kk: np.ndarray, jj: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Prev/next edge of the same patch ordered by target frame.

    Host equivalent of the reference C++ op fastba/ba.cpp:59-97 (and the
    fork's O(N^2) neighbors_tensor, net.py:531-564). Returns
    (ix, jx, has_prev, has_next) with ix/jx defaulting to self-index
    when absent (the mask zeroes the message).
    """
    E = kk.shape[0]
    ix = np.arange(E)
    jx = np.arange(E)
    has_prev = np.zeros(E, bool)
    has_next = np.zeros(E, bool)
    if E == 0:
        return ix, jx, has_prev, has_next
    # lexsort by (kk primary, jj secondary) as two u16 radix passes over
    # rank-compressed keys (np.lexsort's int64 mergesort costs ~2x more
    # per frame on the 1-core host)
    _, kr = dense_rank(kk)
    _, jr = dense_rank(jj)
    if kr.max() < (1 << 16) and jr.max() < (1 << 16):
        o1 = np.argsort(jr.astype(np.uint16), kind="stable")
        o2 = np.argsort(kr[o1].astype(np.uint16), kind="stable")
        order = o1[o2]
    else:  # adversarial ranges (not reachable from the runtime's caps)
        order = np.lexsort((jj, kk))
    ks, _ = kk[order], jj[order]
    same_prev = np.zeros(E, bool)
    same_prev[1:] = ks[1:] == ks[:-1]
    prev_sorted = np.roll(order, 1)
    next_sorted = np.roll(order, -1)
    same_next = np.zeros(E, bool)
    same_next[:-1] = ks[1:] == ks[:-1]
    ix[order[same_prev]] = prev_sorted[same_prev]
    jx[order[same_next]] = next_sorted[same_next]
    has_prev[order] = same_prev
    has_next[order] = same_next
    return ix, jx, has_prev, has_next


@dataclass
class EdgeSet:
    """Padded edge arrays + derived indexing, ready for the jit step."""

    ii: np.ndarray
    jj: np.ndarray
    kk: np.ndarray
    valid: np.ndarray
    ii1: np.ndarray          # gmap circular slot
    jj1: np.ndarray          # fmap circular slot
    kk_seg: np.ndarray       # dense group id of kk     (SoftAgg + depth vars)
    ij_seg: np.ndarray       # dense group id of (ii,jj) pair
    ix: np.ndarray
    jx: np.ndarray
    mask_ix: np.ndarray
    mask_jx: np.ndarray
    kd: np.ndarray           # dense depth-variable index (== kk_seg)
    kd_order: np.ndarray     # stable argsort of padded kd (sorted segsum)
    ij_order: np.ndarray     # stable argsort of padded ij_seg (SoftAgg by pair)
    dense2patch: np.ndarray  # [M_pad] patch index per depth variable
    n_depths: int
    count: int


class Topology:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.M = cfg.PATCHES_PER_FRAME
        self.pmem = cfg.MAX_EDGE_AGE if cfg.LOOP_CLOSURE else cfg.PMEM
        self.mem = cfg.MEM
        self.n = 0  # frames
        self.m = 0  # patches
        i64 = np.int64
        self.ii = np.zeros(0, i64)
        self.jj = np.zeros(0, i64)
        self.kk = np.zeros(0, i64)
        # inactive ring buffer (drop-oldest on overflow)
        self.ii_inac = np.zeros(cfg.E_INAC_MAX, i64)
        self.jj_inac = np.zeros(cfg.E_INAC_MAX, i64)
        self.kk_inac = np.zeros(cfg.E_INAC_MAX, i64)
        self.inac_head = 0
        self.inac_count = 0

    # ------------- edge proposals (ref dpvo.py:838-903) -------------

    def edges_forw(self):
        r = self.cfg.PATCH_LIFETIME
        t0 = self.M * max(self.n - r, 0)
        t1 = self.M * max(self.n - 1, 0)
        return _meshgrid_flat(np.arange(t0, t1), np.array([self.n - 1]))

    def edges_back(self):
        r = self.cfg.PATCH_LIFETIME
        t0 = self.M * max(self.n - 1, 0)
        t1 = self.M * self.n
        return _meshgrid_flat(np.arange(t0, t1), np.arange(max(self.n - r, 0), self.n))

    # ------------- mutation -------------

    def append(self, kk, jj) -> Tuple[int, int]:
        """Append factors (ref dpvo.py:480-521). Returns (start, count)
        of the new slice so the device can zero the hidden state."""
        kk = np.asarray(kk, np.int64)
        jj = np.asarray(jj, np.int64)
        start = len(self.ii)
        if start + len(kk) > self.cfg.E_MAX:
            raise RuntimeError(
                f"Maximum edges ({self.cfg.E_MAX}) exceeded: {start} + {len(kk)}. Increase E_MAX."
            )
        self.kk = np.concatenate([self.kk, kk])
        self.jj = np.concatenate([self.jj, jj])
        self.ii = np.concatenate([self.ii, kk // self.M])
        return start, len(kk)

    def remove(self, mask: np.ndarray, store: bool):
        """Remove masked active edges, optionally storing them inactive
        (ref dpvo.py:523-568). Returns device instructions:
          perm [E_MAX]      payload compaction gather
          store_src [K]     active indices whose payloads go inactive
          store_dst [K]     destinations in the inactive ring
        """
        E = len(self.ii)
        mask = np.asarray(mask, bool)[:E]
        keep = np.nonzero(~mask)[0]
        rm = np.nonzero(mask)[0]

        store_src = np.zeros(0, np.int64)
        store_dst = np.zeros(0, np.int64)
        if store and len(rm) > 0:
            K = len(rm)
            dst = (self.inac_head + np.arange(K)) % self.cfg.E_INAC_MAX
            self.ii_inac[dst] = self.ii[rm]
            self.jj_inac[dst] = self.jj[rm]
            self.kk_inac[dst] = self.kk[rm]
            self.inac_head = int((self.inac_head + K) % self.cfg.E_INAC_MAX)
            self.inac_count = int(min(self.inac_count + K, self.cfg.E_INAC_MAX))
            store_src, store_dst = rm, dst

        self.ii = self.ii[keep]
        self.jj = self.jj[keep]
        self.kk = self.kk[keep]

        perm = np.zeros(self.cfg.E_MAX, np.int64)
        perm[: len(keep)] = keep
        return perm, store_src, store_dst

    def shift_frame(self, k: int):
        """Renumber active edges after deleting keyframe k
        (ref dpvo.py:643-656). Caller has already removed edges touching
        frame k."""
        mask_ii = self.ii > k
        mask_jj = self.jj > k
        self.kk[mask_ii] -= self.M
        self.ii[mask_ii] -= 1
        self.jj[mask_jj] -= 1
        self.n -= 1
        self.m -= self.M

    def add_frame(self):
        self.n += 1
        self.m += self.M

    # ------------- padded views for the jit step -------------

    def edge_set(self, ii=None, jj=None, kk=None, pad: Optional[int] = None) -> EdgeSet:
        """Build the padded EdgeSet for the active graph (or an explicit
        (ii, jj, kk) subset, e.g. motion-probe edges)."""
        cfg = self.cfg
        if ii is None:
            ii, jj, kk = self.ii, self.jj, self.kk
        ii = np.asarray(ii, np.int64)
        jj = np.asarray(jj, np.int64)
        kk = np.asarray(kk, np.int64)
        E = len(ii)
        pad = pad if pad is not None else cfg.E_MAX
        assert E <= pad, (E, pad)

        uniq, kk_seg = dense_rank(kk)
        ij_seg = pair_rank(ii, jj)
        # SoftAgg over (ii,jj) pairs is sized 2*PAIR_MAX in the jit step
        assert len(ij_seg) == 0 or ij_seg.max() < 2048, ij_seg.max()
        ix, jx, hp, hn = neighbors(kk, jj)

        n_depths = len(uniq)
        Mp = cfg.M_OPT_MAX
        assert n_depths <= Mp, f"depth variables {n_depths} exceed M_OPT_MAX {Mp}"
        # padded slots point past the patch buffer -> dropped by scatters
        sentinel = cfg.BUFFER_SIZE * cfg.PATCHES_PER_FRAME
        dense2patch = np.full(Mp, sentinel, np.int64)
        dense2patch[:n_depths] = uniq

        def padi(a, fill=0):
            out = np.full(pad, fill, np.int32)
            out[:E] = a
            return out

        valid = np.zeros(pad, bool)
        valid[:E] = True
        kd_pad = padi(kk_seg)
        ij_pad = padi(ij_seg)
        return EdgeSet(
            ii=padi(ii),
            jj=padi(jj),
            kk=padi(kk),
            valid=valid,
            ii1=padi(kk % (self.M * self.pmem)),
            jj1=padi(jj % self.mem),
            kk_seg=padi(kk_seg),
            ij_seg=ij_pad,
            ix=padi(ix),
            jx=padi(jx),
            mask_ix=np.pad(hp, (0, pad - E)),
            mask_jx=np.pad(hn, (0, pad - E)),
            kd=kd_pad,
            kd_order=np.argsort(kd_pad, kind="stable").astype(np.int32),
            ij_order=np.argsort(ij_pad, kind="stable").astype(np.int32),
            dense2patch=dense2patch,
            n_depths=n_depths,
            count=E,
        )
