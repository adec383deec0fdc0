"""Classic (long-term) loop closure — retrieval, triangulation, Sim(3) and
PGO. Port of ``dpvo_tpu/slam/long_term.py`` (DPV-SLAM's classic backend):

  retrieval       ``slam/retrieval.OrbRetrieval`` (native hamming core)
  triangulation   a structure-only BA (``ba/solver.ba`` with no free pose)
                  over the keyframe triplet (i-1, i, i+1), 6 iterations,
                  kept where the residual is < 2 px and the depth < 20
  Sim(3)          RANSAC-Umeyama between the two triplets' points
  correction      ``slam/pgo.apply_loop_closure`` (Sim(3) LM), applied to
                  the tracker's poses and inverse depths

Keypoint detection and matching run on the host, the triplet BA and the
PGO on the tracker's device (segment sums and the triplet's pose solve on
the card's kernels). Hashing, scoring and matching run on a worker thread,
the PGO in a one-slot executor; the tracking thread drains the candidate
packages, runs the geometry and applies finished corrections.
``asynchronous=False`` does all of it inline, deterministically.

Unlike the JAX class, which prints and drops any worker or PGO error, a
failure here is raised: a PGO error when its result is collected, a
retrieval-worker error at the next ``attempt_loop_closure`` or
``terminate``. Only a non-finite PGO result skips its correction. And a
candidate package that keyframe removals overtook (a cull between its
making and its geometry, which the tracker's pending decision makes
likely) is renumbered past them, where the JAX class reads the poses after
that cull with the package's old indices.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from dpvo_tpu_torch.ba import solver as ba_solver
from dpvo_tpu_torch.eval.ate import umeyama_alignment
from dpvo_tpu_torch.geom import projective as pops
from dpvo_tpu_torch.lie import sim3
from dpvo_tpu_torch.slam import pgo
from dpvo_tpu_torch.slam.retrieval import Detect, OrbRetrieval

MIN_INLIERS = 30       # correspondences a closure needs
RANSAC_ITERS = 400
RANSAC_TAU = 0.1       # inlier threshold as a fraction of the cloud's scale
N_LC = 512             # keypoint capacity of the triplet BA


def ransac_umeyama(X: np.ndarray, Y: np.ndarray, iters: int = RANSAC_ITERS,
                   tau: float = RANSAC_TAU):
    """Robust Sim(3) X -> Y from [n,3] correspondences: (R, t, s,
    inlier_mask) or None. The hypotheses come from a generator seeded with
    0, so equal inputs give equal fits."""
    n = X.shape[0]
    if n < 3:
        return None
    rng = np.random.default_rng(0)
    scale = max(np.linalg.norm(Y - Y.mean(0), axis=1).mean(), 1e-6)
    best = None
    best_count = 0
    for _ in range(iters):
        idx = rng.choice(n, 3, replace=False)
        try:
            R, t, s = umeyama_alignment(X[idx].T, Y[idx].T, with_scale=True)
        except np.linalg.LinAlgError:
            continue
        inl = np.linalg.norm(s * X @ R.T + t - Y, axis=1) < tau * scale
        if inl.sum() > best_count:
            best_count = int(inl.sum())
            best = inl
    if best is None or best_count < MIN_INLIERS:
        return None
    # the fit on the consensus set, then one refit on its inliers
    for _ in range(2):
        R, t, s = umeyama_alignment(X[best].T, Y[best].T, with_scale=True)
        best = np.linalg.norm(s * X @ R.T + t - Y, axis=1) < tau * scale
        if best.sum() < MIN_INLIERS:
            return None
    return R, t, s, best


def _triplet_structure_ba(poses3, intr_full, kp_xy, targets, tvalid, d0, device="cpu"):
    """Structure-only BA over a keyframe triplet.

    poses3 [3,7]: world-to-camera poses of (i-1, i, i+1); intr_full [4]:
    full-resolution intrinsics; kp_xy [N_LC,2]: centre-frame keypoints;
    targets [2,N_LC,2]: their matches in the two neighbours; tvalid
    [2,N_LC]: which matches exist; d0: initial inverse depth. The poses stay
    fixed (nfree = 0); the N_LC inverse depths take 6 Gauss-Newton
    iterations at lambda 1e-3 on ``device``. Returns (X [N_LC,3] points in
    the centre camera, keep [N_LC] bool: the larger edge residual < 2 px,
    depth < 20, at least one match), numpy."""
    n = kp_xy.shape[0]
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    ctr = torch.cat([t(kp_xy), torch.full((n, 1), float(d0), device=device)], dim=1)
    intr3 = t(intr_full).reshape(1, 4).repeat(3, 1)
    target = t(targets).reshape(2 * n, 2)
    valid = t(tvalid, torch.bool).reshape(2 * n)
    weight = valid[:, None].to(torch.float32).repeat(1, 2)
    ii = torch.ones(2 * n, dtype=torch.int64, device=device)
    jj = torch.cat([torch.zeros(n, dtype=torch.int64, device=device),
                    torch.full((n,), 2, dtype=torch.int64, device=device)])
    kd_np = np.tile(np.arange(n, dtype=np.int32), 2)
    kd = t(kd_np, torch.int32)
    kd_order = t(np.argsort(kd_np, kind="stable"), torch.int32)
    # generous bounds: the gating is the 2 px residual below
    wd, ht = float(intr_full[2]) * 2.0, float(intr_full[3]) * 2.0
    bounds = t([-64.0, -64.0, wd + 64.0, ht + 64.0])

    poses, depths = ba_solver.ba(t(poses3), ctr, intr3, target, weight, valid, ii, jj, kd, 0, 0,
                                 bounds, 1e-3, W=4, Md=n, iterations=6, res_clip=128.0,
                                 clamp_mode="runtime", kd_order=kd_order)

    ctr_opt = torch.cat([ctr[:, :2], depths[:, None]], dim=1)
    coords = pops.transform(poses, ctr_opt[:, :, None, None], intr3, ii, jj, kd.long())
    resid = torch.linalg.norm(coords[:, 0, 0, :] - target, dim=-1)
    resid = torch.where(valid, resid, torch.zeros_like(resid))  # no match: no veto
    rmax = torch.maximum(resid[:n], resid[n:])
    z = 1.0 / torch.clamp(depths, min=1e-8)
    keep = (rmax < 2.0) & (z < 20.0) & valid.reshape(2, n).any(0)

    fx, fy, cx, cy = (float(intr_full[k]) for k in range(4))
    X = torch.stack([(ctr[:, 0] - cx) / fx * z, (ctr[:, 1] - cy) / fy * z, z], dim=1)
    return X.cpu().numpy(), keep.cpu().numpy()


class LongTermLoopClosure:
    """The tracker's hooks: ``__call__(image, n)`` every frame,
    ``attempt_loop_closure(n)`` after tracking, ``lc_callback()`` to apply a
    finished PGO, ``keyframe(k)`` when keyframe k is removed,
    ``terminate(n)`` at the end (it also stops the worker and the
    executor). ``detect``: the retrieval's detector (see
    ``OrbRetrieval``)."""

    def __init__(self, cfg, slam, asynchronous: bool = True, detect: Optional[Detect] = None):
        self.cfg = cfg
        self.slam = slam
        self.retrieval = OrbRetrieval(thresh=cfg.LOOP_RETR_THRESH,
                                      window=cfg.LOOP_CLOSE_WINDOW_SIZE, detect=detect)
        self.applied: List[int] = []
        self.asynchronous = asynchronous
        self._ops: "queue.Queue" = queue.Queue()
        self._cands: "queue.Queue" = queue.Queue()
        # keyframe removals: a candidate package and a PGO record how many
        # preceded them, and are renumbered by the later ones
        self._removed: List[int] = []  # the removed keyframes, in order (tracking thread)
        self._rm_done = 0  # removals the retrieval has applied (where _remove runs)
        self._held = None  # a package waiting for the worker's removals or its anchor
        self._error: Optional[BaseException] = None  # the worker's first failure
        self._pgo_future: Optional[Future] = None
        self._pgo_pair: Optional[Tuple[int, int]] = None
        self._pgo_gen = 0  # removals before the PGO's poses were read
        self._pgo = ThreadPoolExecutor(max_workers=1) if asynchronous else None
        self._worker = None
        if asynchronous:
            self._worker = threading.Thread(target=self._worker_loop, daemon=True)
            self._worker.start()

    # ---- per-frame hashing ----

    def __call__(self, image: np.ndarray, n: int):
        """Keep the retrieval database aligned with the keyframes: frame n
        is hashed when the database holds no more than n frames."""
        if self.asynchronous:
            self._ops.put(("sync", np.ascontiguousarray(image), n))
        else:
            self._sync(image, n)

    def keyframe(self, k: int):
        """Keyframe k was removed: drop its retrieval entry."""
        self._removed.append(k)
        if self.asynchronous:
            self._ops.put(("remove", k))
        else:
            self._remove(k)

    # ---- the retrieval thread ----

    def _worker_loop(self):
        while True:
            op = self._ops.get()
            try:
                if op[0] == "stop":
                    return
                if self._error is None:  # after a failure, ops are only counted off
                    if op[0] == "sync":
                        self._sync(op[1], op[2])
                    else:
                        self._remove(op[1])
            except Exception as e:  # re-raised on the tracking thread
                self._error = e
            finally:
                self._ops.task_done()

    def _raise_worker_error(self):
        if self._error is not None:
            raise RuntimeError("loop-closure retrieval worker failed") from self._error

    def _sync(self, image: np.ndarray, n: int):
        r = self.retrieval
        while r.n_frames() <= n:
            r.insert_image(image)
            i = r.n_frames() - 1
            cand = r.detect_loop(i) if i > 0 else None
            if cand is not None:
                self._package(cand)

    def _remove(self, k: int):
        self.retrieval.remove(k)
        self._rm_done += 1

    def _package(self, cand: Tuple[int, int]):
        """Descriptor matches of a loop candidate (q, rr), and of each to
        its temporal neighbours for the triplet BAs, posted for the
        tracking thread's geometry."""
        q, rr = cand
        r = self.retrieval
        m_qr = r.match(q, rr)
        if len(m_qr[2]) < MIN_INLIERS:
            return
        nf = r.n_frames()

        def nb_matches(f):
            return [(nb, r.match(f, nb)) for nb in (f - 1, f + 1) if 0 <= nb < nf]

        self._cands.put(dict(gen=self._rm_done, q=q, rr=rr, m_qr=m_qr, nbs_q=nb_matches(q),
                             nbs_r=nb_matches(rr)))

    # ---- geometry ----

    def _triangulate(self, poses: np.ndarray, i: int, nbs, kp_idx: np.ndarray,
                     kp_xy: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """3-D points (camera-i frame) of keypoints kp_idx of frame i (pixel
        coords kp_xy) by the structure-only BA over (i-1, i, i+1) with the
        neighbour matches nbs = [(nb, (pa, pb, ia, ib)), ...]. Returns (X
        [len(kp_idx), 3], good [len(kp_idx)] bool)."""
        n_out = len(kp_idx)
        nk = min(n_out, N_LC)
        xy = np.zeros((N_LC, 2), np.float32)
        xy[:nk] = kp_xy[:nk]
        targets = np.zeros((2, N_LC, 2), np.float32)
        tvalid = np.zeros((2, N_LC), bool)
        for nb, match in nbs[:2]:
            e = 0 if nb < i else 1  # pose slot 0 = i-1, 2 = i+1
            pa, pb, ia, ib = match
            row_of = {int(a): k for k, a in enumerate(ia)}
            for k in range(nk):
                r = row_of.get(int(kp_idx[k]))
                if r is not None:
                    targets[e, k] = pb[r]
                    tvalid[e, k] = True
        X_out = np.zeros((n_out, 3))
        good = np.zeros(n_out, bool)
        if tvalid.any(0).sum() < 8:
            return X_out, good

        slam = self.slam
        M = self.cfg.PATCHES_PER_FRAME
        npn = poses.shape[0]
        triplet = [max(i - 1, 0), i, min(i + 1, npn - 1)]
        intr_full = slam.state.intrinsics[i].cpu().numpy() * self.cfg.RES
        # every keypoint starts at the keyframe's median patch inverse depth
        d0 = float(np.median(slam.state.dvec[i * M:(i + 1) * M].cpu().numpy()))
        d0 = d0 if np.isfinite(d0) and d0 > 1e-4 else 1.0
        X, keep = _triplet_structure_ba(poses[triplet], intr_full, xy, targets, tvalid, d0,
                                        device=slam.device)
        X_out[:nk] = X[:nk]
        good[:nk] = keep[:nk]
        return X_out, good

    # ---- loop attempt ----

    def attempt_loop_closure(self, n: int):
        """Take one candidate package, run its geometry (triangulation +
        RANSAC-Umeyama) and start the Sim(3) PGO; one PGO at a time."""
        self._raise_worker_error()
        if self._pgo_future is not None:
            return
        pkg, self._held = self._held, None
        if pkg is None:
            try:
                pkg = self._cands.get_nowait()
            except queue.Empty:
                return
        slam = self.slam
        # the tracker's pending keyframe decisions are applied first: a cull
        # removes a keyframe, whose retrieval entry goes too
        poses = slam.poses_np()
        if self._rm_done != len(self._removed):  # the worker has a removal to apply
            self._held = pkg
            return
        pkg = _remap(pkg, self._removed[pkg["gen"]:])
        if pkg is None:
            return  # one of its keyframes was removed
        q, rr = pkg["q"], pkg["rr"]
        nb_all = [nb for nb, _ in pkg["nbs_q"]] + [nb for nb, _ in pkg["nbs_r"]]
        if any(f >= slam.n for f in [q, rr] + nb_all):
            return
        if q + 1 >= slam.n:  # the PGO anchors at keyframe q + 1: wait for it
            self._held = dict(pkg, gen=len(self._removed))
            return
        pq, pr, iq, ir = pkg["m_qr"]
        Xq, okq = self._triangulate(poses, q, pkg["nbs_q"], iq, pq)
        Xr, okr = self._triangulate(poses, rr, pkg["nbs_r"], ir, pr)
        both = okq & okr
        if both.sum() < MIN_INLIERS:
            return
        fit = ransac_umeyama(Xq[both], Xr[both])
        if fit is None:
            return
        R, t, s, _ = fit
        # the measured cam-q -> cam-rr Sim(3) S; the loop constant
        # C = T_rr S^-1 T_rr^-1 (the world's drift transform, slam/pgo.py)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        S = torch.cat([f32(t), f32(_rot_to_quat(R)), f32([s])])
        Trr = sim3.inv(sim3.from_se3(f32(poses[rr])))
        C = sim3.mul(sim3.mul(Trr, sim3.inv(S)), sim3.inv(Trr)).numpy()

        args = (poses[:slam.n].copy(), C[None], np.array([q]), np.array([rr]))
        self._pgo_pair, self._pgo_gen = (q, rr), len(self._removed)
        if self._pgo is None:  # inline: the result is ready for lc_callback
            self._pgo_future = Future()
            self._pgo_future.set_result(_run_pgo(*args, device=slam.device))
        else:
            self._pgo_future = self._pgo.submit(_run_pgo, *args, device=slam.device)

    # ---- apply ----

    def lc_callback(self, wait: bool = False) -> bool:
        """Apply a finished PGO correction, if any (waits for it with
        ``wait``), renumbered past the keyframes removed since its poses were
        read. A PGO that raised raises here; a non-finite result is
        skipped."""
        if self._pgo_future is None:
            return False
        if not (wait or self._pgo_future.done()):
            return False
        fut, (q, rr) = self._pgo_future, self._pgo_pair
        self._pgo_future, self._pgo_pair = None, None
        corrected = fut.result()
        if not np.isfinite(corrected).all():
            print(f"loop closure {q} -> {rr}: the PGO gave non-finite poses; not applied")
            return False
        # keyframes culled while the PGO ran (the tracker's pending decisions
        # applied first) lose their rows
        self.slam.poses_np()
        for k in self._removed[self._pgo_gen:]:
            corrected = np.delete(corrected, k, axis=0) if k < len(corrected) else corrected
        self.slam.apply_pgo_result(corrected)
        self.applied.append(q)
        return True

    def terminate(self, n: int) -> bool:
        """Flush the retrieval queue, finish the queued candidates and apply
        the pending corrections; then stop the worker and the executor."""
        try:
            if self.asynchronous:
                self._ops.join()
            applied = False
            for _ in range(8):  # bounded: queued candidates, one PGO each
                applied |= self.lc_callback(wait=True)
                if self._cands.empty() and self._held is None and self._pgo_future is None:
                    break
                self.attempt_loop_closure(self.slam.n)
            applied |= self.lc_callback(wait=True)
            self._raise_worker_error()
        finally:
            self.close()
        return applied

    def close(self):
        """Stop the retrieval worker and the PGO executor (idempotent)."""
        if self._worker is not None and self._worker.is_alive():
            self._ops.put(("stop",))
            self._worker.join()
        if self._pgo is not None:
            self._pgo.shutdown(wait=True)


def _remap(pkg, removed):
    """The package renumbered past the keyframes removed since it was
    made (in order), or None if one of its frames is among them."""
    q, rr = pkg["q"], pkg["rr"]
    nbs_q, nbs_r = pkg["nbs_q"], pkg["nbs_r"]
    for k in removed:
        frames = [q, rr] + [nb for nb, _ in nbs_q + nbs_r]
        if k in frames:
            return None
        dec = lambda f: f - (f > k)
        q, rr = dec(q), dec(rr)
        nbs_q = [(dec(nb), m) for nb, m in nbs_q]
        nbs_r = [(dec(nb), m) for nb, m in nbs_r]
    return dict(pkg, q=q, rr=rr, nbs_q=nbs_q, nbs_r=nbs_r)


def _run_pgo(*args, device):
    """The PGO of one closure (its thread's grad mode off, as the tracker's)."""
    with torch.no_grad():
        return pgo.apply_loop_closure(*args, device=device)


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qx, qy, qz, qw)."""
    w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)
