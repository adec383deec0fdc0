"""The port's multi-device layer on the CPU: torch.distributed's gloo over
two spawned processes (tests/torch_parallel_worker.py, which imports no
JAX), against the single-process port and the JAX package computed here.

- the row and kpair shards of the global BA (shard_indices) summed in one
  process, for 1, 2 and 3 shards, against gba;
- two ranks of dist_gba on tests/multihost_worker.py's problem against the
  port's and JAX's gba;
- two ranks of dist_ba_delta against ba_delta (tests/test_train.py's check);
- a two-rank mesh tracker on tests/test_multichip_runtime.py's oracle
  loop-closure setup against the single-device tracker;
- a two-rank data-parallel train step against the single-process step of
  the same global batch;
- the edge split of training: owned_topo's partition of each unroll step,
  SoftAgg split over threads, and a two-rank edge-split train step against
  the single-process step and against the JAX package's train step on a
  (1, 2) mesh of host devices;
- make_mesh's world-size check, init_distributed's environment and
  idempotence.
"""

import os
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
import torch_parallel_worker as worker
from dpvo_tpu.ba import gba_sparse as jgba
from dpvo_tpu.eval import ate_rmse
from dpvo_tpu_torch.ba.solver import no_sum
from test_ba import synthetic_problem
from test_runtime import HT, WD, small_cfg
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)

WORLD = 2
WORKER_TIMEOUT_S = 120

# tests/test_multichip_runtime.py's setup: 20 oracle frames with loop closure
# and proximity pairs 8 frames apart
TRACK_CFG = dict(LOOP_CLOSURE=True, GLOBAL_OPT_FREQ=6, BACKEND_THRESH=1e9, M_OPT_MAX=512,
                 GBA_POSES_MAX=32, GBA_DEPTHS_MAX=256, GBA_EDGES_MAX=2048,
                 GBA_KPAIRS_MAX=16384)
TRACK_SPEC = dict(min_separation=8, scene=dict(ht=HT, wd=WD, n_frames=20, depth=4.0, seed=3))
# tests/test_torch_train_e2e.py's tiny training configuration, two clips
TRAIN_CFG = dict(PATCHES_PER_FRAME=4, DIM=32, FDIM=16, MIXED_PRECISION=False, BUFFER_SIZE=16,
                 E_MAX=512, M_OPT_MAX=64, PMEM=8, MEM=8)
# the edge-split step's draws: JAX key EDGE_KEY split over the two clips as
# the JAX train step splits it (clip 0's step-3 coin is up, so that step
# drops frame 0's edges), with build_schedule's init_frames 3 (frame 3 joins
# at step 3), as in tests/test_torch_train_e2e.py
EDGE_KEY = 1
EDGE_INIT_FRAMES = 3


def _tcfg_dict(jcfg):
    from dpvo_tpu_torch.config import Config as TConfig

    return {f: getattr(jcfg, f) for f in TConfig.__dataclass_fields__}


def _ba_problem():
    """tests/test_train.py's dist_ba check problem (tests/test_ba.py's
    synthetic scene, every edge valid), its targets moved by 0.5 px of
    noise so that the step is not zero; numpy."""
    poses, ctr, intr, target, ii, jj, kd = (np.asarray(x) for x in synthetic_problem(
        jax.random.PRNGKey(7), noise=0.5))
    E, n = ii.shape[0], poses.shape[0]
    return dict(poses=poses, ctr=ctr, intr=intr, target=target,
                weight=np.ones((E, 2), np.float32), valid=np.ones(E, bool),
                ii=ii.astype(np.int64), jj=jj.astype(np.int64), kd=kd.astype(np.int32),
                t0=1, nfree=n - 1, bounds=np.array([-64.0, -64.0, 224.0, 184.0], np.float32),
                W=8, Md=ctr.shape[0])


def _train_batch(seed=0, B=2):
    from test_torch_train_e2e import tiny_clip

    clips = [tiny_clip(seed + b) for b in range(B)]
    return {k: np.stack([c[i] for c in clips])
            for i, k in enumerate(("images", "poses", "disps", "intrinsics"))}


def _jax_batch_draws(key, B=2):
    """vo_forward's draws for each clip of a B-clip batch from JAX key
    ``key``, as the JAX train step splits it."""
    from test_torch_train_e2e import jax_draws

    return [jax_draws(k) for k in jax.random.split(jax.random.PRNGKey(key), B)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two workers' results and their inputs."""
    workdir = tmp_path_factory.mktemp("ranks")
    inputs = dict(ba=_ba_problem(),
                  tracker=dict(TRACK_SPEC, cfg=_tcfg_dict(small_cfg(**TRACK_CFG))),
                  train=dict(cfg=TRAIN_CFG, steps=4, seed=3, batch=_train_batch()),
                  train_edge=dict(cfg=TRAIN_CFG, steps=4, init_frames=EDGE_INIT_FRAMES,
                                  batch=_train_batch(), draws=_jax_batch_draws(EDGE_KEY)))
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    return worker.spawn(workdir, WORLD, timeout=WORKER_TIMEOUT_S), inputs


class Lockstep:
    """k threads, one per shard, summing tensors over all of them: each
    thread's allsum(*xs) returns the same sums, in rank order."""

    def __init__(self, k):
        self.parts = [None] * k
        self.barrier = threading.Barrier(k, timeout=60)

    def allsum(self, rank, op=torch.Tensor.add_):
        """rank's reduction of tensors over the threads (op: in place,
        ``add_`` for a sum)."""
        def f(*xs):
            self.parts[rank] = xs
            self.barrier.wait()
            total = tuple(x.clone() for x in self.parts[0])
            for part in self.parts[1:]:
                for t, x in zip(total, part):
                    op(t, x)
            self.barrier.wait()
            return total
        return f


def _scene_gba(allsum=no_sum, shard=(0, 1)):
    """gba (two iterations) of chip_smoke.gba_problem, tests/test_ba.py's
    scene (every point seen from every frame, perturbed poses and depths),
    on the shard ``shard`` = (rank, world) of its sparsity, sharded on the
    host; the same shard of its tensors (as dist_gba takes it) must be
    equal."""
    from dpvo_tpu_torch.ba import gba_sparse

    args, (ii, jj, kd), n, Md = chip_smoke.gba_problem(torch)
    idx = gba_sparse.build_sparse_indices(ii, jj, kd, 1, n - 1, W=8, R_MAX=4096, KP_MAX=1 << 14)
    host = gba_sparse.index_tensors(gba_sparse.shard_indices(idx, *shard), "cpu")
    dev = gba_sparse.shard_indices(gba_sparse.index_tensors(idx, "cpu"), *shard)
    assert host.keys() == dev.keys() and all(torch.equal(host[k], dev[k]) for k in host)
    return gba_sparse.gba(*args, 1, n - 1, torch.tensor([-64.0, -64.0, 224.0, 184.0]), 1e-4,
                          host, W=8, Md=Md, iterations=2, allsum=allsum), args[0]


@pytest.mark.parametrize("world", [1, 2, 3])
def test_sharded_gba_sums_to_gba(world, monkeypatch):
    """gba on each shard of shard_indices(idx, r, world), the shards' row
    and kpair partials summed across them (one thread a shard, in one
    process), against gba on the whole sparsity, tests/test_ba.py's scene:
    one shard bit for bit; more within twice what regrouping gba's own kpair
    sums moves it (PAIR_CHUNK 997 for 1600 kpairs: 5.5e-5 in the poses,
    9.7e-5 in the depths, measured; the shards measured 9.1e-5 and 4.2e-5:
    the Schur complement's cancellation amplifies the f32 summation order,
    so 1e-5 holds for no reordering of these sums)."""
    from dpvo_tpu_torch.ba import gba_sparse

    want, poses0 = _scene_gba()
    monkeypatch.setattr(gba_sparse, "PAIR_CHUNK", 997)
    regrouped = _scene_gba()[0]
    monkeypatch.undo()
    atol = [max(2 * (a - b).abs().max().item(), 1e-6) for a, b in zip(regrouped, want)]
    step = Lockstep(world)
    got = [None] * world

    def run(r):
        got[r] = _scene_gba(step.allsum(r), (r, world))[0]

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and all(g is not None for g in got)
    for g in got:
        for a, b, tol in zip(g, want, atol):
            if world == 1:
                assert torch.equal(a, b)
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol, rtol=0)
    for a, b in zip(got[0], got[-1]):
        assert torch.equal(a, b)
    assert (want[0] - poses0).abs().max() > 1e-3  # the BA moved the poses
    assert max(atol) < 5e-4


def test_dist_gba_matches_gba(ranks):
    """Two ranks of dist_gba on tests/multihost_worker.py's problem: each
    within 5e-4 of the port's gba and of the JAX package's gba (computed
    here), and the two ranks equal."""
    results, _ = ranks
    p = worker.gba_problem()
    port = worker.run_gba(p, torch.device("cpu"))
    idx = jgba.build_sparse_indices(p["ii"], p["jj"], p["kd"], p["t0"], p["nfree"], W=p["W"],
                                    R_MAX=2048, KP_MAX=1 << 12)
    jx = jgba.gba(*(jnp.asarray(p[k]) for k in ("poses", "ctr", "intr", "target", "weight",
                                                 "valid", "ii", "jj", "kd")),
                  jnp.int32(p["t0"]), jnp.int32(p["nfree"]), jnp.asarray(p["bounds"]),
                  jnp.float32(1e-4), {k: jnp.asarray(v) for k, v in idx.items()}, W=p["W"],
                  Md=p["Md"], iterations=2)
    for r in results:
        for a, b, c in zip(r["gba"], port, jx):
            assert np.abs(a.numpy() - b.numpy()).max() < 5e-4
            assert np.abs(a.numpy() - np.asarray(c)).max() < 5e-4
    for a, b in zip(results[0]["gba"], results[1]["gba"]):
        assert torch.equal(a, b)


def test_dist_ba_delta_matches_ba_delta(ranks):
    """Two ranks of dist_ba_delta (each assembling half the edges) give
    ba_delta's step within 1e-4 (tests/test_train.py's check), on both
    ranks alike."""
    results, inputs = ranks
    want = worker.run_ba(inputs["ba"])
    assert want[0].abs().max() > 1e-3  # the noisy targets give a step
    for r in results:
        for a, b in zip(r["ba"], want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)
    for a, b in zip(results[0]["ba"], results[1]["ba"]):
        assert torch.equal(a, b)


def test_mesh_tracker_matches_single_device(ranks):
    """tests/test_multichip_runtime.py on the port: the oracle loop-closure
    tracker on a two-rank mesh against the single-device tracker: global BA
    at the same frames, both ranks' trajectories within 5e-4 of it and
    equal, and the ATE under 5% of the motion."""
    from dpvo_tpu_torch.lie import se3

    results, inputs = ranks
    poses1, gba1 = worker.run_tracker(inputs["tracker"])
    assert gba1, "proximity loop closure never ran a global BA"
    for r in results:
        poses, gba = r["tracker"]
        assert gba == gba1
        np.testing.assert_allclose(poses, poses1, atol=5e-4, rtol=0)
    np.testing.assert_array_equal(results[0]["tracker"][0], results[1]["tracker"][0])
    sc = inputs["tracker"]["scene"]
    from dpvo_tpu_torch.utils.synthetic import PlaneScene

    gt = se3.inv(torch.as_tensor(PlaneScene(**sc).poses[:sc["n_frames"]])).numpy()
    motion = np.linalg.norm(np.diff(gt[:, :3], axis=0), axis=1).sum()
    poses = results[0]["tracker"][0]
    assert ate_rmse(poses[:, :3], gt[:, :3], align_scale=True) < 0.05 * motion


def test_data_parallel_train_step_matches_single_process(ranks):
    """A two-rank data-parallel train step (one clip a rank) against the
    single-process step of the same two-clip batch and generator: all the
    parameters within 1e-5 of their norm, the loss and metrics equal (each
    clip's forward is the same computation in either process), the two
    ranks' parameters equal. The gradient norm is that of the mean of the
    two clips' gradients taken one clip at a time, bit for bit, and within
    1% of the two-clip step's (measured 0.54%: one backward pass through
    both clips sums the contributions in another order, and the unroll's
    gradient amplifies rounding about a thousandfold, tests/
    test_torch_train_e2e.py). (Tensor by tensor no bound like the first
    holds: the first AdamW step moves each entry by about the learning rate
    times the sign of its gradient, and an entry whose gradient is zero but
    for rounding, as in the conv biases before an instance norm, moves
    either way: measured 6.4e-6, twice the step, in the first conv.)"""
    results, inputs = ranks
    params, metrics, _ = worker.run_train(inputs["train"])
    for r in results:
        p_r, m_r, _ = r["train"]
        flat = lambda d: torch.cat([d[k].reshape(-1) for k in sorted(params)])
        assert (flat(p_r) - flat(params)).norm() <= 1e-5 * flat(params).norm()
        assert set(m_r) == set(metrics)
        for k, v in metrics.items():
            if k == "gnorm":
                np.testing.assert_allclose(m_r[k], v, rtol=1e-2)
                assert m_r[k] == _mean_clip_gnorm(inputs["train"])
            else:
                assert m_r[k] == v, (k, m_r[k], v)
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.runtime.weights import init_networks

    start = init_networks(Config(**TRAIN_CFG), torch.Generator().manual_seed(0)).state_dict()
    assert sum(not torch.equal(v, start[k]) for k, v in params.items()) > len(params) // 2
    for k in params:
        assert torch.equal(results[0]["train"][0][k], results[1]["train"][0][k])


def _mean_clip_gnorm(spec):
    """The norm of the mean of the batch's clip gradients, each from a
    backward pass of its clip alone (the draws of the whole batch from the
    spec's generator, as the train step draws them)."""
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.runtime.weights import init_networks
    from dpvo_tpu_torch.train.step import _batch_to, _clip_draws, batch_loss, global_norm

    cfg = Config(**spec["cfg"])
    batch = _batch_to(spec["batch"], "cpu")
    draws = _clip_draws(cfg, batch, torch.Generator().manual_seed(spec["seed"]), spec["steps"],
                        "cpu")
    grads = []
    for b in range(len(draws)):
        nets = init_networks(cfg, torch.Generator().manual_seed(0))
        loss, _ = batch_loss(nets, cfg, {k: v[b:b + 1] for k, v in batch.items()}, draws[b:b + 1],
                             spec["steps"], 0.1, 10.0)
        loss.backward()
        grads.append([p.grad if p.grad is not None else torch.zeros_like(p)
                      for _, p in nets.named_parameters()])
    return float(global_norm([(a + b) / 2 for a, b in zip(*grads)]))


def _flat(params, keys):
    return torch.cat([params[k].reshape(-1) for k in keys])


def test_edge_split_train_step_matches_single_process(ranks):
    """A two-rank edge-split train step (a (1, 2) mesh: each clip's unroll
    split by patch) against the single-process step of the same two-clip
    batch and draws: all the parameters within 1e-5 of their norm, the loss
    and metrics within rtol 1e-4 and the gradient norm within 1% (the
    frame-pair and BA sums that cross ranks add in another order, and the
    unroll amplifies rounding, as in the data-parallel test), the two
    ranks' parameters equal. Each rank's correlation took exactly half of
    every unroll step's edges, in the forward pass and in its recomputation
    in the backward pass."""
    results, inputs = ranks
    spec = inputs["train_edge"]
    params, metrics, edges = worker.run_train(spec)
    keys = sorted(params)
    # two clips' unroll steps, then each step recomputed in the backward pass
    assert edges[:8] == [36, 36, 36, 64] * 2 and sorted(edges[8:]) == sorted(edges[:8])
    assert metrics["tr"] > 0 and metrics["gnorm"] > 0
    for r in results:
        p_r, m_r, _ = r["train_edge"]
        assert (_flat(p_r, keys) - _flat(params, keys)).norm() <= 1e-5 * _flat(params, keys).norm()
        assert set(m_r) == set(metrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(m_r[k], v, rtol=1e-2 if k == "gnorm" else 1e-4, err_msg=k)
    (p0, _, e0), (p1, _, e1) = results[0]["train_edge"], results[1]["train_edge"]
    assert len(e0) == len(e1) == len(edges)
    for a, b, n in zip(e0, e1, edges):
        assert a == b and a + b == n
    for k in keys:
        assert torch.equal(p0[k], p1[k])


def test_edge_split_train_step_matches_jax(ranks, monkeypatch):
    """The two-rank edge-split step against the JAX package's train step
    under mesh_context on a (1, 2) mesh of two of the host's CPU devices
    (its edge_shard annotations split each clip's unroll edges; tests/
    test_train.py runs that step on (2, 4)), on the same batch, weights
    (params_to_jax) and draws (JAX key EDGE_KEY), build_schedule's
    init_frames EDGE_INIT_FRAMES on both sides, the JAX side without remat
    (the same values, a shorter compile). The loss and metrics within
    tests/test_torch_train_e2e.py's LOSS_RTOL (3e-3: f32 in another order
    carried through 4 BA rounds), the gradient norm within its GRAD_REL
    (2e-2, its bound on each leaf's gradient error, so on the norm's)."""
    from dpvo_tpu.config import Config as JConfig
    from dpvo_tpu.models import vonet as jvonet
    from dpvo_tpu.parallel import data_sharding, make_mesh, mesh_context, replicated
    from dpvo_tpu.train import make_optimizer, make_train_step
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.runtime.weights import init_networks, params_to_jax
    from test_torch_train_e2e import GRAD_REL, LOSS_RTOL, jax_tree

    results, inputs = ranks
    spec = inputs["train_edge"]
    orig = jvonet.build_schedule
    monkeypatch.setattr(jvonet, "build_schedule",
                        lambda F, M, S, init_frames=8: orig(F, M, S, EDGE_INIT_FRAMES))
    state = init_networks(Config(**TRAIN_CFG), torch.Generator().manual_seed(0)).state_dict()
    params = jax_tree(params_to_jax(state))
    tx, _ = make_optimizer(total_steps=100)
    mesh = make_mesh(1, 2)
    with jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh:
        with mesh_context(mesh):
            step = make_train_step(JConfig(**TRAIN_CFG), tx, STEPS=spec["steps"], remat=False)
            batch = {k: jax.device_put(jnp.asarray(v), data_sharding(mesh, v.ndim))
                     for k, v in spec["batch"].items()}
            p = jax.device_put(params, replicated(mesh))
            _, _, m = step(p, tx.init(p), batch, jax.random.PRNGKey(EDGE_KEY))
    want = {k: float(v) for k, v in m.items()}
    assert np.isfinite(want["loss"]) and want["gnorm"] > 0
    for r in results:
        got = r["train_edge"][1]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=GRAD_REL if k == "gnorm" else LOSS_RTOL,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("F,M,ne", [(4, 4, 2), (15, 80, 2), (6, 6, 4)])
def test_owned_topo_partitions_each_step(F, M, ne):
    """owned_topo over ne edge ranks, at each unroll step of build_schedule:
    every edge on exactly one rank, its patch's; each rank's share equal
    where ne divides M; a step's owned edges leading the next step's (the
    rows of net_full); kk_seg numbering the rank's patches, ij_seg the
    step's frame pairs, ix / jx / sup the step's own, as owned rows."""
    from dpvo_tpu_torch.models.vonet import build_schedule, owned_topo
    from dpvo_tpu_torch.parallel import owned_edges

    prev = [None] * ne
    for st in build_schedule(F, M, 18):
        seen = np.zeros(len(st.kk), int)
        for r in range(ne):
            tp, own = owned_topo(st, r, ne), owned_edges(st.kk, r, ne)
            seen[own] += 1
            assert (st.kk[own] % ne == r).all()
            for a, b in ((tp.kk, st.kk), (tp.jj, st.jj), (tp.ii, st.ii), (tp.ij_seg, st.ij_seg),
                         (tp.mask_ix, st.mask_ix), (tp.mask_jx, st.mask_jx)):
                np.testing.assert_array_equal(a, b[own])
            np.testing.assert_array_equal(own[tp.ix], st.ix[own])
            np.testing.assert_array_equal(own[tp.jx], st.jx[own])
            np.testing.assert_array_equal(own[tp.sup], np.intersect1d(st.sup, own))
            np.testing.assert_array_equal(np.unique(tp.kk)[tp.kk_seg], tp.kk)
            assert (tp.n, tp.new_frame) == (st.n, st.new_frame)
            if M % ne == 0:
                assert len(tp.kk) * ne == len(st.kk)
            if prev[r] is not None:
                np.testing.assert_array_equal(tp.kk[:len(prev[r].kk)], prev[r].kk)
                np.testing.assert_array_equal(tp.jj[:len(prev[r].jj)], prev[r].jj)
            prev[r] = tp
        assert (seen == 1).all()
    with pytest.raises(ValueError, match="owns none"):
        owned_topo(build_schedule(2, 2, 1)[0], 4, 5)


@pytest.mark.parametrize("num_segments", [64, 300])  # SoftAgg's two branches
def test_soft_agg_split_over_threads_matches_whole(num_segments):
    """Update's two SoftAggs on 320 rows (40 patches, 10 frame pairs, a
    tenth of the rows invalid), whole, and split by patch over two threads
    (the EdgeSplit interface on Lockstep): agg_kk on each thread's patches
    numbered locally, agg_ij on the shared frame-pair ids with the sums over
    the threads; each thread's rows within 1e-6 of the whole (f32 sums in
    another order)."""
    from dpvo_tpu_torch.models.blocks import SoftAgg
    from dpvo_tpu_torch.parallel import owned_edges

    g = torch.Generator().manual_seed(0)
    D, E = 16, 320
    agg_kk, agg_ij = SoftAgg(D), SoftAgg(D)
    x = torch.randn(E, D, generator=g)
    kk = torch.randint(0, 40, (E,), generator=g)
    ij = kk % 10
    valid = torch.rand(E, generator=g) > 0.1
    _, kk_seg = torch.unique(kk, return_inverse=True)
    with torch.no_grad():
        want = (agg_kk(x, kk_seg, num_segments, valid), agg_ij(x, ij, num_segments, valid))
    sums, maxes = Lockstep(2), Lockstep(2)
    got = [None, None]

    class Split:
        def __init__(self, r):
            self.sum = sums.allsum(r)
            self.max = lambda m: maxes.allsum(r, lambda t, y: torch.maximum(t, y, out=t))(m)[0]

    def run(r):
        own = torch.as_tensor(owned_edges(kk.numpy(), r, 2))
        _, seg = torch.unique(kk[own], return_inverse=True)
        with torch.no_grad():
            got[r] = (own, agg_kk(x[own], seg, num_segments, valid[own], group=Split(r)),
                      agg_ij(x[own], ij[own], num_segments, valid[own], group=Split(r),
                             shared=10))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and all(x is not None for x in got)
    for own, a_kk, a_ij in got:
        np.testing.assert_allclose(a_kk.numpy(), want[0][own].numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(a_ij.numpy(), want[1][own].numpy(), atol=1e-6, rtol=0)


class _StubMesh:
    """A (data, edge) DeviceMesh's sizes, without a process group."""

    mesh_dim_names = ("data", "edge")

    def __init__(self, shape):
        self.shape = shape

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, axis):
        return 0


def test_make_train_step_refuses_more_edge_ranks_than_patches():
    """An edge axis larger than PATCHES_PER_FRAME would leave a rank with no
    patch: make_train_step raises."""
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.train import make_optimizer, make_train_step

    tx, _ = make_optimizer(total_steps=100)
    with pytest.raises(ValueError, match="edge axis of 5 ranks"):
        make_train_step(Config(**TRAIN_CFG), tx, STEPS=4, mesh=_StubMesh((1, 5)))


def test_mesh_and_init_distributed(monkeypatch):
    """init_distributed joins a one-process gloo group from torchrun's
    environment and a second call is a no-op; make_mesh refuses a mesh
    whose size is not the world size, and process_local_batch a batch that
    does not split."""
    from dpvo_tpu_torch.parallel import edge_range, edge_split, local_clips, make_mesh
    from dpvo_tpu_torch.parallel.multihost import init_distributed, process_local_batch

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="1",
                     RANK="0").items():
        monkeypatch.setenv(k, v)
    init_distributed(backend="gloo")
    try:
        group = dist.group.WORLD
        init_distributed(backend="gloo")
        assert dist.is_initialized() and dist.group.WORLD is group
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="needs 2 processes, the group has 1"):
            make_mesh(1, 2)
        mesh = make_mesh(1, 1)
        assert mesh.mesh_dim_names == ("data", "edge") and edge_range(10, mesh) == (0, 10)
        assert edge_split(mesh) is None  # one edge rank: the unsplit unroll
        batch = {"images": np.zeros((4, 2))}
        assert local_clips(batch, mesh)["images"].shape == (4, 2)
        assert process_local_batch(4, 2) == 2
        with pytest.raises(ValueError, match="does not split"):
            process_local_batch(3, 2)
    finally:
        dist.destroy_process_group()


def test_init_distributed_defaults_to_nccl_and_raises_without_a_card(monkeypatch):
    """With no backend named the group is NCCL's: without a card that
    raises, naming gloo, and joins nothing (no silent CPU fallback)."""
    from dpvo_tpu_torch.parallel.multihost import init_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend nccl needs a CUDA device.*gloo"):
        init_distributed("localhost:1", 1, 0)
    assert not dist.is_initialized()
