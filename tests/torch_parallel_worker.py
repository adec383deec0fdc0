"""One rank of tests/test_torch_parallel.py's two-process runs (imports
torch and the port, never JAX).

    python torch_parallel_worker.py <rank> <world> <dir> [device]

The rank joins a gloo group through a FileStore in <dir>, reads the
problems its parent wrote there (inputs.pt), runs each distributed piece
of the port on them and writes its results to <dir>/rank<r>.pt:

- gba: ``ba/gba_sparse.dist_gba`` over a (1, world) mesh on
  tests/multihost_worker.py's problem (``gba_problem``);
- ba: ``parallel.dist_ba_delta`` over the same mesh;
- tracker: a DPVO(mesh=) oracle loop-closure run (the parent's configuration
  and scene);
- train: one step of ``make_train_step(mesh=)`` over a (world, 1) mesh,
  data parallel, on the parent's global batch and generator seed;
- train_edge: one step over a (1, world) mesh, each clip's unroll split
  over the ranks, on the parent's batch and draws, with each unroll step's
  edge count as this rank's correlation took it.

With a device argument (``cuda``) only gba runs, on that device's tensors.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def gba_problem():
    """tests/multihost_worker.py's global-BA problem (numpy), identical on
    every rank: 24 poses (12 free from 4), 64 depth variables, 512 edges,
    the last 10% invalid."""
    rng = np.random.default_rng(11)
    N, W, Md, E = 24, 16, 64, 512
    t0, nfree = 4, 12
    poses = np.tile([0, 0, 0, 0, 0, 0, 1.0], (N, 1)).astype(np.float32)
    poses[:, :3] += rng.normal(size=(N, 3)).astype(np.float32) * 0.02
    ctr = np.stack([rng.uniform(10, 100, Md), rng.uniform(10, 80, Md),
                    rng.uniform(0.3, 2.0, Md)], -1).astype(np.float32)
    intr = np.tile([96.0, 96.0, 60.0, 45.0], (N, 1)).astype(np.float32)
    ii = rng.integers(0, 20, E).astype(np.int32)
    jj = rng.integers(0, 20, E).astype(np.int32)
    kd = np.sort(rng.integers(0, Md, E)).astype(np.int32)
    target = rng.uniform(0, 120, (E, 2)).astype(np.float32)
    weight = rng.uniform(0.2, 1.0, (E, 2)).astype(np.float32)
    valid = np.arange(E) < int(0.9 * E)
    bounds = np.array([-64.0, -64.0, 184.0, 154.0], np.float32)
    return dict(poses=poses, ctr=ctr, intr=intr, target=target, weight=weight, valid=valid,
                ii=ii, jj=jj, kd=kd, t0=t0, nfree=nfree, bounds=bounds, W=W, Md=Md)


def run_gba(p, device, mesh=None):
    """The port's gba (mesh None) or dist_gba (mesh, which takes this
    rank's shard of the sparsity) on ``gba_problem``'s arrays, two
    iterations."""
    from dpvo_tpu_torch.ba import gba_sparse

    idx = gba_sparse.build_sparse_indices(p["ii"][p["valid"]], p["jj"][p["valid"]],
                                          p["kd"][p["valid"]], p["t0"], p["nfree"], W=p["W"],
                                          R_MAX=2048, KP_MAX=1 << 12)
    idx = gba_sparse.index_tensors(idx, device)
    # the valid edges first, as the tracker's global edge set holds them
    order = np.argsort(~p["valid"], kind="stable")
    t = lambda k, dt=None: torch.as_tensor(p[k][order], dtype=dt, device=device)
    args = (torch.as_tensor(p["poses"], device=device), torch.as_tensor(p["ctr"], device=device),
            torch.as_tensor(p["intr"], device=device), t("target"), t("weight"), t("valid"),
            t("ii", torch.int64), t("jj", torch.int64), t("kd", torch.int32), p["t0"],
            p["nfree"], torch.as_tensor(p["bounds"], device=device), 1e-4, idx)
    kw = dict(W=p["W"], Md=p["Md"], iterations=2)
    if mesh is not None:
        return gba_sparse.dist_gba(mesh, *args, **kw)
    return gba_sparse.gba(*args, **kw)


def run_ba(p, mesh=None):
    """One Gauss-Newton step of the windowed BA on the parent's problem:
    ba_delta (mesh None) or dist_ba_delta."""
    from dpvo_tpu_torch.ba.solver import BAProblem, ba_delta
    from dpvo_tpu_torch.parallel import dist_ba_delta

    t = {k: torch.as_tensor(v) for k, v in p.items() if isinstance(v, np.ndarray)}
    args = (t["poses"], t["ctr"], t["intr"], t["target"], t["weight"], t["valid"], t["ii"],
            t["jj"], t["kd"], p["t0"], p["nfree"], t["bounds"], 1e-4)
    if mesh is not None:
        return dist_ba_delta(mesh, *args, W=p["W"], Md=p["Md"])
    return ba_delta(BAProblem(*args[:11]), t["bounds"], 1e-4, W=p["W"], Md=p["Md"])


def run_tracker(spec, mesh=None):
    """The oracle loop-closure tracker of tests/test_multichip_runtime.py:
    returns (poses [T, 7], sorted global-BA frame counts)."""
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.runtime.dpvo import DPVO
    from dpvo_tpu_torch.slam import proximity
    from dpvo_tpu_torch.utils.synthetic import PlaneScene

    sys.path.insert(0, ROOT)
    import chip_smoke

    proximity.MIN_SEPARATION = spec["min_separation"]
    scene = PlaneScene(**spec["scene"])
    slam = DPVO(Config(**spec["cfg"]), None, spec["scene"]["ht"], spec["scene"]["wd"],
                device="cpu", seed=1, mesh=mesh)
    slam.oracle = chip_smoke.scene_oracle(scene)
    slam._motion_probe = lambda: 1e9
    for t in range(spec["scene"]["n_frames"]):
        slam(t, scene.render(t), scene.intrinsics.copy())
    poses, _ = slam.terminate()
    return poses, sorted(slam.ran_global_ba)


def run_train(spec, mesh=None):
    """One train step of the parent's configuration on its global batch,
    with its draws (spec["draws"], one dict a clip) or those of generator
    seed spec["seed"], and build_schedule's init_frames spec["init_frames"]
    where given: returns (parameters, metrics as floats, the edge count of
    each correlation call in order: each clip's unroll steps, then their
    recomputation in the backward pass)."""
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.models import vonet
    from dpvo_tpu_torch.runtime.weights import init_networks
    from dpvo_tpu_torch.train import make_optimizer, make_train_step

    cfg = Config(**spec["cfg"])
    nets = init_networks(cfg, torch.Generator().manual_seed(0))
    tx, _ = make_optimizer(total_steps=100)
    step = make_train_step(cfg, tx, STEPS=spec["steps"], mesh=mesh)
    draws = spec["draws"] if "draws" in spec else torch.Generator().manual_seed(spec["seed"])
    edges, corr, schedule = [], vonet.corr_features_train, vonet.build_schedule

    def counted(gmap, pyr1, pyr2, coords, *args, **kw):
        edges.append(coords.shape[0])
        return corr(gmap, pyr1, pyr2, coords, *args, **kw)

    vonet.corr_features_train = counted
    if "init_frames" in spec:
        vonet.build_schedule = lambda F, M, S, init_frames=8: schedule(F, M, S,
                                                                        spec["init_frames"])
    try:
        nets, _, m = step(nets, tx.init({k: p.detach() for k, p in nets.named_parameters()}),
                          spec["batch"], draws)
    finally:
        vonet.corr_features_train, vonet.build_schedule = corr, schedule
    return ({k: v.detach().clone() for k, v in nets.state_dict().items()},
            {k: float(v) for k, v in m.items()}, edges)


def spawn(workdir, world: int = 2, device: str = "cpu", timeout: float = 120.0):
    """Run ``world`` of these workers on workdir, each given ``timeout``
    seconds; returns each rank's results (a failed rank raises with the end
    of its output)."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               str(workdir), device], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} failed:\n{out[-3000:]}")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def main(rank: int, world: int, workdir: str, device: str = "cpu"):
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from dpvo_tpu_torch.parallel import make_mesh
    from dpvo_tpu_torch.parallel.multihost import init_distributed

    init_distributed(f"file://{os.path.join(workdir, 'store')}", world, rank, backend="gloo",
                     timeout_s=100)
    try:
        edge = make_mesh(1, world)
        if device != "cpu":
            out = {"gba": run_gba(gba_problem(), torch.device(device), mesh=edge)}
        else:
            inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
            out = {"gba": run_gba(gba_problem(), torch.device("cpu"), mesh=edge),
                   "ba": run_ba(inputs["ba"], mesh=edge),
                   "tracker": run_tracker(inputs["tracker"], mesh=edge),
                   "train": run_train(inputs["train"], mesh=make_mesh(world, 1)),
                   "train_edge": run_train(inputs["train_edge"], mesh=edge)}
        torch.save({k: tuple(x.cpu() if isinstance(x, torch.Tensor) else x for x in v)
                    for k, v in out.items()}, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], *sys.argv[4:])
