"""Port parity of the training unroll: dpvo_tpu_torch's vo_forward, clip
loss and gradients against dpvo_tpu's on the same clip, weights and
draws, on the CPU in f32.

The clip is tests/test_train.py's tiny configuration at 64x64 (the level-1
map is then 16 px on both sides, so corr_features_xla's 16-px region is
the whole map and equals the port's exact windows), 4 frames, 4 unroll
steps, with build_schedule wrapped to init_frames=3 on both sides so that
a frame joins at step 3 (its pose copied, its depth the median of the
previous two frames'). JAX key 4's dropout coin is up at step 3, so that
step also drops frame 0's edges. The JAX side runs without remat (the same
values) so that its one jitted value_and_grad compiles in ~30 s here.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpvo_tpu.config import Config as JConfig
from dpvo_tpu.models import vonet as jvonet
from dpvo_tpu.train.loss import clip_loss as j_clip_loss
from dpvo_tpu.utils.synthetic import PlaneScene
from dpvo_tpu_torch.config import Config
from dpvo_tpu_torch.models import vonet as tvonet
from dpvo_tpu_torch.runtime.weights import Networks, init_networks, params_from_jax, params_to_jax
from dpvo_tpu_torch.train.loss import clip_loss
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)

HT = WD = 64
F, STEPS, M, P = 4, 4, 4, 3
KEY = 4  # its step-3 dropout coin is up
CFG_KW = dict(PATCHES_PER_FRAME=M, DIM=32, FDIM=16, MIXED_PRECISION=False, BUFFER_SIZE=16,
              E_MAX=512, M_OPT_MAX=64, PMEM=8, MEM=8)

# Tolerances. Found: per-step coords within 1.1e-3 px, poses 1.6e-5, the
# loss 2.3e-5 relative, every gradient leaf within 0.07% of JAX's norm
# (structure-only: 2.4e-5 px, poses equal, 6.4e-7, 0.04%). Their source:
# f32 arithmetic in another order (the JAX CPU path's one-hot segment sums
# and Cholesky against index_add_ and the port's Cholesky) carried through
# 4 BA rounds, whose gradient amplifies rounding ~1e3-fold (weights scaled
# by 1 + 1e-6 move gradient leaves by 0.1-3%), hence the margins.
COORDS_ATOL = 1e-2          # px, at 1/4 resolution
POSES_ATOL = 5e-4
LOSS_RTOL = 3e-3
GRAD_REL = 2e-2             # ||g_port - g_jax|| / ||g_jax|| per leaf ...
GRAD_FLOOR = 1e-6           # ... plus this, for leaves whose gradient is zero but for
                            # rounding (conv biases before an instance norm, the
                            # softmax logits' biases: ~1e-8)


def tiny_clip(seed=0):
    scene = PlaneScene(ht=HT, wd=WD, n_frames=F, depth=4.0, seed=seed)
    images = np.stack([scene.render(t) for t in range(F)]).astype(np.float32)
    ys, xs = np.mgrid[0:HT, 0:WD]
    disps = np.stack([scene.inv_depth(t, xs.astype(np.float64), ys.astype(np.float64))
                      for t in range(F)]).astype(np.float32)
    return (images, scene.poses.astype(np.float32), disps,
            scene.intrinsics.astype(np.float32))


def jax_draws(key, F=F, M=M, steps=STEPS, h=HT // 4, w=WD // 4):
    """vo_forward's draws from a JAX key, as the port takes them: the
    patchifier's centroids, d0 and each step's dropout coin."""
    k_pf, k_d, k_drop = jax.random.split(key, 3)
    kx, ky = jax.random.split(k_pf)
    x = np.asarray(jax.random.randint(kx, (F, M), 1, w - 1))
    y = np.asarray(jax.random.randint(ky, (F, M), 1, h - 1))
    drop = [bool(jax.random.uniform(jax.random.split(k)[0]) < 0.1)
            for k in jax.random.split(k_drop, steps)]
    return dict(centroids=torch.tensor(np.stack([x, y], -1), dtype=torch.float32),
                d0=torch.tensor(np.asarray(jax.random.uniform(k_d, (F * M,)))),
                drop=torch.tensor(drop))


def jax_tree(flat):
    """The flax parameter tree of flat save_params keys."""
    tree = {}
    for key, arr in flat.items():
        *parents, leaf = re.findall(r"\['([^']*)'\]", key)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr, jnp.float32)
    return tree


def jax_flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def init_frames_3(monkeypatch):
    """build_schedule with init_frames=3 in both packages."""
    for mod in (jvonet, tvonet):
        orig = mod.build_schedule
        monkeypatch.setattr(mod, "build_schedule",
                            lambda F, M, S, init_frames=8, orig=orig: orig(F, M, S, 3))


def run_both(structure_only: bool):
    """(jax: loss, metrics, traj, grads; port: loss, metrics, traj, nets)
    of one clip from init_networks' weights (seed 0, carried to JAX by
    params_to_jax) and key KEY's draws."""
    jcfg, cfg = JConfig(**CFG_KW), Config(**CFG_KW)
    images, poses, disps, intr = tiny_clip()
    state = init_networks(cfg, torch.Generator().manual_seed(0)).state_dict()
    jparams = jax_tree(params_to_jax(state))
    key = jax.random.PRNGKey(KEY)

    def f(params):
        traj = jvonet.vo_forward(params, jcfg, jnp.asarray(images), jnp.asarray(poses),
                                 jnp.asarray(disps), jnp.asarray(intr), key, STEPS=STEPS,
                                 structure_only=structure_only, remat=False)
        loss, m = j_clip_loss(traj, jnp.asarray(poses), P, structure_only=structure_only)
        return loss, (m, traj)

    (jl, (jm, jtraj)), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(jparams)
    nets = Networks(cfg)
    nets.load_state_dict(state)
    t = lambda a: torch.as_tensor(a)
    traj = tvonet.vo_forward(nets, cfg, t(images), t(poses), t(disps), t(intr),
                             jax_draws(key), STEPS=STEPS, structure_only=structure_only)
    loss, m = clip_loss(traj, t(poses), P, structure_only=structure_only)
    loss.backward()
    return dict(loss=float(jl), metrics={k: float(v) for k, v in jm.items()}, traj=jtraj,
                grads=params_from_jax(jax_flat(jg))), \
        dict(loss=loss.item(), metrics={k: v.item() for k, v in m.items()}, traj=traj, nets=nets)


def grad_errors(jgrads, nets):
    """Per leaf: (||g_port - g_jax||, ||g_jax||); a leaf without a port
    gradient counts as zero. Only JAX's finite entries are compared."""
    out = {}
    for k, p in nets.named_parameters():
        want = jgrads[k].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        fin = np.isfinite(want)
        out[k] = (float(np.linalg.norm((got - want)[fin])), float(np.linalg.norm(want[fin])))
    return out


@pytest.fixture(scope="module")
def both():
    mp = pytest.MonkeyPatch()
    init_frames_3(mp)
    try:
        yield run_both(structure_only=False)
    finally:
        mp.undo()


def test_schedule_has_a_joining_frame_and_a_drop(both):
    """The wrapped schedule adds frame 3 at step 3, the median init runs,
    and key 4's draws drop that step's frame-0 edges."""
    _, port = both
    assert [n for *_, n in port["traj"]] == [3, 3, 3, 4]
    assert bool(jax_draws(jax.random.PRNGKey(KEY))["drop"][3])


@pytest.mark.parametrize("step", range(STEPS))
def test_vo_forward_step_matches_jax(both, step):
    """Each step's (valid, coords, coords_gt, Gs, n) against JAX's."""
    jx, port = both
    jv, jc, jcg, jG, jn = jx["traj"][step]
    tv, tc, tcg, tG, tn = port["traj"][step]
    assert tn == jn
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), atol=COORDS_ATOL, rtol=0)
    np.testing.assert_allclose(tcg.numpy(), np.asarray(jcg), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tG.detach().numpy(), np.asarray(jG), atol=POSES_ATOL, rtol=0)


def test_loss_and_metrics_match_jax(both):
    jx, port = both
    assert np.isfinite(port["loss"])
    np.testing.assert_allclose(port["loss"], jx["loss"], rtol=LOSS_RTOL)
    assert set(port["metrics"]) == set(jx["metrics"]) == {"flow", "tr", "ro", "px1"}
    for k in port["metrics"]:
        np.testing.assert_allclose(port["metrics"][k], jx["metrics"][k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("part", ["patchifier", "update"])
def test_gradients_match_jax(both, part):
    """Every parameter's gradient, leaf by leaf (the JAX leaves mapped by
    params_from_jax), within GRAD_REL of JAX's norm plus GRAD_FLOOR."""
    jx, port = both
    errs = {k: v for k, v in grad_errors(jx["grads"], port["nets"]).items()
            if k.startswith(part + ".")}
    assert errs
    bad = {k: (d, n) for k, (d, n) in errs.items() if d > GRAD_REL * n + GRAD_FLOOR}
    assert not bad, bad
    assert sum(n for _, n in errs.values()) > 0
