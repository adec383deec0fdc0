"""Port parity: encoders, patchifier and the update operator of
dpvo_tpu_torch against the flax modules of dpvo_tpu, with weights
imported by params_from_jax from both committed checkpoints."""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_tpu.models import Patchifier as JPatchifier
from dpvo_tpu.models import Update as JUpdate
from dpvo_tpu.models.blocks import segment_softmax as j_segment_softmax
from dpvo_tpu.runtime.topology import dense_rank, neighbors, pair_rank
from dpvo_tpu.runtime.weights import load_params
from dpvo_tpu_torch.config import Config
from dpvo_tpu_torch.ba.segsum import CHUNK, segment_sum_plain
from dpvo_tpu_torch.models.blocks import grouped_sum, segment_softmax
from dpvo_tpu_torch.runtime.weights import load_networks, load_npz, params_from_jax
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {
    "tiny": (os.path.join(ROOT, "tests", "fixtures", "tiny_synth.npz"), dict(DIM=64, FDIM=32)),
    "flagship": (os.path.join(ROOT, "weights", "vonet_synth.npz"), dict(DIM=384, FDIM=128)),
}


def jax_params_from_npz(path):
    """The flax parameter tree of a save_params .npz, rebuilt from its
    keys (what runtime.weights.load_params returns, without its
    shape-defining init run)."""
    tree = {}
    for key, arr in load_npz(path).items():
        *parents, leaf = re.findall(r"\['([^']*)'\]", key)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr, jnp.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _jax_params(name, mixed):
    return jax_params_from_npz(CKPTS[name][0])


def _nets(name, mixed=False):
    path, dims = CKPTS[name]
    jparams = _jax_params(name, mixed)
    nets = load_networks(Config(**dims), path).eval()
    return jparams, nets, dims


def _close_rel(got, want, rel):
    """|got - want| <= rel * max|want| (error relative to the output scale)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-6), \
        (np.abs(got - want).max(), np.abs(want).max())


@pytest.mark.parametrize("name", ["tiny", "flagship"])
def test_patchifier_matches(name):
    """fmap / gmap / imap / patches / clr at the same centroids, f32.
    Tolerance: f32 convolution summation order through 11 conv layers."""
    jparams, nets, dims = _nets(name)
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.5, 1.5, (1, 32, 48, 3)).astype(np.float32)
    key = __import__("jax").random.PRNGKey(1)
    jp = JPatchifier(patch_size=3, dim=dims["DIM"], fdim=dims["FDIM"])
    want = jp.apply(jparams["patchifier"], jnp.asarray(img), 12, key)
    cent = np.asarray(want[3])[:, :2, 1, 1]  # the JAX draw, read back from the patch grid
    with torch.no_grad():
        got = nets.patchifier(torch.as_tensor(img), torch.as_tensor(np.array(cent))[None])
    for g, w in zip(got, want):
        _close_rel(g, w, 1e-5)


def _edge_problem(seed, E, D, width, n_frames=6, M=8):
    rng = np.random.default_rng(seed)
    kk = rng.integers(0, n_frames * M, E)
    jj = rng.integers(0, n_frames, E)
    ii = kk // M
    _, kk_seg = dense_rank(kk)
    ij_seg = pair_rank(ii, jj)
    ix, jx, hp, hn = neighbors(kk, jj)
    valid = rng.uniform(size=E) > 0.1
    net = rng.standard_normal((E, D)).astype(np.float32)
    inp = rng.standard_normal((E, D)).astype(np.float32)
    corr = (4 * rng.standard_normal((E, width))).astype(np.float32)
    return net, inp, corr, ix, jx, hp & valid, hn & valid, kk_seg, ij_seg, valid


@pytest.mark.parametrize("name,num_segments", [("tiny", 128), ("tiny", 2048), ("flagship", 2560)])
def test_update_matches_f32(name, num_segments):
    """(net, delta, weight) in f32, both SoftAgg branches (segment softmax
    below 256 groups, the one-reduction branch at or above). Tolerance:
    f32 matmul order and LayerNorm's variance formula (flax uses
    E[x^2]-E[x]^2)."""
    jparams, nets, dims = _nets(name)
    D = dims["DIM"]
    args = _edge_problem(1, 96, D, 1152)
    want = JUpdate(dim=D).apply(jparams["update"], *(jnp.asarray(a) for a in args),
                                num_segments=num_segments, num_ij_segments=2048)
    with torch.no_grad():
        got = nets.update(*(torch.as_tensor(np.array(a)) for a in args),
                          num_segments=num_segments, num_ij_segments=2048)
    for g, w in zip(got, want):
        _close_rel(g, w, 2e-5)


def test_update_matches_bf16():
    """bf16 modules (MIXED_PRECISION): flax and torch round to bf16 at
    different places (LayerNorm statistics, bias adds), so hold the result
    to a few bf16 ulps (2^-7 each) of the output scale."""
    jparams, nets, dims = _nets("tiny", mixed=True)
    nets = nets.to(torch.bfloat16)
    args = _edge_problem(2, 64, dims["DIM"], 1152)
    cast = lambda a: a.astype(jnp.bfloat16) if a.dtype == np.float32 else a
    want = JUpdate(dim=dims["DIM"], dtype=jnp.bfloat16).apply(
        jparams["update"], *(cast(jnp.asarray(a)) for a in args), num_segments=2048,
        num_ij_segments=2048)
    with torch.no_grad():
        targs = [torch.as_tensor(np.array(a)) for a in args]
        targs = [t.to(torch.bfloat16) if t.dtype == torch.float32 else t for t in targs]
        got = nets.update(*targs, num_segments=2048, num_ij_segments=2048)
    for g, w in zip(got, want):
        _close_rel(g.float(), np.asarray(w, np.float32), 8 * 2.0 ** -7)


def test_segment_softmax_matches():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((50, 4)).astype(np.float32)
    seg = rng.integers(0, 7, 50)
    valid = rng.uniform(size=50) > 0.2
    want = j_segment_softmax(jnp.asarray(x), jnp.asarray(seg), 9, jnp.asarray(valid))
    got = segment_softmax(torch.as_tensor(x), torch.as_tensor(seg), 9, torch.as_tensor(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("ns", [9, 2560])
def test_grouped_sum_matches_segment_sum(ns):
    """SoftAgg's grouped sum on the CPU is the segment-sum kernel's plain
    version, the function it takes on the card: f32 sums row after row in
    edge order (the kernel's sorted order) within pieces of CHUNK rows, the
    pieces then added in order (at ns = 9 each group has ~300 rows), the
    same bits for an f32 and a bf16 payload; rows of seg >= ns are
    dropped."""
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((3000, 16)).astype(np.float32))
    seg = torch.as_tensor(rng.integers(0, ns + 1, 3000).astype(np.int32))
    got = grouped_sum(x, seg, ns)
    want = np.zeros((ns, 16), np.float32)
    for s in range(ns):
        rows = x.numpy()[seg.numpy() == s]
        for a in range(0, len(rows), CHUNK):
            piece = np.zeros(16, np.float32)
            np.add.at(piece[None], np.zeros(len(rows[a:a + CHUNK]), int), rows[a:a + CHUNK])
            want[s] += piece
    assert got.dtype == torch.float32 and got.shape == (ns, 16)
    assert np.array_equal(got.numpy(), want)
    xb = x.to(torch.bfloat16)
    assert torch.equal(grouped_sum(xb, seg, ns), segment_sum_plain(xb.float(), seg, ns))


def test_npz_tree_equals_load_params():
    """The rebuilt tree is exactly what the JAX package loads."""
    from dpvo_tpu.config import Config as JConfig

    path, dims = CKPTS["tiny"]
    want = load_params(path, JConfig(MIXED_PRECISION=False, **dims))
    got = jax_params_from_npz(path)
    flat_w = __import__("jax").tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(__import__("jax").tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for k, v in flat_w:
        np.testing.assert_array_equal(np.asarray(flat_g[k]), np.asarray(v))


@pytest.mark.parametrize("name", ["tiny", "flagship"])
def test_params_from_jax_consumes_every_key(name):
    flat = load_npz(CKPTS[name][0])
    sd = params_from_jax(flat)
    assert len(sd) == len(flat)
    bad = dict(flat)
    bad["['update']['params']['Dense_0']['oops']"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        params_from_jax(bad)
    missing = dict(flat)
    missing.pop(next(iter(missing)))
    with pytest.raises(RuntimeError):
        load_networks(Config(**CKPTS[name][1]), missing)
