"""Port parity: patchify, pooling and the plain two-level correlation of
dpvo_tpu_torch against the JAX package's XLA path and its v4 Pallas
kernel (interpret mode), on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_tpu.ops import avg_pool2d_nhwc as j_pool_nhwc
from dpvo_tpu.ops import corr_features_xla
from dpvo_tpu.ops import patchify as j_patchify
from dpvo_tpu.ops.corr_pallas import corr_features_pallas_fused
from dpvo_tpu.ops.corr_pallas import corr_sort_order as j_sort_order
from dpvo_tpu_torch.ops import corr as tcorr
from dpvo_tpu_torch.ops.corr_cuda import corr_features
from dpvo_tpu_torch.ops.corr_pallas import device_sort_order

BF16_ULP = 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value's magnitude


def assert_bf16_close(got, want, ulps=1):
    """Both sides accumulate in f32 in different orders and round to bf16,
    so a value near a rounding boundary may land one ulp apart."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = ulps * BF16_ULP * np.maximum(np.abs(got), np.abs(want)) + 1e-6
    bad = np.abs(got - want) > tol
    assert not bad.any(), (np.abs(got - want).max(), bad.sum())


def make_inputs(seed, E, Np=24, mem=4, C=128, H1=24, W1=32, spread=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    gmap = rng.standard_normal((Np, C, 3, 3)).astype(np.float32)
    fmap1 = rng.standard_normal((mem, H1, W1, C)).astype(np.float32)
    fmap2 = rng.standard_normal((mem, H1 // 4, W1 // 4, C)).astype(np.float32)
    base = rng.uniform(-4, W1 + 4, (E, 1, 1, 2))
    grid = np.stack(np.meshgrid(np.arange(-1, 2), np.arange(-1, 2), indexing="ij"), -1)
    coords = (base + spread * grid[None][..., ::-1]
              + rng.uniform(0, 1, (E, 3, 3, 2))).astype(np.float32)
    ii1 = rng.integers(0, Np, E).astype(np.int32)
    jj1 = rng.integers(0, mem, E).astype(np.int32)
    valid = rng.uniform(size=E) > 0.2
    return gmap, fmap1, fmap2, coords, ii1, jj1, valid


def _jax(args, dtype):
    g, f1, f2, c, ii, jj, v = args
    return (jnp.asarray(g, dtype), jnp.asarray(f1, dtype), jnp.asarray(f2, dtype),
            jnp.asarray(c), jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(v))


def _torch(args, dtype):
    g, f1, f2, c, ii, jj, v = args
    return (torch.as_tensor(g).to(dtype), torch.as_tensor(f1).to(dtype),
            torch.as_tensor(f2).to(dtype), torch.as_tensor(c), torch.as_tensor(ii).long(),
            torch.as_tensor(jj).long(), torch.as_tensor(v))


@pytest.mark.parametrize("dtype,impl", [("f32", "region"), ("f32", "gather"), ("bf16", "gather")])
def test_plain_matches_corr_features_xla(dtype, impl):
    """Exact windows == the XLA path, both levels, canonical layout. Its
    default 16-px region covers every window at real patch geometry
    (XLA:CPU runs the region dot only in f32)."""
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    args = make_inputs(0, E=57)
    want = corr_features_xla(*_jax(args, jd), impl=impl)
    got = corr_features(*_torch(args, td))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (57, 9, 128)
    assert_bf16_close(got.float(), want)


def test_plain_matches_v4_pallas_interpret():
    """The v4 TPU kernel (interpret mode) at E=128, real patch geometry
    (its +-3 px clamp does not bite). v4 rounds its bilinear and selection
    coefficients to bf16 (corr_pallas._level_coeffs), so its error scales
    with the largest value, not each value: within one bf16 ulp of max|x|."""
    args = make_inputs(1, E=128, mem=3, H1=24, W1=32)
    want = np.asarray(corr_features_pallas_fused(*_jax(args, jnp.bfloat16), interpret=True),
                      np.float32)
    got = corr_features(*_torch(args, torch.bfloat16)).float().numpy()
    assert np.abs(got - want).max() <= BF16_ULP * np.abs(want).max()


def test_wide_spread_edge_matches_exact_gather():
    """Patch pixels spread ~5 px apart (beyond v4's +-3 px clamp): the
    port stays exact, like impl='gather' (the region path would not)."""
    args = make_inputs(2, E=6, spread=5.0, H1=32, W1=40)
    want = corr_features_xla(*_jax(args, jnp.float32), impl="gather")
    got = corr_features(*_torch(args, torch.float32))
    assert_bf16_close(got.float(), want)


def test_invalid_edges_are_zero():
    args = make_inputs(3, E=20)
    got = corr_features(*_torch(args, torch.float32))
    assert (got[~torch.as_tensor(args[6])] == 0).all()
    assert (got.reshape(20, 9, 2, 8, 8)[..., 7, :] == 0).all()
    assert (got.reshape(20, 9, 2, 8, 8)[..., :, 7] == 0).all()


@pytest.mark.parametrize("radius", [0, 1])
def test_patchify_matches(radius):
    rng = np.random.default_rng(4)
    fmap = rng.standard_normal((5, 12, 16)).astype(np.float32)
    coords = rng.uniform(-2, 17, (30, 2)).astype(np.float32)
    want = np.asarray(j_patchify(jnp.asarray(fmap), jnp.asarray(coords), radius))
    got = tcorr.patchify(torch.as_tensor(fmap), torch.as_tensor(coords), radius).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)  # f32, same arithmetic


def test_avg_pool_matches():
    x = np.random.default_rng(5).standard_normal((2, 8, 12, 3)).astype(np.float32)
    want = np.asarray(j_pool_nhwc(jnp.asarray(x), 4))
    got = tcorr.avg_pool2d_nhwc(torch.as_tensor(x), 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    got2 = tcorr.avg_pool2d(torch.as_tensor(x).permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got2.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_valid", [300, 250])
def test_corr_sort_order_matches(n_valid):
    """The port sorts the edges on the device; the JAX host's
    corr_sort_order keys invalid edges as uint16 max, the device sort as
    2^30: the same valid-first stable order and inverse either way."""
    jj = np.random.default_rng(6).integers(0, 4096, 300)
    jj1 = torch.zeros(384, dtype=torch.int32)
    jj1[:n_valid] = torch.as_tensor(jj[:n_valid] % 32)
    got = device_sort_order(jj1, torch.arange(384) < n_valid)
    for a, b in zip(got, j_sort_order(jj, n_valid, 384, 32)):
        np.testing.assert_array_equal(a.numpy(), b)
