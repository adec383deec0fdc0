"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; without a CUDA device every test skips. On the card:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 128), (torch.float32, 32)])
def test_corr_kernel_matches_plain(dev, dtype, C):
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.ops.corr import corr_features_plain
    from dpvo_tpu_torch.ops.corr_cuda import corr_features

    g = torch.Generator().manual_seed(C)
    E = 500
    gmap = torch.randn(64, C, 3, 3, generator=g).to(dtype)
    f1 = torch.randn(6, 24, 32, C, generator=g).to(dtype)
    f2 = torch.randn(6, 6, 8, C, generator=g).to(dtype)
    base = torch.rand(E, 1, 1, 2, generator=g) * torch.tensor([40.0, 32.0]) - 4
    grid = torch.stack(torch.meshgrid(torch.arange(-1.0, 2.0), torch.arange(-1.0, 2.0),
                                      indexing="ij"), -1).flip(-1)
    coords = (base + grid[None] + 0.5 * torch.rand(E, 3, 3, 2, generator=g)).contiguous()
    ii = torch.randint(0, 64, (E,), generator=g, dtype=torch.int32)
    jj = torch.randint(0, 6, (E,), generator=g, dtype=torch.int32)
    valid = torch.rand(E, generator=g) > 0.1
    args = (gmap, f1, f2, coords, ii, jj, valid)
    want = corr_features_plain(*args).float()
    before = kernels.LAUNCHES["corr"]
    got = corr_features(*(a.to(dev) for a in args)).float().cpu()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["corr"] == before + 1
    # one bf16 ulp, plus f32 accumulation error where a value cancels
    tol = 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + 2e-3
    assert ((got - want).abs() <= tol).all()


def test_segsum_kernel_matches_plain(dev):
    from dpvo_tpu_torch.ba.segsum import segment_sum, segment_sum_plain

    g = torch.Generator().manual_seed(1)
    E, K, Md = 3000, 98, 200
    kd = torch.cat([torch.arange(Md), torch.randint(0, Md, (E - Md,), generator=g)])
    kd = kd[torch.randperm(E, generator=g)].to(torch.int32)
    order = torch.argsort(kd, stable=True).to(torch.int32)
    payload = torch.randn(E, K, generator=g)
    want = segment_sum_plain(payload, kd, order, Md)
    got = segment_sum(payload.to(dev), kd.to(dev), order.to(dev), Md).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [48, 96])
def test_spd_kernel_matches_plain_with_gradient(dev, n):
    from dpvo_tpu_torch.ba.spd_solve import spd_solve, spd_solve_plain

    g = torch.Generator().manual_seed(n)
    A = torch.randn(n, n, generator=g)
    S = A @ A.T + n * torch.eye(n)
    y = torch.randn(n, generator=g)
    w = torch.randn(n, generator=g)
    out = []
    for fn, d in ((spd_solve, dev), (spd_solve_plain, torch.device("cpu"))):
        Sg = S.to(d).requires_grad_()
        yg = y.to(d).requires_grad_()
        x = fn(Sg, yg)
        (w.to(d) * x * x).sum().backward()
        out.append([t.detach().cpu() for t in (x, Sg.grad, yg.grad)])
    for a, b in zip(*out):  # f32 Gauss-Jordan, well-conditioned system
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5 * b.abs().max().item())


def _tile_inputs(C, E=300, mem=5, H=24, W=32, seed=0):
    """Inputs of the correlation kernels A-C: sorted patch rows, maps, slots,
    validity and window / superwindow corners around and beyond the map."""
    g = torch.Generator().manual_seed(seed)
    f1 = torch.randn(E, 9, C, generator=g).to(torch.bfloat16)
    fmap = torch.randn(mem, H, W, C, generator=g).to(torch.bfloat16)
    jj = torch.randint(0, mem, (E,), generator=g, dtype=torch.int32)
    valid = torch.rand(E, generator=g) > 0.2
    sy = torch.randint(-8, H + 1, (E, 9), generator=g, dtype=torch.int32)
    sx = torch.randint(-8, W + 1, (E, 9), generator=g, dtype=torch.int32)
    syc = torch.randint(-16, H + 1, (E,), generator=g, dtype=torch.int32)
    sxc = torch.randint(-2, W // 8 + 1, (E,), generator=g, dtype=torch.int32) * 8
    return f1, fmap, jj, valid, (sy, sx), (syc, sxc)


@pytest.mark.parametrize("C", [128, 32])
@pytest.mark.parametrize("name", ["corr_window", "corr_sw", "corr_v3"])
def test_corr_tile_kernels_match_plain(dev, name, C):
    """Kernels A-C (tensor-core dots, f32 accumulation) against their plain
    versions: one bf16 ulp, plus f32 accumulation error where a value
    cancels (the tensor cores sum in their own order)."""
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.ops import corr_pallas as cp

    f1, fmap, jj, valid, win, sup = _tile_inputs(C)
    fn = {"corr_window": cp.corr_window, "corr_sw": cp.superwindow_sw,
          "corr_v3": cp.superwindow_v3}[name]
    corners = win if name == "corr_window" else sup
    want = fn(f1, fmap, jj, valid, *corners).float()
    before = kernels.LAUNCHES[name]
    got = fn(*(t.to(dev) for t in (f1, fmap, jj, valid) + corners)).float().cpu()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert got.shape == want.shape and (got[~valid] == 0).all()
    tol = 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + 2e-3
    assert ((got - want).abs() <= tol).all()


def test_corr_epilogue_kernel_matches_plain_bitwise(dev):
    """Kernel D rounds where its plain version rounds and contracts nothing
    into FMAs: the same bits."""
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.ops import corr_pallas as cp

    g = torch.Generator().manual_seed(3)
    E = 500
    s = (8 * torch.randn(E, 9, 384, generator=g)).to(torch.bfloat16)
    dy = torch.randint(0, 8, (E, 9), generator=g, dtype=torch.int32)
    dxw = torch.randint(0, 16, (E, 9), generator=g, dtype=torch.int32)
    dyf, dxf = torch.rand(E, 9, generator=g), torch.rand(E, 9, generator=g)
    vf = (torch.rand(E, 9, generator=g) > 0.1).float()
    args = (s, dy, dxw, dyf, dxf, vf)
    want = cp.epilogue_v3(*args)
    before = kernels.LAUNCHES["corr_v3_epi"]
    got = cp.epilogue_v3(*(t.to(dev) for t in args)).cpu()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["corr_v3_epi"] == before + 1
    assert torch.equal(got, want)


def test_corr_clamp_mode_matches_plain(dev):
    """corr.cu with v4's clamp (CORR_IMPL=pallas_fused) on pixels spread 5 px
    apart, where the clamp bites."""
    from dpvo_tpu_torch.ops.corr import corr_features_plain
    from dpvo_tpu_torch.ops.corr_cuda import corr_features

    g = torch.Generator().manual_seed(4)
    E = 400
    gmap = torch.randn(64, 128, 3, 3, generator=g).to(torch.bfloat16)
    f1 = torch.randn(6, 24, 32, 128, generator=g).to(torch.bfloat16)
    f2 = torch.randn(6, 6, 8, 128, generator=g).to(torch.bfloat16)
    base = torch.rand(E, 1, 1, 2, generator=g) * torch.tensor([40.0, 32.0]) - 4
    grid = torch.stack(torch.meshgrid(torch.arange(-1.0, 2.0), torch.arange(-1.0, 2.0),
                                      indexing="ij"), -1).flip(-1)
    coords = (base + 5 * grid[None] + torch.rand(E, 3, 3, 2, generator=g)).contiguous()
    ii = torch.randint(0, 64, (E,), generator=g, dtype=torch.int32)
    jj = torch.randint(0, 6, (E,), generator=g, dtype=torch.int32)
    valid = torch.rand(E, generator=g) > 0.1
    args = (gmap, f1, f2, coords, ii, jj, valid)
    want = corr_features_plain(*args, clamp=True).float()
    got = corr_features(*(a.to(dev) for a in args), clamp=True).float().cpu()
    tol = 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + 2e-3
    assert ((got - want).abs() <= tol).all()
    exact = corr_features_plain(*args).float()
    assert ((exact - want).abs() > tol).any()  # the clamp bites on these pixels


def test_soft_agg_is_reproducible(dev):
    """SoftAgg's grouped sums go through the sorted segment-sum kernel, so
    two card runs give the same bits (index_add_'s float atomics did not)."""
    from dpvo_tpu_torch.models.blocks import SoftAgg

    torch.manual_seed(5)
    agg = SoftAgg(64).to(dev)
    g = torch.Generator().manual_seed(5)
    E = 4000
    x = torch.randn(E, 64, generator=g).to(dev)
    for ns in (2048, 128):  # the one-reduction branch and the segment softmax
        seg = torch.randint(0, ns, (E,), generator=g, dtype=torch.int32).to(dev)
        valid = (torch.rand(E, generator=g) > 0.1).to(dev)
        with torch.no_grad():
            a, b = agg(x, seg, ns, valid), agg(x, seg, ns, valid)
            ref = agg.cpu()(x.cpu(), seg.cpu().long(), ns, valid.cpu())
            agg.to(dev)
        assert torch.equal(a, b)
        torch.testing.assert_close(a.cpu(), ref, rtol=1e-4, atol=1e-5)
