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
