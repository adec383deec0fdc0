"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; without a CUDA device every test skips. On the card:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)


pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 128), (torch.bfloat16, 32),
                                     (torch.float32, 32)])
def test_corr_kernel_matches_plain(dev, dtype, C):
    """Patches 1 px apart and, on 5% of the edges, 3-6 px apart, windows
    partly outside the maps: at bf16 C = 128 the tile kernel takes both of
    its branches (union tile and per-pixel windows); bf16 at C = 32 and f32
    run the per-pixel kernel."""
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.ops.corr import corr_features_plain
    from dpvo_tpu_torch.ops.corr_cuda import corr_features, union_tile_levels

    g = torch.Generator().manual_seed(C)
    E = 500
    gmap = torch.randn(64, C, 3, 3, generator=g).to(dtype)
    f1 = torch.randn(6, 24, 32, C, generator=g).to(dtype)
    f2 = torch.randn(6, 6, 8, C, generator=g).to(dtype)
    base = torch.rand(E, 1, 1, 2, generator=g) * torch.tensor([40.0, 32.0]) - 4
    grid = torch.stack(torch.meshgrid(torch.arange(-1.0, 2.0), torch.arange(-1.0, 2.0),
                                      indexing="ij"), -1).flip(-1)
    spread = torch.where(torch.rand(E, 1, 1, 1, generator=g) < 0.05,
                         3 + 3 * torch.rand(E, 1, 1, 1, generator=g), torch.ones(E, 1, 1, 1))
    coords = (base + spread * grid[None] + 0.5 * torch.rand(E, 3, 3, 2, generator=g)).contiguous()
    ii = torch.randint(0, 64, (E,), generator=g, dtype=torch.int32)
    jj = torch.randint(0, 6, (E,), generator=g, dtype=torch.int32)
    valid = torch.rand(E, generator=g) > 0.1
    args = (gmap, f1, f2, coords, ii, jj, valid)
    tiles = union_tile_levels(coords, (24, 32), (6, 8))
    assert tiles.all(1).any() and not tiles.all()  # both branches
    want = corr_features_plain(*args).float()
    before = kernels.LAUNCHES["corr"]
    got = corr_features(*(a.to(dev) for a in args)).float().cpu()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["corr"] == before + 1
    # one bf16 ulp, plus f32 accumulation error where a value cancels
    tol = 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + 2e-3
    assert ((got - want).abs() <= tol).all()


@pytest.mark.parametrize("dtype,K", [(torch.float32, 98), (torch.bfloat16, 768),
                                     (torch.float32, 600), (torch.float32, 33),
                                     (torch.bfloat16, 20), (torch.bfloat16, 9)])
def test_segsum_kernel_matches_plain(dev, dtype, K):
    """The kernel adds each segment's rows in sorted order with plain f32
    adds, as the plain version does on the CPU (index_add_, row after row):
    the same bits, for an f32 and a bf16 payload, with a 500-row run, empty
    segments and ids outside [0, Md), which are dropped. The path's rows
    (BA f32 K = 98: 8-byte loads; SoftAgg bf16 K = 768: 16-byte loads), two
    column passes (f32 K = 600) and 4-, 8- and 2-byte loads (K = 33 f32, 20
    and 9 bf16)."""
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.ba.segsum import segment_sum, segment_sum_plain

    g = torch.Generator().manual_seed(K)
    E, Md = 3000, 200
    kd = torch.cat([torch.arange(Md), torch.full((500,), 17),
                    torch.randint(-2, Md + 3, (E - Md - 500,), generator=g)])
    kd = kd[torch.randperm(E, generator=g)]
    kd[(kd > 50) & (kd < 60)] = 60  # empty segments 51-59
    kd = kd.to(torch.int32)
    order = torch.argsort(kd, stable=True).to(torch.int32)
    payload = (torch.randn(E, K, generator=g) * torch.rand(E, 1, generator=g) * 100).to(dtype)
    want = segment_sum_plain(payload, kd, Md)
    name = "segsum_bf16" if dtype == torch.bfloat16 else "segsum"
    before = kernels.LAUNCHES[name]
    got = segment_sum(payload.to(dev), kd.to(dev), order.to(dev), Md).cpu()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert (got[51:60] == 0).all()


@pytest.mark.parametrize("n", [48, 96])
def test_spd_kernel_matches_plain_with_gradient(dev, n):
    """The Cholesky kernel, forward and backward (the autograd Function),
    against the plain version, forward and the same adjoint (y_bar =
    S^-1 g, S_bar = -y_bar x^T): f32 rounding of one algorithm on a
    well-conditioned system."""
    from dpvo_tpu_torch.ba.spd_solve import spd_solve, spd_solve_plain

    g = torch.Generator().manual_seed(n)
    A = torch.randn(n, n, generator=g)
    S = A @ A.T + n * torch.eye(n)
    y = torch.randn(n, generator=g)
    w = torch.randn(n, generator=g)
    Sg = S.to(dev).requires_grad_()
    yg = y.to(dev).requires_grad_()
    x = spd_solve(Sg, yg)
    (w.to(dev) * x * x).sum().backward()
    got = [t.detach().cpu() for t in (x, Sg.grad, yg.grad)]
    xp = spd_solve_plain(S, y)
    yb = spd_solve_plain(S, 2 * w * xp)
    for a, b in zip(got, (xp, -torch.outer(yb, xp), yb)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5 * b.abs().max().item())


def test_spd_kernel_nonpositive_pivot_is_nonfinite(dev):
    from dpvo_tpu_torch.ba.spd_solve import spd_solve

    S = torch.eye(96) * 2
    S[40, 40] = -1.0
    assert not torch.isfinite(spd_solve(S.to(dev), torch.ones(96, device=dev)).cpu()).all()


def _features(C, E, mem, H, W, g, integer=False):
    """Sorted patch rows, maps, slots and validity of the correlation
    kernels A-C+D. integer: small integer values, so that every f32 dot is
    exact in any summation order."""
    feat = (lambda *s: torch.randint(-3, 4, s, generator=g).float()) if integer else (
        lambda *s: torch.randn(*s, generator=g))
    f1 = feat(E, 9, C).to(torch.bfloat16)
    fmap = feat(mem, H, W, C).to(torch.bfloat16)
    jj = torch.randint(0, mem, (E,), generator=g, dtype=torch.int32)
    valid = torch.rand(E, generator=g) > 0.2
    return f1, fmap, jj, valid


def _patch_coords(E, H, W, g, spread):
    """[E, 9, 2] pixel coordinates of patches around and beyond the map,
    pixels `spread` px apart (per edge) plus up to 1 px of jitter."""
    off = torch.stack(torch.meshgrid(torch.arange(-1.0, 2.0), torch.arange(-1.0, 2.0),
                                     indexing="ij"), -1).flip(-1).reshape(9, 2)
    base = torch.rand(E, 1, 2, generator=g) * torch.tensor([W + 16.0, H + 16.0]) - 8
    return base + spread[:, None, None] * off + torch.rand(E, 9, 2, generator=g)


def _window_inputs(C, E=300, mem=5, H=24, W=32, seed=0):
    """Kernel A's inputs: window corners of patches 1 px apart (first half:
    its union branch), 6 px apart (next quarter: its per-pixel branch) and
    anywhere (last quarter)."""
    g = torch.Generator().manual_seed(seed)
    f1, fmap, jj, valid = _features(C, E, mem, H, W, g)
    spread = torch.where(torch.arange(E) < E // 2, 1.0, 6.0)
    coords = _patch_coords(E, H, W, g, spread)
    coords[3 * E // 4:] = torch.rand(E - 3 * E // 4, 9, 2, generator=g) * torch.tensor(
        [W + 16.0, H + 16.0]) - 8
    sy = torch.floor(coords[..., 1]).to(torch.int32) - 3
    sx = torch.floor(coords[..., 0]).to(torch.int32) - 3
    return f1, fmap, jj, valid, (sy, sx)


@pytest.mark.parametrize("C", [32, 64, 128, 256])
def test_corr_window_kernel_matches_plain(dev, C):
    """Kernel A (tensor-core dots, f32 accumulation) against its plain
    version: one bf16 ulp, plus f32 accumulation error where a value
    cancels (the tensor cores sum in their own order). A takes both of its
    branches: the union of patches 1 px apart from its dot grid, spread
    patches by per-pixel tiles."""
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.ops import corr_pallas as cp

    f1, fmap, jj, valid, win = _window_inputs(C)
    fits = cp.window_union(*win)[-1]
    assert fits[:150].all() and not fits[150:225].any()
    want = cp.corr_window(f1, fmap, jj, valid, *win).float()
    before = kernels.LAUNCHES["corr_window"]
    got = cp.corr_window(*(t.to(dev) for t in (f1, fmap, jj, valid) + win)).float().cpu()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["corr_window"] == before + 1
    assert got.shape == want.shape and (got[~valid] == 0).all()
    tol = 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + 2e-3
    assert ((got - want).abs() <= tol).all()


def _super_case(name, C, E=400, mem=5, H=24, W=32, seed=0, integer=True):
    """Kernel B's (name "corr_sw_fused") or C+D's ("corr_v3_fused") inputs
    from sw_inputs / v3_inputs on patches 1 px apart and, on a fifth of the
    edges, 5 px apart (the clamps bite); integer features (exact dots: the
    kernel's values are the plain version's) or Gaussian ones. For B, every
    fourth edge has its pixels' windows spread over the whole 14 x 32
    superwindow (dy 0 / 3 / 6 x dxw 0 / 12 / 24), a union of 448 positions:
    its per-pixel branch."""
    from dpvo_tpu_torch.ops import corr_pallas as cp

    g = torch.Generator().manual_seed(seed)
    f1, fmap, jj, valid = _features(C, E, mem, H, W, g, integer=integer)
    spread = torch.where(torch.rand(E, generator=g) < 0.2, 5.0, 1.0)
    inputs = cp.sw_inputs if name == "corr_sw_fused" else cp.v3_inputs
    corner, (dy, dxw, *bilinear) = inputs(_patch_coords(E, H, W, g, spread), valid, H, W, 3)
    if name == "corr_sw_fused":
        p, wide = torch.arange(9), (torch.arange(E) % 4 == 3)[:, None]
        dy = torch.where(wide, (p // 3 * 3).int(), dy)
        dxw = torch.where(wide, (p % 3 * 12).int(), dxw)
        fits = cp.window_union(corner[0][:, None] + dy, corner[1][:, None] + dxw)[-1]
        assert fits[valid].any() and not fits[valid].all()  # both branches
    return (f1, fmap, jj, valid) + corner + (dy, dxw, *bilinear)


def _fused_on_card(args, dev, name="corr_v3_fused"):
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.ops import corr_pallas as cp

    before = kernels.LAUNCHES[name]
    got = getattr(cp, name)(*(t.to(dev) for t in args)).cpu()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    return got


@pytest.mark.parametrize("C", [32, 64, 128, 256])
def test_corr_sw_fused_kernel_matches_plain(dev, C):
    """Kernel B against its plain version (the 14 x 32 superwindow's dots,
    each pixel's window, the 2x2 bilinear), on both of its branches (the
    union from its dot grid, and per-pixel windows): on integer features the dots
    are exact and the bilinear rounds where torch rounds and contracts
    nothing into FMAs, so the same bits; on Gaussian features the tensor
    cores and the plain f32 einsum sum in other orders, which flips a rare
    raw dot by one bf16 ulp: within that ulp carried through the bilinear
    (the bilinear of the raw dots' magnitudes bounds it), as C+D is held."""
    from dpvo_tpu_torch.ops import corr_pallas as cp

    args = _super_case("corr_sw_fused", C)
    want = cp.corr_sw_fused(*args)
    got = _fused_on_card(args, dev, "corr_sw_fused")
    assert got.shape == (400, 9, 64) and torch.equal(got, want)
    assert (want != 0).any()
    args = _super_case("corr_sw_fused", C, seed=1, integer=False)
    f1, fmap, jj, valid, syc, sxc, dy, dxw, dyf, dxf, vf = args
    want = cp.corr_sw_fused(*args).float()
    got = _fused_on_card(args, dev, "corr_sw_fused").float()
    s = cp.superwindow_plain(f1, fmap, jj, valid, syc, sxc, cp.RS, cp.CS).abs()
    env = cp.epilogue_sw_plain(s, dy, dxw, dyf, dxf, vf).float()
    assert ((got - want).abs() <= 2.0 ** -6 * env + 2.0 ** -7 * want.abs() + 2e-3).all()


@pytest.mark.parametrize("dy,dxw", [(0, 0), (0, 24), (6, 0), (6, 24)])
def test_corr_sw_fused_kernel_boundary_cases(dev, dy, dxw):
    """Kernel B at the ends of its window offsets, with bilinear fractions 0
    and 1 and masked pixels: torch.equal to its plain version."""
    from dpvo_tpu_torch.ops import corr_pallas as cp

    f1, fmap, jj, valid, syc, sxc, _, _, _, _, vf = _super_case("corr_sw_fused", 128, E=64,
                                                                seed=10 * dy + dxw)
    g = torch.Generator().manual_seed(dy + dxw)
    full = lambda v: torch.full((64, 9), v, dtype=torch.int32)
    frac = torch.tensor([0.0, 1.0, 0.5, 0.25])[torch.randint(0, 4, (64, 9), generator=g)]
    vf = vf * (torch.rand(64, 9, generator=g) > 0.3).float()
    args = (f1, fmap, jj, valid, syc, sxc, full(dy), full(dxw), frac, frac.flip(0), vf)
    want = cp.corr_sw_fused(*args)
    assert torch.equal(_fused_on_card(args, dev, "corr_sw_fused"), want)
    assert (want[vf == 0] == 0).all() and (want != 0).any()


@pytest.mark.parametrize("C", [32, 64, 128, 256])
def test_corr_v3_fused_kernel_matches_plain(dev, C):
    """Kernel C+D against its plain version (the superwindow's dots, the
    v3 epilogue, the kept 7 x 7): exact dots, and the epilogue rounds
    where the plain version rounds and contracts nothing into FMAs, so the
    same bits."""
    from dpvo_tpu_torch.ops import corr_pallas as cp

    args = _super_case("corr_v3_fused", C)
    want = cp.corr_v3_fused(*args)
    got = _fused_on_card(args, dev)
    assert got.shape == (400, 9, 64) and torch.equal(got, want)
    assert (want != 0).any()


@pytest.mark.parametrize("dy,dxw", [(0, 0), (0, 15), (7, 0), (7, 15)])
def test_corr_v3_fused_kernel_boundary_cases(dev, dy, dxw):
    """Kernel C+D at the ends of its window offsets, with bilinear
    fractions 0 and 1 and masked pixels: the kernel evaluates only the
    live taps of each pixel's window, which gives the plain version's
    values (torch.equal)."""
    from dpvo_tpu_torch.ops import corr_pallas as cp

    f1, fmap, jj, valid, syc, sxc, _, _, _, _, vf = _super_case("corr_v3_fused", 128, E=64,
                                                                seed=10 * dy + dxw)
    g = torch.Generator().manual_seed(dy + dxw)
    full = lambda v: torch.full((64, 9), v, dtype=torch.int32)
    frac = torch.tensor([0.0, 1.0, 0.5, 0.25])[torch.randint(0, 4, (64, 9), generator=g)]
    vf = vf * (torch.rand(64, 9, generator=g) > 0.3).float()
    args = (f1, fmap, jj, valid, syc, sxc, full(dy), full(dxw), frac, frac.flip(0), vf)
    want = cp.corr_v3_fused(*args)
    assert torch.equal(_fused_on_card(args, dev), want)
    assert (want[vf == 0] == 0).all()  # vf = 0 pixels are zero


@pytest.mark.parametrize("name", ["corr_window", "corr_sw_fused", "corr_v3_fused"])
def test_corr_union_kernels_zero_invalid_edges(dev, name):
    """Kernels A, B and C+D write zeros for an invalid edge and for a valid
    edge whose slot jj is out of range (-1, mem)."""
    from dpvo_tpu_torch.ops import corr_pallas as cp

    if name == "corr_window":
        f1, fmap, jj, valid, win = _window_inputs(128)
        args = [f1, fmap, jj, valid, *win]
    else:
        args = list(_super_case(name, 128))
    mem = args[1].shape[0]
    args[3] = args[3].clone()
    args[3][:40] = True
    args[2] = args[2].clone()
    args[2][:20] = torch.where(torch.arange(20) % 2 == 0, -1, mem)
    got = getattr(cp, name)(*(t.to(dev) for t in args)).cpu()
    torch.cuda.synchronize()
    valid, jj = args[3], args[2]
    dead = ~valid | (jj < 0) | (jj >= mem)
    assert dead[:20].all() and (got[dead] == 0).all() and (got[~dead] != 0).any()


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


def test_segsum_kernel_at_global_ba_shapes(dev):
    """The seven reductions of a global-BA iteration (chip_smoke.gba_reductions:
    build_sparse_indices' ids and orders for 20 free keyframes of 32 patches,
    K = 2, 6 and 36 f32, pose blocks into W^2 segments, kpairs in sorted
    order), bit for bit against the plain version."""
    import chip_smoke
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.ba.segsum import segment_sum, segment_sum_plain

    calls, sizes = chip_smoke.gba_reductions(torch, torch.Generator().manual_seed(6), dev,
                                             n=20, M=32, reach=6)
    assert sizes["KP"] > 50_000
    before = kernels.LAUNCHES["segsum"]
    for name, (p, kd, order, Md) in calls.items():
        got = segment_sum(p, kd, order, Md).cpu()
        assert torch.equal(got, segment_sum_plain(p.cpu(), kd.cpu(), Md)), name
    assert kernels.LAUNCHES["segsum"] == before + len(calls)


# |card - CPU| of the sparse global BA on chip_smoke.gba_problem (two
# iterations), as chip_smoke.py phase 5 prints it on an H100 (PR 7): with
# the dense solve on the CPU for both (LAPACK's Cholesky) 2.1e-6 (poses)
# and 4.4e-6 (depths), the assembly's f32 rounding; with each side's own
# solve 2.03e-4 and 3.50e-4: cuSOLVER's f32 Cholesky against LAPACK's on
# an ill-conditioned system (S = B - E Q E^T cancels most of B). Doubled.
GBA_CARD_ATOL = dict(cpu_solve=(5e-6, 1e-5), own_solve=(4.1e-4, 7.1e-4))


def test_gba_on_the_card_matches_the_cpu(dev):
    """The sparse global BA on the card against the CPU on a synthetic
    problem, within GBA_CARD_ATOL (chip_smoke.gba_card_vs_cpu: with the
    dense solve on the CPU for both, and each with its own); two card runs
    give the same bits; each of a run's two iterations launches seven
    segment sums."""
    import chip_smoke

    out = chip_smoke.gba_card_vs_cpu(torch, dev)
    assert out["segsum_launches"] == 2 * 7
    assert out["repeat_equal"] and out["step"] > 1e-3  # the solve moved the poses
    for k, tols in GBA_CARD_ATOL.items():
        for d, tol in zip(out[k], tols):
            assert d <= tol, (k, out[k])


def test_segsum_kernel_at_classic_loop_closure_shapes(dev):
    """The PGO's two reductions (H blocks [4R, 49] into n^2 segments, g terms
    [2R, 7] into n; chip_smoke.pgo_reductions at 60 poses and at 8) and the
    triplet BA's depth reduction ([1024, 26] into 512), bit for bit against
    the plain version."""
    import chip_smoke
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.ba.segsum import segment_sum, segment_sum_plain

    calls = (list(chip_smoke.pgo_reductions(torch, dev).values())
             + list(chip_smoke.pgo_reductions(torch, dev, n=8, seed=1).values())
             + [chip_smoke.triplet_reduction(torch, dev)])
    before = kernels.LAUNCHES["segsum"]
    for p, kd, order, Md in calls:
        got = segment_sum(p, kd, order, Md).cpu()
        assert torch.equal(got, segment_sum_plain(p.cpu(), kd.cpu(), Md)), (p.shape, Md)
    assert kernels.LAUNCHES["segsum"] == before + len(calls)


def test_spd_kernel_at_the_triplet_size(dev):
    """n = 24 (the triplet BA's W = 4): with no pose free the system is
    S = I, y = 0 and x = 0 bit for bit; a random SPD system of that size
    matches the plain version within 1e-4 relative."""
    from dpvo_tpu_torch.ba.spd_solve import spd_solve, spd_solve_plain

    n = 24
    x = spd_solve(torch.eye(n, device=dev), torch.zeros(n, device=dev))
    assert torch.equal(x.cpu(), torch.zeros(n))
    g = torch.Generator().manual_seed(24)
    A = torch.randn(n, n, generator=g)
    S, y = A @ A.T + n * torch.eye(n), torch.randn(n, generator=g)
    got, want = spd_solve(S.to(dev), y.to(dev)).cpu(), spd_solve_plain(S, y)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def _drifty_loop(n=40):
    """tests/test_pgo.py:make_drifty_loop on the port (a closed loop of n
    poses, the estimate drifting by a fixed twist a step) and its ideal
    loop constraint 38 -> 1 (C = G_j G_i^-1, G the inverse poses)."""
    from dpvo_tpu_torch.lie import se3, sim3

    step = se3.exp(torch.tensor([0.1, 0, 0, 0, 2 * np.pi / n, 0]))
    noise = se3.exp(0.01 * torch.tensor([1, 0.5, 0, 0, 0.5, 0]))
    gt, est = [se3.identity()], [se3.identity()]
    for _ in range(1, n):
        gt.append(se3.mul(step, gt[-1]))
        est.append(se3.mul(se3.mul(step, noise), est[-1]))
    gt, est = torch.stack(gt), torch.stack(est)
    Gi, Gj = (sim3.inv(sim3.from_se3(gt[k])) for k in (n - 2, 1))
    return est.numpy(), sim3.mul(Gj, sim3.inv(Gi))[None].numpy()


# |card - CPU| of apply_loop_closure on _drifty_loop: two f32 Cholesky
# implementations (cuSOLVER, LAPACK) of the PGO's ill-conditioned system
# (condition ~1e7); the re-anchoring fixes the gauge. Written as 1e-3 before
# the first card run, which measured 4.83e-5 of |x| <= 1.39 on an H100:
# doubled.
PGO_CARD_ATOL = 1e-4


def test_pgo_on_the_card_matches_the_cpu(dev):
    """The Sim(3) PGO (apply_loop_closure) on the card against the CPU within
    PGO_CARD_ATOL; two card runs give the same bits; each LM step launches
    two segment sums."""
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.slam import pgo

    est, C = _drifty_loop()
    args = (est, C, np.array([38]), np.array([1]))
    cpu = pgo.apply_loop_closure(*args, device="cpu")
    before = kernels.LAUNCHES["segsum"]
    card = pgo.apply_loop_closure(*args, device=dev)
    launches = kernels.LAUNCHES["segsum"] - before
    again = pgo.apply_loop_closure(*args, device=dev)
    print(f"PGO card vs CPU: {np.abs(card - cpu).max():.3g} (of |x| <= {np.abs(cpu).max():.3g}); "
          f"segsum launches {launches}")
    assert np.array_equal(card, again) and np.isfinite(card).all()
    assert launches > 0 and launches % 4 == 0  # 2 steps an iteration, 2 sums a step
    assert np.abs(card - cpu).max() <= PGO_CARD_ATOL
