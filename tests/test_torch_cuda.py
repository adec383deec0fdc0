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


def _chunk_runs_case(dtype, K, seed):
    """Runs of 1, CHUNK - 1, CHUNK, CHUNK + 1, 2 CHUNK + 1 and ~30 CHUNK rows,
    short runs around them, empty segments 50-59, ids below 0 and at or
    above Md (dropped), shuffled; E not a multiple of CHUNK."""
    from dpvo_tpu_torch.ba.segsum import CHUNK

    g = torch.Generator().manual_seed(seed)
    Md = 80
    long_ids = {3: 1, 10: CHUNK - 1, 11: CHUNK, 20: CHUNK + 1, 21: 2 * CHUNK + 1,
                40: 30 * CHUNK + 5}
    short = [i for i in range(Md) if i not in long_ids and not 50 <= i < 60]
    dropped = torch.tensor([-1, -5, Md, Md + 3])
    kd = torch.cat([torch.full((n,), i) for i, n in long_ids.items()]
                   + [torch.tensor(short)[torch.randint(0, len(short), (700,), generator=g)],
                      dropped[torch.randint(0, 4, (63,), generator=g)]])
    kd = kd[torch.randperm(kd.shape[0], generator=g)].to(torch.int32)
    assert kd.shape[0] % CHUNK
    order = torch.argsort(kd, stable=True).to(torch.int32)
    payload = (torch.randn(kd.shape[0], K, generator=g)
               * torch.rand(kd.shape[0], 1, generator=g) * 100).to(dtype)
    return payload, kd, order, Md


@pytest.mark.parametrize("dtype,K", [(torch.float32, 1), (torch.float32, 2), (torch.float32, 6),
                                     (torch.float32, 7), (torch.float32, 36),
                                     (torch.float32, 49), (torch.float32, 98),
                                     (torch.bfloat16, 768)])
def test_segsum_kernel_long_runs_match_plain(dev, dtype, K):
    """Runs around and beyond CHUNK rows (one piece, two, three, ~30) beside
    short ones: the kernel's CHUNK-row pieces, each summed in sorted order
    and then added in piece order, are the plain version's bits, at row
    widths that take every row-group count (K = 1, 2, 6: 8 row groups; 7:
    1-float vectors in 4; 36: 3; 49: one pass of 2 vectors a lane; 98; bf16
    768: 16-byte loads); one launch a call, and a second launch gives the
    same bits."""
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.ba.segsum import segment_sum, segment_sum_plain

    payload, kd, order, Md = _chunk_runs_case(dtype, K, K)
    want = segment_sum_plain(payload, kd, Md)
    name = "segsum_bf16" if dtype == torch.bfloat16 else "segsum"
    args = (payload.to(dev), kd.to(dev), order.to(dev), Md)
    before = kernels.LAUNCHES[name]
    got = segment_sum(*args).cpu()
    again = segment_sum(*args).cpu()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(again, got)
    assert (got[50:60] == 0).all()


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


def _train_corr_case(dtype, E, F=15, M=80, H=120, W=160, C=128, seed=0, spread_share=0.05,
                     spread_px=(3.0, 6.0), jj=None):
    """corr_bwd's inputs at the training shape: patches 1 px apart around
    centres over the map and 8 px past its borders (spread_px apart on
    spread_share of the edges), 3% of the edges invalid; jj random slots
    unless given."""
    g = torch.Generator().manual_seed(seed)
    gmap = torch.randn(F * M, C, 3, 3, generator=g).to(dtype)
    f1 = torch.randn(F, H, W, C, generator=g).to(dtype)
    f2 = torch.randn(F, H // 4, W // 4, C, generator=g).to(dtype)
    ctr = torch.rand(E, 1, 1, 2, generator=g) * torch.tensor([W + 16.0, H + 16.0]) - 8
    grid = torch.stack(torch.meshgrid(torch.arange(-1.0, 2.0), torch.arange(-1.0, 2.0),
                                      indexing="ij"), -1).flip(-1)
    lo, hi = spread_px
    spread = torch.where(torch.rand(E, 1, 1, 1, generator=g) < spread_share,
                         lo + (hi - lo) * torch.rand(E, 1, 1, 1, generator=g),
                         torch.ones(E, 1, 1, 1))
    coords = (ctr + spread * grid[None] + 0.3 * torch.randn(E, 3, 3, 2, generator=g)).contiguous()
    kk = (torch.arange(E) % (F * M)).to(torch.int32)
    rand_jj = torch.randint(0, F, (E,), generator=g, dtype=torch.int32)
    jj = rand_jj if jj is None else jj.to(torch.int32)
    valid = torch.rand(E, generator=g) > 0.03
    gout = torch.randn(E, 9, 128, generator=g).to(torch.bfloat16)
    return gout, gmap, f1, f2, coords, kk, jj, valid


def _check_corr_bwd(got, want, dtype):
    """The maps torch.equal to the plain version's on the CPU (the map
    kernel sums in its order, with its roundings); d gmap within the patch
    gradients' tolerance: f32 sums in another order (registers against the
    plain version's einsum), then for bf16 features one bf16 rounding."""
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    for name, a, b in zip(("gmap", "fmap1", "fmap2"), got, want):
        a = a.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name != "gmap":
            assert torch.equal(a, b), (name, (a.float() - b.float()).abs().max())
            continue
        a, b = a.float(), b.float()
        tol = ulp * torch.maximum(a.abs(), b.abs()) + 1e-5 * b.abs().max()
        assert ((a - b).abs() <= tol).all(), (a - b).abs().max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_corr_bwd_kernel_matches_plain(dev, dtype):
    """corr_bwd at the training shape (Config()'s 80 patches, 15 frames of
    120x160 and 30x40 maps, C = 128; E = 18000, the last unroll step) against
    corr_backward_plain on the CPU: windows across the borders, spread
    patches, invalid edges, jj unsorted. Two launches a call (the patch
    gradients, the maps)."""
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.ops.corr import corr_backward_plain
    from dpvo_tpu_torch.ops.corr_cuda import corr_backward

    args = _train_corr_case(dtype, 18000)
    want = corr_backward_plain(*args)
    before = kernels.LAUNCHES["corr_bwd"]
    got = corr_backward(*(a.to(dev) for a in args))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["corr_bwd"] == before + 2
    _check_corr_bwd(got, want, dtype)


def test_corr_bwd_repeats_bit_for_bit(dev):
    """Two launches on the same inputs give the same bits, all three
    gradients (no atomics)."""
    from dpvo_tpu_torch.ops.corr_cuda import corr_backward

    args = [a.to(dev) for a in _train_corr_case(torch.bfloat16, 18000, seed=1)]
    first = corr_backward(*args)
    again = corr_backward(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("case", ["empty_slot", "modulo_jj", "spread", "host_orders"])
def test_corr_bwd_maps_equal_plain(dev, case):
    """The maps bit for bit the plain version's: a slot with no edges (its
    maps all zeros), jj = e % F as chip_smoke's case, every patch spread
    4-12 px (windows across many tiles), and the orders shipped from the
    host (int32 stable argsorts) in place of the device's sort."""
    from dpvo_tpu_torch.ops.corr import corr_backward_plain
    from dpvo_tpu_torch.ops.corr_cuda import corr_backward

    E, F, M = 3000, 5, 40
    kw = dict(E=E, F=F, M=M, H=64, W=96, C=128, seed=2)
    if case == "empty_slot":
        kw["jj"] = torch.tensor([0, 1, 3, 4])[torch.arange(E) % 4]
    elif case == "modulo_jj":
        kw["jj"] = torch.arange(E) % F
    elif case == "spread":
        kw.update(spread_share=1.0, spread_px=(4.0, 12.0))
    args = _train_corr_case(torch.bfloat16, **kw)
    want = corr_backward_plain(*args)
    orders = ()
    if case == "host_orders":
        orders = tuple(torch.argsort(a, stable=True).to(torch.int32).to(dev) for a in args[5:7])
    got = corr_backward(*(a.to(dev) for a in args), *orders)
    torch.cuda.synchronize()
    _check_corr_bwd(got, want, torch.bfloat16)
    if case == "empty_slot":
        assert not got[1][2].any() and not got[2][2].any()
        assert got[1][0].any() and got[2][0].any()


def test_corr_bwd_invalid_and_offmap_edges_add_nothing(dev):
    """Edges with valid false, and edges whose windows all lie off both
    maps, give zero patch gradients and add nothing to the maps."""
    from dpvo_tpu_torch.ops.corr_cuda import corr_backward

    gout, gmap, f1, f2, coords, kk, jj, valid = _train_corr_case(torch.bfloat16, 300, F=3, M=20,
                                                                 H=32, W=48, C=64)
    valid = torch.zeros_like(valid)
    got = corr_backward(*(a.to(dev) for a in (gout, gmap, f1, f2, coords, kk, jj, valid)))
    assert all(not t.any() for t in got)
    far = coords + 1000.0
    got = corr_backward(*(a.to(dev) for a in (gout, gmap, f1, f2, far, kk, jj,
                                              torch.ones_like(valid))))
    assert all(not t.any() for t in got)


def test_segsum_backward_on_the_card_matches_the_cpu(dev):
    """The segment-sum op's gradient on the card (the gather, in the payload's
    dtype; zero for dropped ids) equals the CPU's, for BA's f32 payload and
    SoftAgg's bf16 one."""
    from dpvo_tpu_torch.ba.segsum import segment_sum

    g = torch.Generator().manual_seed(0)
    for dtype, E, K, Md in ((torch.float32, 18000, 92, 1200), (torch.bfloat16, 18000, 768, 1200)):
        x = torch.randn(E, K, generator=g).to(dtype)
        kd = torch.randint(0, Md + 10, (E,), generator=g, dtype=torch.int32)
        order = torch.argsort(kd, stable=True).to(torch.int32)
        gy = torch.randn(Md, K, generator=g)
        grads = []
        for d in (torch.device("cpu"), dev):
            xd = x.to(d).requires_grad_()
            y = segment_sum(xd, kd.to(d), order.to(d), Md)
            grads.append((y.detach().cpu(), torch.autograd.grad(y, xd, gy.to(d))[0].cpu()))
        assert torch.equal(grads[0][0], grads[1][0])
        assert torch.equal(grads[0][1], grads[1][1]) and grads[1][1].dtype == dtype


def test_spd_kernel_forward_and_backward_at_the_training_size(dev):
    """n = 6 F = 90, the recipe's 15-frame clip: forward and backward
    against the plain version on the card."""
    from dpvo_tpu_torch.ba.spd_solve import spd_solve, spd_solve_plain

    g = torch.Generator().manual_seed(0)
    n = 90
    A = torch.randn(n, n, generator=g)
    S = (A @ A.T + n * torch.eye(n)).to(dev)
    y = torch.randn(n, generator=g).to(dev)
    w = torch.randn(n, generator=g).to(dev)
    Sg, yg = S.clone().requires_grad_(), y.clone().requires_grad_()
    x = spd_solve(Sg, yg)
    dS, dy = torch.autograd.grad(x, (Sg, yg), w)
    xp = spd_solve_plain(S, y)
    yb = spd_solve_plain(S, w)
    for a, b in ((x, xp), (dy, yb), (dS, -torch.outer(yb, xp))):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One tiny f32 train step's unroll on the card against the CPU from the
    same weights, clip and draws (TF32 off). The loss within 1e-4 relative.
    The unroll's gradient is only piecewise smooth in the weights: on an
    H100 machine (torch 2.11) a weight scaling of 1 + 1e-6 moves the CPU's
    whole gradient by 2.8% (one jump; scripts/train_grad_parity.py finds
    no flip of the least-error pixel, the supervision mask, BA's gate or
    its depth clamp there), and the card lands 2.3e-4 from that scaled
    gradient. So the card is held to the nearest of the CPU's gradients at
    weight scalings 1 and 1 +- 1e-6: the whole gradient within 1e-3 of its
    norm, each leaf within 5e-3 of its own (plus 1e-5 of the whole's, for
    the conv biases before an instance norm, whose gradient is rounding)."""
    import copy

    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.models.vonet import draw_inputs, vo_forward
    from dpvo_tpu_torch.runtime.weights import init_networks
    from dpvo_tpu_torch.train.loss import clip_loss
    from dpvo_tpu_torch.utils.synthetic import PlaneScene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(PATCHES_PER_FRAME=4, DIM=32, FDIM=16, MIXED_PRECISION=False)
    HT, WD, F = 64, 64, 4
    scene = PlaneScene(ht=HT, wd=WD, n_frames=F, depth=4.0, seed=0)
    ys, xs = np.mgrid[0:HT, 0:WD]
    clip = [torch.tensor(np.stack([scene.render(t) for t in range(F)]), dtype=torch.float32),
            torch.tensor(scene.poses, dtype=torch.float32),
            torch.tensor(np.stack([scene.inv_depth(t, xs.astype(np.float64),
                                                   ys.astype(np.float64)) for t in range(F)]),
                         dtype=torch.float32),
            torch.tensor(scene.intrinsics, dtype=torch.float32)]
    draws = draw_inputs(F, 4, HT // 4, WD // 4, 4, torch.Generator().manual_seed(4))
    nets = init_networks(cfg, torch.Generator().manual_seed(0))

    def grads(n, d, scale=1.0):
        n = copy.deepcopy(n).to(d)
        with torch.no_grad():
            for p in n.parameters():
                p.mul_(scale)
        traj = vo_forward(n, cfg, *(t.to(d) for t in clip),
                          {k: v.to(d) for k, v in draws.items()}, STEPS=4)
        loss, _ = clip_loss(traj, clip[1].to(d), 3)
        loss.backward()
        return loss.item(), {k: p.grad.cpu() for k, p in n.named_parameters()
                             if p.grad is not None}

    lc, gc = grads(nets, torch.device("cpu"))
    refs = [gc] + [grads(nets, torch.device("cpu"), 1 + s)[1] for s in (1e-6, -1e-6)]
    lg, gg = grads(nets, dev)
    assert np.isfinite(lg) and abs(lg - lc) <= 1e-4 * abs(lc)
    assert all(set(r) == set(gg) for r in refs)
    flat = lambda g: torch.cat([g[k].reshape(-1) for k in sorted(g)])
    dist = [float((flat(gg) - flat(r)).norm() / flat(r).norm()) for r in refs]
    near = refs[int(np.argmin(dist))]
    assert min(dist) <= 1e-3, dist
    whole = float(flat(near).norm())
    bad = {k: (float((gg[k] - near[k]).norm()), float(near[k].norm())) for k in near
           if (gg[k] - near[k]).norm() > 5e-3 * near[k].norm() + 1e-5 * whole}
    assert not bad, (dist, bad)


def test_segment_sum_op_launches_the_kernel(dev):
    """The op dpvo_tpu_torch::segment_sum on CUDA tensors runs the kernel:
    the kernel wrapper's bits, one launch counted per call, and the plain
    version's bits on the CPU; with requires_grad it still launches it."""
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.ba.segsum import _segment_sum_kernel, segment_sum_plain

    g = torch.Generator().manual_seed(1)
    for dtype, K in ((torch.float32, 98), (torch.bfloat16, 768)):
        x = torch.randn(5000, K, generator=g).to(dtype)
        kd = torch.randint(0, 400, (5000,), generator=g, dtype=torch.int32)
        order = torch.argsort(kd, stable=True).to(torch.int32)
        name = "segsum_bf16" if dtype == torch.bfloat16 else "segsum"
        args = (x.to(dev), kd.to(dev), order.to(dev), 380)
        before = kernels.LAUNCHES[name]
        got = torch.ops.dpvo_tpu_torch.segment_sum(*args)
        via_grad = torch.ops.dpvo_tpu_torch.segment_sum(args[0].clone().requires_grad_(),
                                                        *args[1:])
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 2
        assert torch.equal(got, _segment_sum_kernel(*args))
        assert torch.equal(got.cpu(), segment_sum_plain(x, kd, 380))
        assert torch.equal(via_grad.detach(), got)


@pytest.mark.parametrize("mixed", [False, True])
def test_exported_update_launches_segsum_on_the_card(dev, tmp_path, mixed):
    """update.pt2 exported on the card keeps the segment-sum op: a call
    launches the kernel (three sums: SoftAgg by patch on the small branch,
    by frame pair on the large one), at an edge count other than the traced
    one, and gives the eager module's result (bit for bit in f32; bf16
    within two bf16 ulps of the largest output, since the exported graph
    may pick other kernels for its matmuls)."""
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.deploy.export import (UpdateStep, export_network, load_exported,
                                              update_inputs)
    from dpvo_tpu_torch.runtime.steps import PAIR_MAX
    from dpvo_tpu_torch.runtime.weights import load_networks

    cfg = Config(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, E_MAX=1024, M_OPT_MAX=128, DIM=64,
                 FDIM=32, MIXED_PRECISION=mixed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nets = load_networks(cfg, None, seed=0)
    net = load_exported(export_network(nets, cfg, 48, 64, str(tmp_path), device=dev))
    fdt = torch.bfloat16 if mixed else torch.float32
    eager = UpdateStep(nets.to(dev, fdt).update, cfg.M_OPT_MAX, 2 * PAIR_MAX).eval()
    x = update_inputs(cfg, 300, dev, torch.Generator().manual_seed(2))
    before = kernels.LAUNCHES["segsum"] + kernels.LAUNCHES["segsum_bf16"]
    with torch.no_grad():
        got = net.update(*x)
        want = eager(*x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["segsum"] + kernels.LAUNCHES["segsum_bf16"] - before == 6
    for a, b in zip(got, want):
        if mixed:
            assert (a.float() - b.float()).abs().max() <= 2 ** -6 * b.float().abs().max()
        else:
            assert torch.equal(a, b)


def test_dist_gba_two_gloo_ranks_on_cuda_tensors(dev, tmp_path):
    """Two spawned ranks of a gloo group reduce CUDA tensors on the one card:
    dist_gba on tests/multihost_worker.py's problem (each rank half the rows
    and kpairs) within 5e-4 of the card's and the CPU's single-process gba,
    the two ranks equal."""
    import torch_parallel_worker as worker

    results = worker.spawn(tmp_path, 2, device="cuda")
    p = worker.gba_problem()
    card = [x.cpu() for x in worker.run_gba(p, dev)]
    cpu = worker.run_gba(p, torch.device("cpu"))
    for r in results:
        for a, b, c in zip(r["gba"], card, cpu):
            assert (a - b).abs().max() < 5e-4 and (a - c).abs().max() < 5e-4
    for a, b in zip(results[0]["gba"], results[1]["gba"]):
        assert torch.equal(a, b)


def test_mesh_of_one_nccl_rank_is_single_device(dev, tmp_path):
    """On a world-size-1 NCCL group with a (1, 1) mesh, dist_gba is gba and
    dist_ba_delta is ba_delta, bit for bit on the card (an all_reduce over
    one rank is a copy), launching the segment-sum and SPD kernels."""
    import torch.distributed as dist

    import chip_smoke
    import torch_parallel_worker as worker
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.ba.solver import BAProblem, ba_delta
    from dpvo_tpu_torch.parallel import dist_ba_delta, make_mesh
    from dpvo_tpu_torch.parallel.multihost import init_distributed

    init_distributed(f"file://{tmp_path}/store", 1, 0, backend="nccl")
    try:
        mesh = make_mesh(1, 1)
        assert dist.get_backend() == "nccl"
        p = worker.gba_problem()
        before = kernels.LAUNCHES["segsum"]
        got = worker.run_gba(p, dev, mesh=mesh)
        assert kernels.LAUNCHES["segsum"] > before
        for a, b in zip(got, worker.run_gba(p, dev)):
            assert torch.equal(a, b)
        args, _, n, Md = chip_smoke.gba_problem(torch)
        args = [a.to(dev) for a in args] + [1, n - 1]
        bounds = torch.tensor([-64.0, -64.0, 224.0, 184.0], device=dev)
        want = ba_delta(BAProblem(*args), bounds, 1e-4, W=8, Md=Md)
        before = kernels.LAUNCHES["spd_solve"]
        got = dist_ba_delta(mesh, *args, bounds, 1e-4, W=8, Md=Md)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["spd_solve"] == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def test_span_attributes_a_device_gap_on_the_profilers_clock(dev):
    """A 20 ms host wait inside a span between two kernels, each kernel
    launched and waited for inside a span of its own, profiled with CUDA
    activity alone: the device's idle gap between the kernels is laid on
    the spans (bench_port/program_trace.py, the profile's start from
    trace_start_ns). The wait's span takes the gap's 20 ms within 1 ms,
    all of its own length (no clock offset moves part of it out of the
    gap), and the gap's ends fall in the kernels' spans. The wait spins on
    the host clock: time.sleep(0.02) overshot by ~1.1 ms on the card's
    host."""
    import time

    from bench_port import profile_window, program_trace
    from bench_port.trace_run import trace_start_ns
    from dpvo_tpu_torch.utils import trace

    def wait_20ms():
        end = time.perf_counter() + 0.02
        while time.perf_counter() < end:
            pass

    x = torch.randn(2048, 2048, device=dev)
    (x @ x).sum().item()
    profile_window.start().stop()  # the profiler's first start, as the benchmark's set-up
    prof = profile_window.start()
    trace.enable()
    try:
        with trace.span("kernel_a"):
            y = x @ x
            torch.cuda.synchronize()
        with trace.span("wait"):
            wait_20ms()
        with trace.span("kernel_b"):
            y = y @ x
            torch.cuda.synchronize()
    finally:
        spans, _ = trace.drain()
        trace.disable()
    prof.stop()
    seg = profile_window.summarize(prof)
    seg["trace_start_ns"] = trace_start_ns(prof)
    (sp,) = [s for s in spans if s.name == "wait"]
    length = (sp.t1_ns - sp.t0_ns) * 1e-9
    idle = program_trace.attribute_idle(spans, [seg])
    a, b = max(program_trace.idle_intervals(seg), key=lambda g: g[1] - g[0])
    print(f"gap {(b - a) * 1e-6:.4f} ms from {(sp.t0_ns - a) * 1e-6:.4f} ms before the wait's "
          f"span to {(b - sp.t1_ns) * 1e-6:.4f} ms after it; span {length * 1e3:.4f} ms; idle by "
          f"span (ms) { {k: round(v * 1e3, 4) for k, v in idle.items()} }")
    assert abs(idle["wait"] - 0.02) < 1e-3
    assert abs(idle["wait"] - length) < 1e-3
    assert idle.get(program_trace.OUTSIDE, 0.0) < 1e-3


def test_steady_frame_sync_count_matches_sync_debug_mode(dev):
    """The recorder's sync.* counts of one steady frame of the small
    tracker equal the synchronizing operations that PyTorch's sync debug
    mode warns of in it, with the recorder on and off."""
    import warnings

    import chip_smoke
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.runtime.dpvo import DPVO
    from dpvo_tpu_torch.utils import trace
    from dpvo_tpu_torch.utils.synthetic import PlaneScene

    scene = PlaneScene(ht=96, wd=128, n_frames=16, depth=5.0, seed=9002, tstep=0.3, rstep=0.008)
    slam = DPVO(Config(**chip_smoke.SMALL_CFG), "tests/fixtures/tiny_synth.npz", 96, 128,
                device=dev, seed=0)
    for t in range(12):
        slam(t, scene.render(t), scene.intrinsics.copy())
    assert slam.is_initialized
    syncs = lambda: sum(v for k, v in trace.COUNTS.items() if k.startswith("sync."))
    for t, on in ((12, False), (13, True)):
        if on:
            trace.enable()
        torch.cuda.synchronize()
        before = syncs()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                slam(t, scene.render(t), scene.intrinsics.copy())
            finally:
                torch.cuda.set_sync_debug_mode("default")
                trace.disable()
        warned = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
        print(f"frame {t}, recorder {'on' if on else 'off'}: {warned} syncs warned, "
              f"{syncs() - before} counted")
        assert warned > 0 and syncs() - before == warned
    trace.drain()


def _window_case(seed=0, n=12, N=16, per_frame=40):
    """A sliding-window problem on the CPU for the runtime's window BA: n
    frames of a camera moving forward in a buffer of N, per_frame patches
    anchored in each frame and seen from the frames up to two away; the
    targets the true projections plus 0.5 px of noise, the poses after the
    first perturbed by ~0.02 and the inverse depths by ~20%. Returns the
    state and the edges in a random order."""
    from types import SimpleNamespace

    from dpvo_tpu_torch.geom import projective as pops
    from dpvo_tpu_torch.lie import se3

    g = torch.Generator().manual_seed(seed)
    xi = torch.cat([0.1 * torch.randn(n, 3, generator=g) + torch.tensor([0.0, 0.0, 0.1]),
                    0.02 * torch.randn(n, 3, generator=g)], -1)
    truth = se3.identity((N,))
    for i in range(1, n):
        truth[i] = se3.mul(se3.exp(xi[i]), truth[i - 1])
    K = N * per_frame
    patches = torch.zeros(K, 3, 3, 3)
    patches[:, 0] = (20 + 120 * torch.rand(K, generator=g))[:, None, None]
    patches[:, 1] = (15 + 90 * torch.rand(K, generator=g))[:, None, None]
    patches[:, 2] = (0.3 + 0.5 * torch.rand(K, generator=g))[:, None, None]
    intr = torch.tensor([120.0, 120.0, 80.0, 60.0]).repeat(N, 1)
    kk = torch.cat([torch.arange(f * per_frame, (f + 1) * per_frame)
                    for f in range(n) for j in range(max(0, f - 2), min(n, f + 3))])
    jj = torch.cat([torch.full((per_frame,), j)
                    for f in range(n) for j in range(max(0, f - 2), min(n, f + 3))])
    ii = kk // per_frame
    target = pops.transform(truth, patches, intr, ii, jj, kk)[:, 1, 1]
    target = target + 0.5 * torch.randn(target.shape, generator=g)
    weight = 0.1 + torch.rand(target.shape, generator=g)
    poses = truth.clone()
    poses[1:n] = se3.retr(truth[1:n], 0.02 * torch.randn(n - 1, 6, generator=g))
    dvec = patches[:, 2, 1, 1] * (1 + 0.2 * torch.randn(K, generator=g)).clamp(0.5, 1.5)
    perm = torch.randperm(len(kk), generator=g)
    state = SimpleNamespace(poses=poses, patches=patches, dvec=dvec, intrinsics=intr)
    return state, dict(ii=ii[perm], jj=jj[perm], kk=kk[perm], target=target[perm],
                       weight=weight[perm])


def _window_edges(edges, E: int, Md: int, dev):
    """The first E edges as the runtime's edge tensors (``steps.
    edge_tensors``' dtypes: int64 frames, int32 kernel indices), their dense
    depth variables padded to Md, and their target and weight."""
    kk = edges["kk"][:E]
    uniq, kd = torch.unique(kk, sorted=True, return_inverse=True)
    d2p = torch.full((Md,), 1 << 20)
    d2p[:len(uniq)] = uniq
    kd = kd.int()
    es = dict(ii=edges["ii"][:E], jj=edges["jj"][:E], kd=kd,
              kd_order=torch.argsort(kd, stable=True).int(), valid=torch.ones(E, dtype=bool),
              dense2patch=d2p)
    es = {k: v.to(dev) for k, v in es.items()}
    es["n_depths"] = len(uniq)
    return es, edges["target"][:E].to(dev), edges["weight"][:E].to(dev)


def _strong_depths(es):
    """[n_depths] bool: the depth variables seen from three or more frames
    other than their own. A variable seen less has a near-singular C + lambda
    (lambda = 1e-4), which multiplies rounding in E6^T dX by up to 1e4: the
    eager step has that sensitivity as it is, so such depths are compared
    for finiteness alone."""
    other = (es["ii"] != es["jj"]).long()
    seen = torch.zeros(es["n_depths"], dtype=torch.long, device=other.device)
    return seen.index_add_(0, es["kd"].long(), other) >= 3


def _window_steps(dev, monkeypatch, bucket=512):
    """The runtime's steps for _window_case (E_MAX 4096, M_OPT_MAX 512,
    W_OPT_MAX 8) with a fresh graph cache and buckets of ``bucket`` rows;
    and the case's state on the card."""
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.runtime import ba_graph
    from dpvo_tpu_torch.runtime.steps import StepFunctions

    monkeypatch.setattr(ba_graph, "_caches", {})
    monkeypatch.setattr(ba_graph, "BUCKET", bucket)
    cfg = Config(BUFFER_SIZE=16, E_MAX=4096, M_OPT_MAX=512, W_OPT_MAX=8, P=3)
    state, edges = _window_case()
    for k, v in vars(state).items():
        setattr(state, k, v.to(dev))
    return StepFunctions(cfg, None, dev), state, edges


def _window_gaps(got, want, es):
    """(largest pose difference, largest relative difference of the
    well-observed depth variables); every depth finite."""
    d2p = es["dense2patch"][:es["n_depths"]]
    assert torch.isfinite(got.dvec[d2p]).all() and torch.isfinite(got.poses).all()
    strong = d2p[_strong_depths(es)]
    dd = (got.dvec[strong] - want.dvec[strong]).abs() / want.dvec[strong].abs()
    return (got.poses - want.poses).abs().max().item(), dd.max().item()


def _copy_state(state):
    from types import SimpleNamespace

    return SimpleNamespace(**{k: v.clone() for k, v in vars(state).items()})


def _eager_window_ba(monkeypatch, steps, state, *args):
    from dpvo_tpu_torch.runtime import ba_graph

    with monkeypatch.context() as m:
        m.setattr(ba_graph, "lookup", lambda *a: None)
        steps._window_ba(state, *args)


# (live edges, t0): E within the bucket of 1024 rows (600-1000), across
# two buckets (1100: 1536, 1600: 2048) and back; t0 advancing
WINDOW_RUN = ((600, 1), (700, 1), (1000, 2), (1024, 2), (1100, 3), (1600, 4), (900, 5),
              (1500, 6))


@pytest.mark.parametrize("stream", ["default", "own"])
def test_window_ba_replay_matches_the_eager_step(dev, monkeypatch, stream):
    """``StepFunctions._window_ba`` replaying its CUDA graph against the
    same step run eagerly, from the same state, over a run of rounds whose
    edge count moves inside one bucket and across two and whose window
    advances; the state carried on from the eager result. On the legacy
    default stream the graphs are captured on a side stream, on a stream
    of the caller's own on it. Tolerance: the padded GEMMs' f32 summation
    order (B6 and v6 over 2B rows, not 2E) carried through two solves, on
    the poses and the well-observed depths (``_strong_depths``; on the CPU
    the same comparison reads ~2e-6 there, and up to 3% on the others)."""
    from dpvo_tpu_torch.runtime import ba_graph

    steps, state, edges = _window_steps(dev, monkeypatch)
    ctx = torch.cuda.stream(torch.cuda.Stream(dev)) if stream == "own" else torch.cuda.stream(
        torch.cuda.default_stream(dev))
    worst = [0.0, 0.0]
    with ctx:
        for E, t0 in WINDOW_RUN:
            nfree = min(8, 12 - t0)
            es, target, weight = _window_edges(edges, E, 512, dev)
            got, want = _copy_state(state), _copy_state(state)
            steps._window_ba(got, es, target, weight, t0, nfree)
            _eager_window_ba(monkeypatch, steps, want, es, target, weight, t0, nfree)
            torch.cuda.synchronize()
            assert (want.poses - state.poses).abs().max() > 1e-3   # the BA moved them
            dp, dd = _window_gaps(got, want, es)
            worst = [max(worst[0], dp), max(worst[1], dd)]
            assert dp <= 1e-4 and dd <= 1e-4, (E, t0, dp, dd)
            state = want
    (graphs,) = ba_graph._caches.values()
    assert sorted(graphs.graphs) == [1024, 1536, 2048, 4096]   # E_MAX's captured first
    print(f"replay against eager, {stream} stream: poses {worst[0]:.3g}, "
          f"depths {worst[1]:.3g} (relative)")


def test_window_ba_counters_and_launch_counts(dev, monkeypatch):
    """A capture per bucket, E_MAX's first, and a replay per call; each
    replay counts the segment sums and SPD solves of its BA_ITERS = 2
    iterations, and the cache's one eager run before its first capture
    counts its own."""
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.utils import trace

    steps, state, edges = _window_steps(dev, monkeypatch)
    before = dict(trace.COUNTS)
    for E, t0 in WINDOW_RUN:
        steps._window_ba(state, *_window_edges(edges, E, 512, dev), t0, min(8, 12 - t0))
    torch.cuda.synchronize()
    delta = {k: v - before.get(k, 0) for k, v in trace.COUNTS.items()
             if v != before.get(k, 0)}
    n = len(WINDOW_RUN)
    assert delta == {"window_ba.replay": n, "window_ba.capture": 4,
                     "launch.segsum": 2 * n + 2, "launch.spd_solve": 2 * n + 2}
    assert kernels.LAUNCHES["segsum"] == trace.COUNTS["launch.segsum"]


def test_window_ba_replays_allocate_nothing(dev, monkeypatch):
    """torch.cuda.memory_allocated stays flat over 100 replays."""
    steps, state, edges = _window_steps(dev, monkeypatch)
    args = _window_edges(edges, 1100, 512, dev)
    steps._window_ba(state, *args, 2, 8)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated(dev)
    for _ in range(100):
        steps._window_ba(state, *args, 2, 8)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == m0
    assert torch.isfinite(state.poses).all()


def test_window_ba_replay_after_segsum_workspace_growth(dev, monkeypatch):
    """An eager segment sum on the graphs' stream that grows the kernel's
    workspace, then tensors of the old workspace's sizes filled with 7s
    (which would take its memory, were anything still to read it): the next
    replay, whose padded rows make a run of more than CHUNK rows that goes
    through the workspace, still matches the eager step."""
    from dpvo_tpu_torch.ba import segsum

    steps, state, edges = _window_steps(dev, monkeypatch)
    stream = torch.cuda.Stream(dev)
    with torch.cuda.stream(stream):
        es, target, weight = _window_edges(edges, 1100, 512, dev)  # 436 padded rows
        steps._window_ba(_copy_state(state), es, target, weight, 2, 8)
        key = (dev.index or 0, stream.cuda_stream)
        old = segsum._workspaces[key]
        E2, K2 = 300_000, 64
        kd = torch.randint(0, 1000, (E2,), device=dev, dtype=torch.int32)
        segsum.segment_sum(torch.ones(E2, K2, device=dev), kd,
                           torch.argsort(kd, stable=True).int(), 1000)
        new = segsum._workspaces[key]
        assert all(a.data_ptr() != b.data_ptr() for a, b in zip(old, new))
        junk = [torch.full_like(t, 7) for t in old]
        del old
        got, want = _copy_state(state), _copy_state(state)
        steps._window_ba(got, es, target, weight, 2, 8)
        _eager_window_ba(monkeypatch, steps, want, es, target, weight, 2, 8)
        torch.cuda.synchronize()
    del junk
    assert max(_window_gaps(got, want, es)) <= 1e-4


def test_window_ba_one_cache_serves_successive_streams(dev, monkeypatch):
    """Trackers on new streams one after another (the benchmark's
    calibration makes a stream a seed) share the first stream's cache: one
    cache on the first stream, no capture after the first stream's, each
    stream's replay matching the eager step, and no memory held after a
    call (the handoff buffer goes back to its pool)."""
    from dpvo_tpu_torch.runtime import ba_graph
    from dpvo_tpu_torch.utils import trace

    steps, state, edges = _window_steps(dev, monkeypatch)
    es, target, weight = _window_edges(edges, 1100, 512, dev)
    first = torch.cuda.Stream(dev)
    with torch.cuda.stream(first):
        want = _copy_state(state)
        steps._window_ba(_copy_state(state), es, target, weight, 2, 8)
        _eager_window_ba(monkeypatch, steps, want, es, target, weight, 2, 8)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated(dev)
    captures = trace.COUNTS.get("window_ba.capture", 0)
    for _ in range(3):
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            got = _copy_state(state)
            steps._window_ba(got, es, target, weight, 2, 8)
        torch.cuda.synchronize()
        assert max(_window_gaps(got, want, es)) <= 1e-4
        del got
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(dev) == m0
    (graphs,) = ba_graph._caches.values()
    assert trace.COUNTS.get("window_ba.capture", 0) == captures and len(graphs.graphs) == 2
    assert graphs.stream == first
