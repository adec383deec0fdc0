"""The yardstick's arithmetic: the card's published peaks, the roofline
bound, and the work of each kernel and of the model counted from shapes.

``PEAK_*`` and ``bound`` are copies of ``chip_smoke.py:173-175`` and
``:345``; ``corr_cost`` of the corr row's count (``chip_smoke.py:
410-412``), ``segsum_cost`` of the segment-sum rows' (``:525-532``) and
``corr_bwd_cost`` of the correlation backward's row (``:619-626``),
each at the live edge count (the port pads nothing on the tracker's
path, so the capacity E_cap there is E). The model's FLOP counts are the
products of both encoders at the frame size, of the update operator per
live edge, and of the correlation's dots.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12         # HBM3 bytes/s, one H100 SXM (NVIDIA data sheet)
PEAK_F32 = 67e12             # f32 FLOP/s outside the tensor cores
PEAK_BF16 = 989e12           # bf16 tensor-core FLOP/s, dense


def bound(nbytes: float, flops: float, peak_flops: float):
    """(least ms, "bytes" or "operations") of work at the card's peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def corr_cost(E: int, nframes: int, nrows: int, H1: int, W1: int, C: int):
    """(bytes, FLOP) of one exact correlation (``csrc/corr.cu``) of E
    edges: the feature maps of the nframes frames and the nrows patch rows
    the edges touch read once (bf16, both levels, the second at 1/4 size
    each way), the coordinates (f32) and int32 ii1/jj1 and bool valid read,
    the bf16 output [E, 9, 2 * 64] written; 2 FLOP a multiply-add of the
    9 pixels' 64-position windows at both levels."""
    H2, W2 = H1 // 4, W1 // 4
    nbytes = (nframes * (H1 * W1 + H2 * W2) * C * 2 + nrows * C * 9 * 2 + E * 9 * 2 * 4
              + E * (4 + 4 + 1) + E * 9 * 128 * 2)
    return nbytes, corr_flops(E, C)


def corr_flops(E: int, C: int) -> float:
    return E * 2 * 9 * 64 * C * 2


def corr_bwd_cost(E: int, Np: int, mem: int, H1: int, W1: int, H2: int, W2: int, C: int,
                  valid: int, elsize: int = 2):
    """(bytes, FLOP) of one correlation backward (``csrc/corr_bwd.cu``,
    both kernels, and the patch gradients' sum into the gmap rows) of E
    edges over Np patch rows [C, 3, 3] and mem frames of maps (H1 x W1, H2
    x W2, C): the incoming gradient [E, 9, 2 * 64] (bf16), the features
    (gmap and both maps, ``elsize`` bytes) and the f32 coordinates [E, 9,
    2] read once with the int32 ii1/jj1 and bool valid, the three
    gradients written once in the features' dtype; 2 FLOP a multiply-add
    of the ``valid`` edges' 9 pixels x 64 window positions x C, at both
    levels, twice (the patch and the map gradients)."""
    feats = Np * C * 9 + mem * (H1 * W1 + H2 * W2) * C
    nbytes = E * 9 * 128 * 2 + feats * elsize + E * 9 * 2 * 4 + E * 9 + feats * elsize
    return nbytes, valid * 2 * 9 * 64 * C * 2 * 2


def segsum_cost(E: int, K: int, Md: int, elsize: int):
    """(bytes, FLOP) of one segment sum (``csrc/segsum.cu``) of E rows of
    K values of elsize bytes into Md f32 rows, every row's id in range (the
    tracker's live edges): the int32 ids and order read, the payload read,
    the output written; one add a value read."""
    return E * 8 + Md * K * 4 + E * K * elsize, E * K


def encoder_flops(ht: int, wd: int, out_dim: int, stem: int = 32) -> float:
    """FLOP of one BasicEncoder4 (``models/extractor.py``) on an ht x wd
    frame: the 7x7 stride-2 stem, two residual blocks at 1/2 resolution,
    one stride-2 block with its 1x1 shortcut and one at 1/4, the 1x1 head."""
    a2 = (ht // 2) * (wd // 2)
    a4 = (ht // 4) * (wd // 4)
    c1, c2 = stem, 2 * stem
    macs = (c1 * 3 * 49 * a2 + 2 * 2 * c1 * c1 * 9 * a2
            + (c2 * c1 * 9 + c2 * c2 * 9 + c2 * c1) * a4 + 2 * c2 * c2 * 9 * a4
            + out_dim * c2 * a4)
    return 2.0 * macs


def patchify_flops(ht: int, wd: int, fdim: int, dim: int) -> float:
    """Both encoders of the patchify on one frame."""
    return encoder_flops(ht, wd, fdim) + encoder_flops(ht, wd, dim)


def update_flops(E: int, segments: int, dim: int, corr_width: int) -> float:
    """Matrix products of one update-operator round (``models/update.py``)
    on E live edges: the correlation encoder (corr_width -> dim, then two
    dim x dim), the two neighbour MLPs, both SoftAggs' two per-edge layers,
    two gated residuals (three layers each) and the two heads per edge;
    the SoftAggs' output layer once per live group (segments)."""
    per_edge = corr_width * dim + 16 * dim * dim + 2 * 2 * dim
    return 2.0 * (E * per_edge + segments * dim * dim)
