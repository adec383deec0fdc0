"""The whole step's share of the card's bf16 peak: the model FLOP of the
window (both encoders a patchified frame, the update operator's products
a round at its live edges and groups, the correlation's dots), times
``passes`` (a training step's forward and its backward of twice that
work, 3; a tracker's frame, 1; recomputation not counted), over the
window's seconds and 989 TFLOP/s."""

from bench_port.roofline import PEAK_BF16, corr_flops, patchify_flops, update_flops


def read(ctx):
    cfg = ctx["config"]
    if not ctx["edge_rounds"] and not ctx["patchifies"]:
        return None
    width = cfg["P"] ** 2 * cfg["CORR_LEVELS"] * (2 * cfg["CORR_RADIUS"] + 2) ** 2
    flops = ctx["patchifies"] * patchify_flops(ctx["ht"], ctx["wd"], cfg["FDIM"], cfg["DIM"])
    for E, groups in ctx["edge_rounds"]:
        flops += update_flops(E, groups, cfg["DIM"], width) + corr_flops(E, cfg["FDIM"])
    return 100.0 * flops * ctx.get("passes", 1) / ctx["window_s"] / PEAK_BF16
