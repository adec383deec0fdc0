"""The correlation backward's (``csrc/corr_bwd.cu``) share of its
roofline in the profiled training step: the least time of every call
there (``roofline.corr_bwd_cost``, the count of ``chip_smoke.py``'s row
8, bytes-bound), over the device time of both of its kernels."""

from bench_port.profile_window import device_time_s
from bench_port.roofline import PEAK_BF16, bound, corr_bwd_cost

KERNELS = ("corr_bwd_f1_kernel", "corr_bwd_map_kernel")


def read(ctx):
    prof, calls = ctx.get("profile"), ctx.get("corr_bwd_calls")
    t = device_time_s(prof, KERNELS) if prof else 0.0
    if not calls or t <= 0:
        return None
    least_ms = sum(bound(*corr_bwd_cost(*c), PEAK_BF16)[0] for c in calls)
    return 100.0 * least_ms * 1e-3 / t
