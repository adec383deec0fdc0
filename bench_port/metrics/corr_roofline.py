"""The correlation kernel's (``csrc/corr.cu``) share of its roofline in
the profiled seconds: the least time of every call there (``roofline.
corr_cost`` at its live edges), over the kernel's device time."""

from bench_port.profile_window import device_time_s
from bench_port.roofline import PEAK_BF16, bound, corr_cost

KERNELS = ("corr_tile_kernel", "corr_pixel_kernel")


def read(ctx):
    prof, calls = ctx["profile"], ctx["corr_calls"]
    t = device_time_s(prof, KERNELS) if prof else 0.0
    if not calls or t <= 0:
        return None
    least_ms = sum(bound(*corr_cost(*c), PEAK_BF16)[0] for c in calls)
    return 100.0 * least_ms * 1e-3 / t
