"""The segment-sum kernel's (``csrc/segsum.cu``) share of its roofline in
the profiled seconds: the least time of every call there (``roofline.
segsum_cost``), over the kernel's device time. Its calls are the window
BA's and SoftAgg's, and in a loop-closure cell the global BA's too."""

from bench_port.profile_window import device_time_s
from bench_port.roofline import PEAK_F32, bound, segsum_cost

KERNELS = ("segsum_kernel",)


def read(ctx):
    prof, calls = ctx["profile"], ctx["segsum_calls"]
    t = device_time_s(prof, KERNELS) if prof else 0.0
    if not calls or t <= 0:
        return None
    least_ms = sum(bound(*segsum_cost(*c), PEAK_F32)[0] for c in calls)
    return 100.0 * least_ms * 1e-3 / t
