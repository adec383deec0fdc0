"""What every runner of the benchmark shares (``runners/<name>.py``): the
card a cell runs on, the probes that record the shapes of the port's
kernel calls while the device is profiled, and the profile's start on the
host's clock."""

from __future__ import annotations

import contextlib
import subprocess

FORBIDDEN = {"jax", "jaxlib", "flax", "dpvo_tpu"}


class NoCard(RuntimeError):
    pass


class Probe:
    """While ``profiling`` is set, the shapes of the kernels' calls are
    recorded."""

    def __init__(self):
        self.profiling = False
        self.corr = []      # (E, nframes, nrows, H1, W1, C) a correlation (the stream's);
        #                     (E, jj1, ii1, H1, W1, C) at corr_cuda.corr_features
        self.segsum = []    # (E, K, Md, element size) a segment sum
        self.corr_bwd = []  # (E, Np, mem, H1, W1, H2, W2, C, valid) a correlation backward

    def add(self, name, item):
        if self.profiling:
            getattr(self, name).append(item)


def card(cell: dict, device=None):
    """The run's device: ``device`` where given (the tests' CPU), else the
    first card, raising ``NoCard`` without one or with fewer cards than the
    cell asks for."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device is available")
    if torch.cuda.device_count() < cell["chips"]:
        raise NoCard(f"the cell asks for {cell['chips']} cards, "
                     f"{torch.cuda.device_count()} available")
    return torch.device("cuda:0")


@contextlib.contextmanager
def probed(probe: Probe, kernels=("segsum",)):
    """Within the block, the port's calls of the named kernels record their
    shapes in ``probe`` (while it profiles): ``segsum`` at
    ``ba/segsum._segment_sum_kernel`` (every card call of the segment sum,
    the op's included), ``corr`` at ``ops/corr_cuda.corr_features`` (the
    training correlation's forward: its index tensors, which
    ``corr_shapes`` reads once the profile is over, so that the probe
    waits for nothing), ``corr_bwd`` at ``ops/corr_cuda.corr_backward``
    (the training correlation's backward, both of its kernels)."""
    undo = []
    if "segsum" in kernels:
        from dpvo_tpu_torch.ba import segsum as mod

        real_segsum = mod._segment_sum_kernel

        def counted_segsum(payload, kd, order, Md):
            probe.add("segsum", (int(payload.shape[0]), int(payload.shape[1]), int(Md),
                                 payload.element_size()))
            return real_segsum(payload, kd, order, Md)

        mod._segment_sum_kernel = counted_segsum
        undo.append((mod, "_segment_sum_kernel", real_segsum))
    if "corr" in kernels:
        from dpvo_tpu_torch.ops import corr_cuda as mod

        real_corr = mod.corr_features

        def counted_corr(gmap, fmap1, fmap2, coords, ii1, jj1, *rest, **kw):
            _, H1, W1, C = fmap1.shape
            probe.add("corr", (int(coords.shape[0]), jj1, ii1, int(H1), int(W1), int(C)))
            return real_corr(gmap, fmap1, fmap2, coords, ii1, jj1, *rest, **kw)

        mod.corr_features = counted_corr
        undo.append((mod, "corr_features", real_corr))
    if "corr_bwd" in kernels:
        from dpvo_tpu_torch.ops import corr_cuda as mod

        real_bwd = mod.corr_backward

        def counted_bwd(g, gmap, fmap1, fmap2, coords, ii1, jj1, valid, *rest, **kw):
            _, H1, W1, C = fmap1.shape
            probe.add("corr_bwd", (int(coords.shape[0]), int(gmap.shape[0]), int(fmap1.shape[0]),
                                   int(H1), int(W1), int(fmap2.shape[1]), int(fmap2.shape[2]),
                                   int(C), valid))
            return real_bwd(g, gmap, fmap1, fmap2, coords, ii1, jj1, valid, *rest, **kw)

        mod.corr_backward = counted_bwd
        undo.append((mod, "corr_backward", real_bwd))
    try:
        yield probe
    finally:
        for mod, name, real in undo:
            setattr(mod, name, real)


def corr_shapes(calls) -> list:
    """The ``corr`` probe's calls as ``roofline.corr_cost`` takes them:
    (E, frames read, patch rows read, H1, W1, C)."""
    import torch

    return [(E, int(torch.unique(jj1).numel()), int(torch.unique(ii1).numel()), H1, W1, C)
            for E, jj1, ii1, H1, W1, C in calls]


def trace_start_ns(prof) -> int:
    """A stopped profile's start on the host's clock (``time.time_ns()``)."""
    res = prof.profiler.kineto_results
    if hasattr(res, "trace_start_ns"):
        return int(res.trace_start_ns())
    return int(res.trace_start_us()) * 1000


def smi_utilization() -> str:
    """``nvidia-smi``'s utilization.gpu now (a cross-check of the device's
    idle share; the tool samples over its own period)."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=utilization.gpu",
                               "--format=csv,noheader,nounits"], capture_output=True,
                              text=True, timeout=10).stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"
