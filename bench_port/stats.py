"""Order statistics of the benchmark's samples."""

from __future__ import annotations

import statistics

import numpy as np


def sub_seed(seed: int, *keys: int) -> np.random.SeedSequence:
    """The seed sequence of (seed, keys...), for any whole seed."""
    return np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *keys])


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) by linear interpolation between
    order statistics (numpy's default; ``statistics.quantiles``'
    inclusive method at n = 100)."""
    vals = sorted(float(v) for v in values)
    if not vals:
        raise ValueError("no samples")
    if len(vals) == 1:
        return vals[0]
    pos = (len(vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def spread(values) -> float:
    """Inter-quartile distance over the median (``statistics.quantiles``
    with n = 4, its default exclusive method)."""
    q1, q2, q3 = statistics.quantiles([float(v) for v in values], n=4)
    return (q3 - q1) / q2
