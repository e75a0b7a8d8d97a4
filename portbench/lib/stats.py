"""Statistics of a run: rates over a window and percentiles."""

import math


def rate(n_done, seconds):
    """Work per second over all the work and all the time of a window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return n_done / seconds


def percentile(values, q):
    """The q-th percentile (0 < q < 100) by linear interpolation between the
    closest ranks, as numpy's default."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
