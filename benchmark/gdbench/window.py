"""The measured window's arithmetic, kept apart from the device so that the
CPU tests hold it."""

from __future__ import annotations

import math


def rate(work: float, seconds: float) -> float:
    """Work completed per second of the window."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return work / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of ``values``, linearly interpolated
    between the order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def intervals(stamps_ms) -> list:
    """Intervals between consecutive time stamps: the first stamp is the
    window's start, each later one a step's end."""
    return [b - a for a, b in zip(stamps_ms, stamps_ms[1:])]
