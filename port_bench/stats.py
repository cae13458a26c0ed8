"""The benchmark's arithmetic: medians, rates and interval unions."""

from typing import Iterable, List, Sequence, Tuple


def median(values: Sequence[float]) -> float:
    s = sorted(values)
    n = len(s)
    if not n:
        raise ValueError("median of no values")
    return float(s[n // 2]) if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def rate(amount: float, seconds: float) -> float:
    """``amount`` done over the whole window of ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return amount / seconds


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint, sorted intervals that cover the same points as
    ``intervals`` (overlaps merged: an operation on one stream overlapping
    one on another counts once)."""
    merged: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(a, b) for a, b in merged]


def clip(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def covered(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length covered by the union of ``intervals``."""
    return sum(b - a for a, b in union(intervals))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out
