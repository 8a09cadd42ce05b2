"""The benchmark's arithmetic: tails, window means, interval unions and the
idle gaps between device activity.  Plain Python and NumPy, no device."""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

Interval = Tuple[float, float]


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0-100) of ``values``, linear between ranks;
    None for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def window_mean(walls: Sequence[float]) -> Optional[float]:
    """Summed wall of every session over their count; None for none."""
    return float(sum(walls) / len(walls)) if walls else None


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, merged [start, end) intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals: Iterable[Interval], lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def gaps(intervals: Iterable[Interval], lo: float,
         hi: float) -> List[Interval]:
    """The idle stretches of [lo, hi) between the merged intervals."""
    out, t = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def open_at(t: float, spans: Sequence[Tuple[str, float, float, int]],
            default: str = "idle") -> str:
    """The deepest host span (name, start, end, depth) open at time t."""
    best, depth = default, -1
    for name, s, e, d in spans:
        if s <= t < e and d > depth:
            best, depth = name, d
    return best


def idle_pieces(intervals, lo, hi, spans):
    """Every idle gap of [lo, hi), cut where the host span open changes:
    [(name of the deepest span open, seconds)]."""
    pieces = []
    for s, e in gaps(intervals, lo, hi):
        cuts = sorted({s, e} | {t for _n, a, b, _d in spans for t in (a, b)
                                if s < t < e})
        name, start = None, s
        for a, b in zip(cuts, cuts[1:]):
            here = open_at((a + b) / 2, spans)
            if here != name:
                if name is not None:
                    pieces.append((name, a - start))
                name, start = here, a
        pieces.append((name, e - start))
    return pieces


def top_gaps(intervals, lo, hi, spans, k: int = 10):
    """The k longest idle stretches, each named by the host span open in
    it, as [name, seconds]."""
    pieces = sorted(idle_pieces(intervals, lo, hi, spans),
                    key=lambda p: -p[1])[:k]
    return [[n, t] for n, t in pieces]


def top_ops(events, k: int = 10):
    """The k device operations (name, start, end) that took most time in
    all, as [name, seconds]."""
    total = {}
    for name, s, e in events:
        total[name] = total.get(name, 0.0) + (e - s)
    return [[n, t] for n, t in sorted(total.items(), key=lambda x: -x[1])[:k]]


def span_seconds(spans, name: str) -> float:
    """Seconds in spans called ``name`` (name, start, end, depth), a span
    nested in another of the same name counted once."""
    own = union((s, e) for n, s, e, _d in spans if n == name)
    return sum(e - s for s, e in own)
