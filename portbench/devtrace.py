"""A device trace of the measured window: ``torch.profiler`` with CUDA
activity only (no CPU activity, which slows the host path several times),
reduced to device operations on the host clock.

A marker kernel (``torch.cuda._sleep``, named ``spin_kernel``) is
launched at a known host time right after the profiler starts, and every
device event is shifted by the marker's offset; the host launch latency,
some microseconds, is the error.  Without the marker the events keep the
profiler's own clock and cannot be matched to host spans.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .stats import union

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"
MARKER_CYCLES = 1000


@dataclass
class DeviceTrace:
    events: List[Tuple[str, float, float]] = field(default_factory=list)
    aligned: bool = False   # events on the host's perf_counter clock


def busy_seconds(trace: DeviceTrace) -> float:
    """Seconds in which some operation ran on the device: the union of
    every traced operation (the profiler covers the window alone)."""
    return sum(e - s for s, e in union((s, e) for _n, s, e in trace.events))


def read_chrome_trace(doc: dict) -> List[Tuple[str, float, float]]:
    """(name, start, end) in seconds of the profiler's clock for every
    device operation of a Chrome trace document."""
    out = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES:
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            out.append((ev.get("name", "?"), ts * 1e-6, (ts + dur) * 1e-6))
    return out


def align(events, mark_host: Optional[float]) -> DeviceTrace:
    """Shift ``events`` so that the first marker starts at ``mark_host``;
    the marker itself is dropped."""
    marks = [s for name, s, _e in events if MARKER in name]
    rest = [ev for ev in events if MARKER not in ev[0]]
    if not marks or mark_host is None:
        return DeviceTrace(rest, aligned=False)
    shift = mark_host - min(marks)
    return DeviceTrace([(n, s + shift, e + shift) for n, s, e in rest],
                       aligned=True)


class Capture:
    """Context manager: profiles the device while it is open; ``trace``
    holds the result once it has closed."""

    def __init__(self):
        self.trace: Optional[DeviceTrace] = None
        self._prof = None
        self._mark = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._mark = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        return self

    def __exit__(self, exc_type, exc, tb):
        import torch
        torch.cuda.synchronize()
        self._prof.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.unlink(path)
        self.trace = align(read_chrome_trace(doc), self._mark)
        return False
