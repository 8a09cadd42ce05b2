"""What a measured window leaves behind for the metric readers: every
session with its sizes and host spans, every submitted pod's latency, the
harness's own phases and, in a traced run, the device's operations.  All
times are seconds on the host's ``time.perf_counter`` clock."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .devtrace import DeviceTrace

# (name, start, end, depth)
Span = Tuple[str, float, float, int]


@dataclass
class Session:
    due: float              # the wave's due time: its ingest begins
    ingest_s: float         # the informer's handler calls for the wave
    start: float            # run_once() called
    end: float              # run_once() returned
    nodes: int
    pods: int
    jobs: int
    queues: int
    placements: int         # binds this session made
    spans: List[Span] = field(default_factory=list)

    @property
    def wall_s(self) -> float:
        return self.end - self.start


@dataclass
class Window:
    start: float
    end: float
    sessions: List[Session]
    latencies: List[float]  # bind - due, every pod submitted in the window
    attempted: int
    failed: int
    phases: List[Span] = field(default_factory=list)
    gc_s: float = 0.0       # the collector's passes in the window
    device: Optional[DeviceTrace] = None
    device_name: str = ""
    checked: List[int] = field(default_factory=list)  # waves judged
    check_s: float = 0.0    # the reference's time, after the window

    def host_spans(self) -> List[Span]:
        """The harness's phases and every session's spans, the sessions'
        one level deeper."""
        out = list(self.phases)
        for s in self.sessions:
            out.extend((n, a, b, d + 1) for n, a, b, d in s.spans)
        return out
