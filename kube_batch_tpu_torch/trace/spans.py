"""Session flight recorder: per-phase span tracing (L5 observability).

The aggregate Prometheus histograms (metrics/metrics.py) answer "what is
the p95" but not "which phase stalled in THIS cycle".  This module gives
every scheduling session a monotonic session id and a thread-local span
stack: the scheduler loop, the actions, the solver dispatch/fetch split,
and the shipping layer record nested spans (tensorize / ship / dispatch /
host-overlap / device-wait / apply / per-plugin / per-action) whose
completed traces land in the lock-guarded flight recorder
(trace/recorder.py) for after-the-fact diagnosis and Chrome trace-event
export (trace/export.py, loadable in Perfetto).

Overhead discipline: spans cost one ``perf_counter`` pair and a list
append on the session thread — no locks, no allocation beyond the record
itself.  The recorder's mutex is touched exactly once per session, at
``end_session``.  The ``KUBE_BATCH_TPU_TRACE=0`` kill switch makes the
whole module a no-op: ``begin_session`` returns None without creating
state, ``span()`` returns a shared do-nothing context manager, and the
hot path acquires zero additional locks (pinned by tests/test_trace.py).
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Dict, List, Optional

from .. import knobs

# =0 disables tracing entirely (checked once per session, not per span).
TRACE_ENV = knobs.TRACE.env

# Why-pending state is bounded per session: a pathological cluster with
# hundreds of thousands of stuck jobs must not grow a trace without
# bound (the recorder keeps _RING of these per process).
_MAX_VERDICTS = 10_000

_session_ids = itertools.count(1)  # itertools.count is atomic in CPython
_tls = threading.local()


def enabled() -> bool:
    return knobs.TRACE.enabled()


class SpanRecord:
    """One completed span.  ``ts``/``dur`` are microseconds relative to
    the session start; ``track`` is the root phase the span nests under
    (its own name for depth-0 spans) — the Chrome-export track."""

    __slots__ = ("name", "ts", "dur", "track", "depth", "args")

    def __init__(self, name, ts, dur, track, depth, args):
        self.name = name
        self.ts = ts
        self.dur = dur
        self.track = track
        self.depth = depth
        self.args = args


class SessionTrace:
    """Everything recorded about one scheduling session.  Mutated only by
    the owning session thread between begin_session/end_session; immutable
    once handed to the flight recorder."""

    __slots__ = ("sid", "uid", "start_time", "t0", "duration_ms", "spans",
                 "counters", "verdicts", "tallies", "meta", "_stack")

    def __init__(self, sid: int, meta: dict):
        self.sid = sid
        self.uid = ""                    # session UUID, set via set_meta
        self.start_time = time.time()
        self.t0 = time.perf_counter()
        self.duration_ms: float = 0.0
        self.spans: List[SpanRecord] = []
        self.counters: List[tuple] = []  # (name, ts_us, value)
        # job name -> {"reason", "message"}: the unschedulable verdicts
        # the session itself computed (job_valid gate, gang close).
        self.verdicts: Dict[str, dict] = {}
        # job name -> solver-mask rejection tally (tpu_allocate).
        self.tallies: Dict[str, dict] = {}
        self.meta: dict = meta
        self._stack: List["_SpanCtx"] = []

    def now_us(self) -> float:
        return (time.perf_counter() - self.t0) * 1e6


class _SpanCtx:
    """Open span handle; appends its SpanRecord on exit.  Args set via
    ``annotate()`` while open are captured; the record's args dict stays
    the same object, so late annotation before export still lands."""

    __slots__ = ("_trace", "name", "args", "_start", "_track", "_depth")

    def __init__(self, trace: SessionTrace, name: str, args: Optional[dict]):
        self._trace = trace
        self.name = name
        self.args = args

    def __enter__(self):
        tr = self._trace
        stack = tr._stack
        self._depth = len(stack)
        self._track = stack[0].name if stack else self.name
        stack.append(self)
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter()
        tr = self._trace
        if tr._stack and tr._stack[-1] is self:
            tr._stack.pop()
        elif self in tr._stack:       # mismatched exit: drop deeper frames
            del tr._stack[tr._stack.index(self):]
        ts = (self._start - tr.t0) * 1e6
        tr.spans.append(SpanRecord(self.name, ts, (end - self._start) * 1e6,
                                   self._track, self._depth,
                                   self.args or {}))
        return False

    def annotate(self, **kv) -> None:
        if self.args is None:
            self.args = kv
        else:
            self.args.update(kv)


class _NoopSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def annotate(self, **kv) -> None:
        pass


_NOOP = _NoopSpan()


# ----------------------------------------------------------------------
# session lifecycle

def begin_session(**meta) -> Optional[int]:
    """Start tracing a session on this thread; returns the monotonic
    session id, or None when tracing is disabled (the kill switch) or a
    session is already active (nested opens trace into the outer one)."""
    if not enabled():
        _tls.trace = None
        _tls.nested = 0
        return None
    if getattr(_tls, "trace", None) is not None:
        # Balanced nesting: the matching end_session must not finalize
        # the outer session.
        _tls.nested = getattr(_tls, "nested", 0) + 1
        return None
    tr = SessionTrace(next(_session_ids), meta)
    _tls.trace = tr
    _tls.nested = 0
    return tr.sid


def end_session() -> None:
    """Finalize this thread's session trace and hand it to the flight
    recorder (the single per-session lock acquisition)."""
    tr = getattr(_tls, "trace", None)
    if tr is None:
        return
    if getattr(_tls, "nested", 0) > 0:
        _tls.nested -= 1
        return
    _tls.trace = None
    tr.duration_ms = (time.perf_counter() - tr.t0) * 1e3
    tr._stack = []
    from .recorder import recorder
    recorder.record(tr)


def suspend_session() -> Optional[SessionTrace]:
    """Detach this thread's active session trace WITHOUT finalizing it
    (the shard pipeline interleaves several sessions' begin/retire halves
    on one loop thread — doc/TENANCY.md "Concurrent micro-sessions").
    The caller re-installs it with resume_session before recording the
    session's remaining spans; ``end_session`` still runs exactly once
    per session.  Returns None when no session is active (kill switch or
    plain sequential flow), and resume_session(None) is then a no-op —
    the pair is safe to call unconditionally."""
    tr = getattr(_tls, "trace", None)
    _tls.trace = None
    return tr


def resume_session(tr: Optional[SessionTrace]) -> None:
    """Re-install a suspended session trace on this thread.  Installing
    over an active trace would silently drop it, so that is a bug loud
    enough to raise on (the pipeline always suspends before switching)."""
    if tr is None:
        return
    if getattr(_tls, "trace", None) is not None:
        raise RuntimeError(
            "resume_session over an active session trace: suspend the "
            "current session first")
    _tls.trace = tr


def current_trace() -> Optional[SessionTrace]:
    return getattr(_tls, "trace", None)


def current_session_id() -> Optional[int]:
    tr = getattr(_tls, "trace", None)
    return None if tr is None else tr.sid


# ----------------------------------------------------------------------
# recording API (all no-ops without an active session)

def span(name: str, **args):
    """Context manager recording a nested span; the no-op singleton when
    tracing is off or no session is active (zero locks, zero state)."""
    tr = getattr(_tls, "trace", None)
    if tr is None:
        return _NOOP
    return _SpanCtx(tr, name, args or None)


def annotate(**kv) -> None:
    """Attach key/values to the innermost open span (e.g. the shipping
    layer tagging the action's ``ship`` span with mode and bytes)."""
    tr = getattr(_tls, "trace", None)
    if tr is not None and tr._stack:
        tr._stack[-1].annotate(**kv)


def instant(name: str, **args) -> None:
    """Zero-duration marker event."""
    tr = getattr(_tls, "trace", None)
    if tr is not None:
        ts = tr.now_us()
        track = tr._stack[0].name if tr._stack else name
        tr.spans.append(SpanRecord(name, ts, 0.0, track,
                                   len(tr._stack), args))


def counter(name: str, value) -> None:
    """Counter sample (Chrome export emits these as ``ph: "C"`` events —
    e.g. bytes shipped per session)."""
    tr = getattr(_tls, "trace", None)
    if tr is not None:
        tr.counters.append((name, tr.now_us(), value))


def note_ship(mode: str, nbytes: int) -> None:
    """Shipping-layer hook: tag the enclosing span and emit the byte
    counter in one call (models/shipping.py calls this beside
    metrics.note_ship)."""
    tr = getattr(_tls, "trace", None)
    if tr is None:
        return
    if tr._stack:
        tr._stack[-1].annotate(ship_mode=mode, ship_bytes=int(nbytes))
    tr.counters.append(("ship_bytes", tr.now_us(), int(nbytes)))


def note_evict(action: str) -> None:
    """Count one cluster-committed eviction in the active session trace
    (Statement.commit / Session.evict call this beside
    metrics.note_eviction): /debug/sessions summaries aggregate these
    into per-action eviction counts per session."""
    tr = getattr(_tls, "trace", None)
    if tr is not None:
        tr.counters.append((f"evictions.{action}", tr.now_us(), 1))


def note_evicts(action: str, count: int) -> None:
    """Bulk form for the batched commit flush: one counter entry
    carrying the whole flush's committed-eviction count (the recorder's
    summaries sum entry VALUES, so per-session eviction counts equal
    the sequential control's)."""
    tr = getattr(_tls, "trace", None)
    if tr is not None and count:
        tr.counters.append((f"evictions.{action}", tr.now_us(), count))


# Degraded-mode reasons are bounded per session (a pathological cycle
# could otherwise append one note per failing task).
_MAX_DEGRADED_NOTES = 16


def note_degraded(reason: str) -> None:
    """Record that the active session ran degraded and why (breaker open,
    device fault fallback, deadline overrun): lands in the trace's meta,
    so /debug/sessions shows which cycles ran degraded and the reason
    (doc/CHAOS.md)."""
    tr = getattr(_tls, "trace", None)
    if tr is None:
        return
    notes = tr.meta.setdefault("degraded", [])
    if len(notes) < _MAX_DEGRADED_NOTES:
        notes.append(reason)


def set_meta(**kv) -> None:
    tr = getattr(_tls, "trace", None)
    if tr is not None:
        tr.meta.update(kv)


def set_uid(uid: str) -> None:
    """Attach the session's UUID (Session.uid) to the active trace."""
    tr = getattr(_tls, "trace", None)
    if tr is not None:
        tr.uid = uid


def note_verdict(job_name: str, reason: str, message: str) -> None:
    """Record an unschedulable verdict for ``job_name`` in the current
    session (Session.update_job_condition routes every PodGroup
    Unschedulable condition here — job_valid gate and gang close both)."""
    tr = getattr(_tls, "trace", None)
    if tr is None:
        return
    if (len(tr.verdicts) < _MAX_VERDICTS) or (job_name in tr.verdicts):
        tr.verdicts[job_name] = {"reason": reason, "message": message}


def note_tally(job_name: str, **tally) -> None:
    """Record a solver-derived rejection tally (tpu_allocate: how many of
    the job's candidate tasks placed, and whether the static predicate
    mask left any node standing for the first unplaced task)."""
    tr = getattr(_tls, "trace", None)
    if tr is None:
        return
    if (len(tr.tallies) < _MAX_VERDICTS) or (job_name in tr.tallies):
        tr.tallies[job_name] = tally


# ----------------------------------------------------------------------
# log correlation: [s=<id>] on every scheduler-loop record

_LOG_PREFIXES = ("kube_batch_tpu", "bench", "__main__")
_factory_lock = threading.Lock()
_factory_installed = False


def install_log_correlation() -> None:
    """Tag every log record emitted from this package while a traced
    session is active with the session id — ``[s=<id>]`` prepended to the
    message and a ``session_id`` attribute for structured formatters — so
    a recorded trace and its log lines join on one key.

    A LogRecord factory (not a logging.Filter) because logger-level
    filters only see records emitted through that exact logger, while the
    loop's records come from a dozen module loggers.  Idempotent."""
    global _factory_installed
    with _factory_lock:
        if _factory_installed:
            return
        old_factory = logging.getLogRecordFactory()

        def factory(*args, **kwargs):
            record = old_factory(*args, **kwargs)
            tr = getattr(_tls, "trace", None)
            if tr is not None and record.name.startswith(_LOG_PREFIXES):
                record.session_id = tr.sid
                if isinstance(record.msg, str):
                    record.msg = f"[s={tr.sid}] {record.msg}"
            return record

        logging.setLogRecordFactory(factory)
        _factory_installed = True
