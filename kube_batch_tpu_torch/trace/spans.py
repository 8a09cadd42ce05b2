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

Work that happens between sessions, or on threads that hold no session
(the cache's informer handlers, the interpreter's cyclic collector), is
carried: ``handoff`` keeps up to ``CARRY_MAX`` completed spans, and the
next ``begin_session`` drains them into its trace on a track of their own,
``CARRIED_TRACK``, with timestamps before the session's start (negative
``ts``); ``summarize_phases`` and ``/debug/sessions``' ``phases_ms`` leave
that track out, and ``/debug/sessions`` reports it apart as
``between_sessions_ms``.  Past ``CARRY_MAX`` each new span merges into the
last, counted in its ``merged`` arg, so a standby replica that never
opens a session does not grow.  Under ``KUBE_BATCH_TPU_TRACE=0`` nothing
is carried, no handler reads the clock, no collector hook is installed
and no CUDA event is created.

The spans of a scheduling cycle, besides the session's phases:

- ``cache.ingest`` (carried): one per run of back-to-back ``add_*`` /
  ``update_*`` informer handler calls of one ``SchedulerCache`` (pods,
  pod groups, nodes, queues, PDBs, priority classes), timed under the
  cache mutex (``HandlerRuns``); args ``calls``, ``handlers``.
  ``cache.delete`` likewise for the ``delete_*`` handlers.
- ``gc.full`` (carried, depth 1): one per full collection, from the
  collector hook each live ``Scheduler`` holds (``hold_gc_hook``);
  args ``collected``.  A collection that starts inside a handler lies
  inside that handler's run.
- ``apply.aggregates``, ``apply.walk``, ``apply.settle``,
  ``cache.lineage`` (two), ``cache.bind`` and ``cache.assume``: apply's
  children, one of each per batch (actions/tpu_allocate.py,
  framework/session.py, cache/cache.py).
- ``k1.device`` (track ``device``): K1's device time on the host clock,
  from CUDA events around the launch read when its handle is fetched
  (ops/cuda_solver.py ``K1Timing``); args ``device_ms``, ``aligned``.

The same clock readings feed ``/metrics``:
``kube_batch_cache_handler_seconds_total{handler}`` (the walls of a
run's stretches of each handler's calls, when the cache's next run
opens) and
``kube_batch_gc_pause_seconds_total{generation}``.
"""

from __future__ import annotations

import gc
import itertools
import logging
import threading
import time
import weakref
from collections import deque
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
# spans carried between sessions

# The track carried spans ride in a session trace; summarize_phases leaves
# it out, so a session's phases still sum to at most its wall time.
CARRIED_TRACK = "between sessions"
# A standby replica never opens a session: past this many carried spans,
# each new one is merged into the last and counted in its args.
CARRY_MAX = 256
# A handler call joins its cache's run when less than this passed since
# the run's last call ended, the collector's passes in between not
# counted.
RUN_GAP_S = 1e-3


class _Carried:
    """One carried span (``perf_counter`` seconds), open to extension
    until a session drains it (``sealed``)."""

    __slots__ = ("name", "start", "end", "depth", "args", "merged",
                 "sealed")

    def __init__(self, name, start, end, depth=0, args=None):
        self.name = name
        self.start = start
        self.end = end
        self.depth = depth
        self.args = args
        self.merged = 0
        self.sealed = False

    def record_args(self) -> dict:
        out = dict(self.args) if self.args else {}
        if self.merged:
            out["merged"] = self.merged
        return out


class _Run(_Carried):
    """A carried run of one cache's handler calls: ``calls`` in all, and
    [calls, seconds] per handler in ``stats`` for the stretches of the
    run it has closed, a stretch's seconds its wall, from its first
    call's start to its last call's end.  The open stretch is
    ``handler``'s, from ``since``, after ``before`` calls."""

    __slots__ = ("calls", "handler", "since", "before", "stats")

    def __init__(self, name, start):
        super().__init__(name, start, start)
        self.calls = 0
        self.handler: Optional[str] = None
        self.since = start
        self.before = 0
        self.stats: Dict[str, list] = {}

    def switch(self, handler: Optional[str], start: float) -> None:
        """Close the open stretch; ``handler``'s opens at ``start``."""
        if self.handler is not None:
            st = self.stats.setdefault(self.handler, [0, 0.0])
            st[0] += self.calls - self.before
            st[1] += self.end - self.since
        self.handler, self.since, self.before = handler, start, self.calls

    def record_args(self) -> dict:
        out = super().record_args()
        handlers = set(dict(self.stats))   # one C-level copy: the owner adds
        handlers.add(self.handler)
        handlers.discard(None)
        out["calls"] = self.calls
        out["handlers"] = sorted(handlers)
        return out


class Handoff:
    """The bounded, process-wide list of carried spans.  Writers only
    append (atomic under the GIL), so the collector's hook may carry a
    span while a handler that started the collection holds its cache's
    mutex; the drain pops, so two sessions opening at once split the
    spans between them and never take one twice."""

    def __init__(self, capacity: int = CARRY_MAX):
        self.capacity = capacity
        self._spans: List[_Carried] = []

    def __len__(self) -> int:
        return len(self._spans)

    def carry(self, rec: _Carried) -> None:
        """Carry ``rec`` to the next session; past ``capacity``, merge it
        into the last one instead (``rec`` then reaches no session)."""
        spans = self._spans
        if len(spans) >= self.capacity:
            try:
                last = spans[-1]
            except IndexError:      # a session drained it meanwhile
                pass
            else:
                last.start = min(last.start, rec.start)
                last.end = max(last.end, rec.end)
                last.merged += 1
                return
        spans.append(rec)

    def drain_into(self, tr: "SessionTrace") -> None:
        """Move every carried span into ``tr`` on CARRIED_TRACK."""
        spans = self._spans
        for _ in range(len(spans)):
            try:
                c = spans.pop(0)
            except IndexError:
                break
            c.sealed = True
            tr.spans.append(SpanRecord(
                c.name, (c.start - tr.t0) * 1e6, (c.end - c.start) * 1e6,
                CARRIED_TRACK, c.depth, c.record_args()))

    def clear(self) -> None:
        del self._spans[:]


handoff = Handoff()
# What a cache's HandlerRuns holds before its first call: a sealed run.
_NO_RUN = _Run("", 0.0)
_NO_RUN.sealed = True


class HandlerRuns:
    """One cache's handler calls, merged into runs: a call joins the run
    when it is of the same kind (``cache.ingest`` or ``cache.delete``)
    and less than RUN_GAP_S passed since the run's last call ended, the
    collector's passes in between not counted.  Each run is one carried
    span, with ``calls`` and the handlers it ran in its args.  When the
    cache's next run opens, the run's seconds per handler (the walls of
    its stretches of that handler's calls) go to ``fold`` (``/metrics``
    kube_batch_cache_handler_seconds_total).  ``note`` runs under the
    cache's mutex, which guards everything here."""

    __slots__ = ("_run", "_fold")

    def __init__(self, fold=None):
        self._run = _NO_RUN
        self._fold = fold

    def note(self, name: str, handler: str, start: float,
             end: float) -> None:
        """One handler call, ``start`` to ``end`` (perf_counter)."""
        run = self._run
        if (run.sealed or start - run.end >= RUN_GAP_S
                or run.name is not name):
            run = self._open(name, start)
        if handler is not run.handler:
            run.switch(handler, start)
        run.end = end
        run.calls += 1

    def _open(self, name: str, start: float) -> _Run:
        """The run this call joins: the current one when the collector
        filled the gap since its last call, else a new one."""
        run = self._run
        if not run.sealed and run.name == name:
            gap = start - run.end
            for a, b in list(_GC_HOOK.recent):
                if a >= run.end and b <= start:
                    gap -= b - a
            if gap < RUN_GAP_S:
                return run
        if run.calls and self._fold is not None:
            run.switch(None, start)
            self._fold({h: st[1] for h, st in run.stats.items()})
        run = self._run = _Run(name, start)
        handoff.carry(run)
        return run


class _CollectorHook:
    """The ``gc.callbacks`` entry: each full (generation 2) pass becomes
    a carried ``gc.full`` span with ``collected`` in its args; every pass
    adds to ``pause`` by generation.  ``recent`` keeps the last passes of
    every generation, for HandlerRuns to leave out of a run's gaps.  It
    takes no lock: a pass can start inside a handler that holds its
    cache's mutex."""

    __slots__ = ("_start", "pause", "recent")

    def __init__(self):
        self._start: Optional[float] = None
        self.pause = [0.0, 0.0, 0.0]    # seconds per generation
        self.recent = deque(maxlen=64)  # (start, end) of each pass

    def __call__(self, phase, info) -> None:
        now = time.perf_counter()
        if phase == "start":
            self._start = now
            return
        start = self._start
        if start is None:
            return
        self._start = None
        generation = info.get("generation", 2)
        self.pause[generation] += now - start
        self.recent.append((start, now))
        if generation == 2:
            handoff.carry(_Carried("gc.full", start, now, 1,
                                   {"collected": info.get("collected", 0)}))


_GC_HOOK = _CollectorHook()
_gc_hook_lock = threading.Lock()
# id() of each live Scheduler that holds the hook.
_gc_holders: set = set()


def hold_gc_hook(holder) -> None:
    """Time the collector's passes while ``holder`` (a Scheduler) lives
    and has not released them: the hook is installed once per process
    and removed when its last holder is stopped or collected."""
    key = id(holder)
    with _gc_hook_lock:
        _gc_holders.add(key)
        if _GC_HOOK not in gc.callbacks:
            gc.callbacks.append(_GC_HOOK)
    weakref.finalize(holder, release_gc_hook, key)


def release_gc_hook(key: int) -> None:
    """Drop a holder (``id()`` of it); the last one removes the hook.
    Takes no lock: it runs as a finalizer, inside whatever collection
    collects the holder."""
    _gc_holders.discard(key)
    if not _gc_holders:
        try:
            gc.callbacks.remove(_GC_HOOK)
        except ValueError:
            pass


def gc_pause_seconds() -> List[float]:
    """Seconds the collector paused the process, per generation, while
    the hook was installed (``/metrics``
    kube_batch_gc_pause_seconds_total)."""
    return list(_GC_HOOK.pause)


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
    handoff.drain_into(tr)
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


def record_span(name: str, start: float, end: float,
                track: Optional[str] = None, **args) -> None:
    """Record a completed span from explicit ``time.perf_counter``
    start and end times into the active session trace (``ts`` may be
    negative).  It nests at the open spans' depth, on ``track`` when
    given (work that overlaps the open spans, such as the device's),
    else on the open root phase's."""
    tr = getattr(_tls, "trace", None)
    if tr is None:
        return
    stack = tr._stack
    if track is None:
        track = stack[0].name if stack else name
    tr.spans.append(SpanRecord(name, (start - tr.t0) * 1e6,
                               (end - start) * 1e6, track, len(stack),
                               args))


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
