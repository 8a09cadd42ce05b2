"""Pod lineage: the end-to-end scheduling-SLO timeline per pod.

The flight recorder (trace/recorder.py) explains what happened INSIDE a
session; this module stitches together what happens to one POD across
sessions and threads — the quantity the scheduler actually promises
users: how long did this pod wait from cluster arrival to bind, and
where did that wait go?

Stages, in arrival order (each recorded at its existing chokepoint, all
O(churn-touched pods) per cycle — no per-session cluster walk anywhere):

* ``ingest``    — the pod entered the scheduler's world: stamped with the
                  edge decode's monotonic timestamp when it arrived over
                  the wire (``RemoteCluster._decode``), or the cache
                  ingestion time on the in-process cluster
                  (``SchedulerCache.add_pod``).
* ``considered``— DERIVED, not recorded: the first scheduling session
                  opened after ingest (sessions snapshot the whole
                  cache, so that session is the first look).  The
                  session ledger below makes it computable in O(log S).
* ``placed``    — a session assigned the pod a node
                  (``Session.batch_apply`` bulk / the cycle context set
                  by ``actions/tpu_allocate.py`` names the action+route).
* ``bind_sent`` — the bind egress left the cache
                  (``SchedulerCache.bind``/``bind_batch``).
* ``bound``     — the bind was PROVEN: egress success, the watch echo,
                  or a resync discovering the pod bound — whichever
                  lands first emits the one-and-only
                  ``kube_batch_slo_time_to_bind_seconds`` sample (the
                  first-wins flag is what makes an ambiguous bind or a
                  relist redelivery single-counted, and the stamp-once
                  ingest is what makes the sample non-negative).
* ``echo``      — the external watch echo landed (mirror == truth).
* ``evicted`` / ``deleted`` — terminal/para-terminal markers; an evicted
                  pod that re-binds records ``rebound`` with NO second
                  SLO sample (time-to-bind measures arrival->first-bind).

Overhead discipline (same contract as the span layer): every hook first
checks one cached config bit; the ``KUBE_BATCH_TPU_LINEAGE=0`` kill
switch makes the module a no-op with ZERO ring writes (pinned by
tests/test_lineage.py), and the bulk hooks (bind_batch, batch_apply)
take the recorder lock once per batch, not per pod.  The ring is
bounded (``KUBE_BATCH_TPU_LINEAGE_RING``, default 2048 pods; malformed
values warn loudly exactly once and pin the default, the
ops/solver.shard_knobs discipline), and so is the session ledger.

Served over HTTP as ``/debug/lineage?pod=<[ns/]name>`` (cli/server.py).
"""

from __future__ import annotations

import bisect
import logging
import threading
import time
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Tuple

from .. import knobs
from ..metrics import memledger, metrics

log = logging.getLogger(__name__)

LINEAGE_ENV = knobs.LINEAGE.env
LINEAGE_RING_ENV = knobs.LINEAGE_RING.env
DEFAULT_RING = knobs.LINEAGE_RING.default
# Session-open ledger depth: a pod that waits longer than this many
# sessions loses its derivable first-consider (counted, not guessed).
_SESSION_LEDGER = 4096

# Legacy alias: the once-per-process warned-set now lives in the knob
# registry (knobs.reset_warnings clears it in place, so this stays live).
_warned_envs = knobs._warned


def warn_once_bad_env(name: str, raw, default) -> None:
    """Loud, once-per-process warning for a malformed env knob (the
    ops/solver.shard_knobs discipline, shared with trace/recorder.py)."""
    knobs.warn_once(name, raw, default, "is not a positive integer",
                    owner=__name__)


def validated_ring_env(name: str, default: int) -> int:
    """Validated positive-int read, routed through the knob registry
    (which holds the authoritative default; ``default`` is kept for
    signature compatibility with pre-registry callers)."""
    return knobs.by_env(name).value()


class _Cfg(NamedTuple):
    enabled: bool
    capacity: int


def _resolve_cfg() -> _Cfg:
    return _Cfg(enabled=knobs.LINEAGE.enabled(),
                capacity=knobs.LINEAGE_RING.value())


# Flat per-structure estimates for the lineage ring (one _PodLineage
# with its event list, one session-ledger entry = one int + one float).
# Hooks and the memledger auditor price entries identically, so
# audit_mem_ledgers checks hook coverage, not estimate quality.
_POD_EST = 1024
_SESSION_ENTRY_EST = 16


def _lineage_nbytes_locked(rec: "LineageRecorder") -> int:
    return (_POD_EST * len(rec._pods)
            + _SESSION_ENTRY_EST * (len(rec._session_seqs)
                                    + len(rec._session_opens)))


def _lineage_actual_nbytes(rec: "LineageRecorder") -> int:
    with rec._lock:
        return _lineage_nbytes_locked(rec)


# Wall<->monotonic anchor for DISPLAY only (/debug/lineage's
# ingest_wall): captured once so per-pod tracking never calls
# time.time().  Wall-vs-mono drift over process life only shifts the
# displayed absolute second; every SLO duration is pure monotonic.
_WALL_ANCHOR = time.time() - time.monotonic()


def _observe_bulk(hist, values, labels: tuple) -> None:
    """observe_many only pays off past numpy's per-call floor."""
    if len(values) >= 16:
        hist.observe_many(values, *labels)
    else:
        for v in values:
            hist.observe(v, *labels)


class _PodLineage:
    """One tracked pod's timeline.  Mutated only under the recorder's
    lock."""

    __slots__ = ("key", "queue", "ingest_mono", "events",
                 "bound", "echoed", "placed", "bind_sent",
                 "awaiting_rebind", "closed", "time_to_bind_s",
                 "first_consider_s")

    def __init__(self, key: str, queue: str, ingest_mono: float):
        self.key = key
        self.queue = queue
        self.ingest_mono = ingest_mono
        self.events: List[tuple] = []   # (stage, mono_ts, detail)
        self.bound = False
        self.echoed = False
        self.placed = False
        self.bind_sent = False
        self.awaiting_rebind = False
        self.closed = False             # deleted from the cluster
        self.time_to_bind_s: Optional[float] = None
        self.first_consider_s: Optional[float] = None


class LineageRecorder:
    """Lock-guarded bounded ring of per-pod timelines plus the
    session-open ledger the derived ``considered`` stage reads.

    # mem-ledger: lineage_ring
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._cfg: Optional[_Cfg] = None       # guarded-by: _lock
        self._pods: "OrderedDict[str, _PodLineage]" = OrderedDict()  # guarded-by: _lock
        # Session-open ledger: plain LISTS (bisect-able in place, unlike
        # a deque) compacted in bulk — appends stay O(1) amortized and a
        # bound pod's first-consider lookup is one bisect, no copying.
        self._session_seqs: List[int] = []     # guarded-by: _lock
        self._session_opens: List[float] = []  # guarded-by: _lock
        self._sessions_dropped = 0             # guarded-by: _lock
        # Pods aged out of the bounded ring (ANY pod, bound or not):
        # nonzero means the ring is no longer a complete record of the
        # workload, which the replay harness's capture must refuse
        # (tools/replay.py) rather than silently mis-schedule.
        self._pods_dropped = 0                 # guarded-by: _lock
        self._next_session = 1                 # guarded-by: _lock
        # Cycle context (action/route of the in-flight placement pass):
        # written only by the scheduling thread between set/clear, read
        # by the same thread's note_placed — no lock needed.
        self.cycle_context: str = ""
        self._mem_key = memledger.ledger("lineage_ring").track(
            self, sizer=_lineage_actual_nbytes)

    def _mem_refresh_locked(self) -> None:
        """Re-price the ring after a mutation.  Caller holds ``_lock``;
        the ledger lock is a leaf, so nesting it here is safe."""
        memledger.ledger("lineage_ring").set(
            self._mem_key, _lineage_nbytes_locked(self))

    # ------------------------------------------------------------------
    # configuration

    def cfg(self) -> _Cfg:
        c = self._cfg
        if c is None:
            with self._lock:
                c = self._cfg
                if c is None:
                    c = self._cfg = _resolve_cfg()
        return c

    def enabled(self) -> bool:
        return self.cfg().enabled

    def refresh(self) -> _Cfg:
        """Re-resolve config from the environment and drop all state —
        the deliberate test hook (conftest unpins after each test)."""
        with self._lock:
            self._cfg = None
            self._pods.clear()
            self._session_seqs.clear()
            self._session_opens.clear()
            self._sessions_dropped = 0
            self._pods_dropped = 0
            self._next_session = 1
            self._mem_refresh_locked()
        self.cycle_context = ""
        return self.cfg()

    def clear(self) -> None:
        with self._lock:
            self._pods.clear()
            self._session_seqs.clear()
            self._session_opens.clear()
            self._sessions_dropped = 0
            self._pods_dropped = 0
            self._mem_refresh_locked()

    # ------------------------------------------------------------------
    # recording hooks (every one no-ops on the kill switch)

    def note_session_open(self) -> None:
        """One entry per scheduling session (open_session, right after
        the snapshot): the ledger the derived first-consider reads."""
        if not self.cfg().enabled:
            return
        now = time.monotonic()
        with self._lock:
            self._session_seqs.append(self._next_session)
            self._session_opens.append(now)
            self._next_session += 1
            if len(self._session_opens) > 2 * _SESSION_LEDGER:
                drop = len(self._session_opens) - _SESSION_LEDGER
                del self._session_seqs[:drop]
                del self._session_opens[:drop]
                self._sessions_dropped += drop
            self._mem_refresh_locked()

    def note_ingest(self, key: str, ingest_mono: Optional[float],
                    queue: str = "") -> None:
        """Track a Pending pod entering the cache.  Stamp-once: a relist
        redelivery (duplicate ADDED) of an already-tracked pod must NOT
        reset the arrival clock — that is what keeps time-to-bind
        non-negative and honest across watch faults."""
        cfg = self.cfg()
        if not cfg.enabled:
            return
        now = time.monotonic()
        with self._lock:
            rec = self._pods.get(key)
            if rec is not None and not rec.closed:
                return  # already tracked; keep the original arrival stamp
            replacing = rec is not None
            rec = _PodLineage(key, queue,
                              now if ingest_mono is None else ingest_mono)
            rec.events.append(
                ("ingest", rec.ingest_mono,
                 "edge" if ingest_mono is not None else "informer"))
            self._pods[key] = rec
            if replacing:  # keep FIFO order exact on re-create
                self._pods.move_to_end(key)
            evicted_unbound = 0
            while len(self._pods) > cfg.capacity:
                _, old = self._pods.popitem(last=False)
                self._pods_dropped += 1
                if not old.bound and not old.closed:
                    evicted_unbound += 1
            self._mem_refresh_locked()
        # A still-pending pod aged out of the ring loses its eventual
        # time-to-bind sample — counted here (the only place the loss
        # is knowable), never guessed at bind time where the pod is
        # indistinguishable from one that was never tracked.
        if evicted_unbound:
            metrics.slo_samples_dropped.inc(float(evicted_unbound),
                                            "ring_evicted")

    def note_placed(self, keys, session=None) -> None:
        """Bulk: a session assigned nodes to these pods (batch_apply).
        One lock for the whole batch; untracked pods are skipped."""
        if not self.cfg().enabled:
            return
        now = time.monotonic()
        detail = self.cycle_context
        if session is not None:
            detail = f"s={session} {detail}".strip()
        with self._lock:
            pods = self._pods
            for key in keys:
                rec = pods.get(key)
                if rec is None or rec.closed:
                    continue
                if not rec.placed or rec.awaiting_rebind:
                    rec.placed = True
                    rec.events.append(("placed", now, detail))

    def note_bind_sent(self, keys) -> None:
        if not self.cfg().enabled:
            return
        now = time.monotonic()
        with self._lock:
            pods = self._pods
            for key in keys:
                rec = pods.get(key)
                if rec is None or rec.closed:
                    continue
                if not rec.bind_sent or rec.awaiting_rebind:
                    rec.bind_sent = True
                    rec.events.append(("bind_sent", now, ""))

    def _first_consider(self, rec):  # holds-lock: _lock
        """(mono_ts, session) of the first session opened after the
        pod's ingest, from the ledger, or (None, None) when no session
        has opened since (or the ledger evicted it)."""
        opens = self._session_opens
        if not opens:
            return None, None
        ix = bisect.bisect_right(opens, rec.ingest_mono)
        if ix >= len(opens):
            return None, None
        if ix == 0 and self._sessions_dropped:
            # The ledger compacted away sessions that may have opened
            # between ingest and opens[0]; opens[0] is then only an
            # upper bound — don't present it as the first look.
            return None, None
        return opens[ix], self._session_seqs[ix]

    def note_bound(self, key: str, queue: str = "",
                   source: str = "bind") -> bool:
        """The bind is PROVEN (egress success / watch echo / resync).
        First-wins: emits the pod's single time-to-bind sample and the
        queue-wait attribution; later confirmations only decorate the
        timeline.  Returns True when the sample was emitted."""
        return self.note_bound_many(((key, queue),), source=source) == 1

    def note_bound_many(self, pairs, source: str = "bind") -> int:
        """Bulk bind confirmations (bind_batch / the echo paths): ONE
        recorder-lock acquisition for the whole batch, metric samples
        emitted grouped per queue outside the lock.  Returns the number
        of first-time samples emitted."""
        if not self.cfg().enabled:
            return 0
        now = time.monotonic()
        emits: List[tuple] = []          # (queue, dt, first_consider|None)
        negative = 0
        with self._lock:
            pods = self._pods
            for key, queue in pairs:
                rec = pods.get(key)
                if rec is None:
                    continue
                if queue and not rec.queue:
                    rec.queue = queue
                if rec.bound:
                    if rec.awaiting_rebind:
                        # Evicted and re-placed: timeline-only, no
                        # sample — the SLO measures arrival->FIRST bind.
                        rec.awaiting_rebind = False
                        rec.events.append(("rebound", now, source))
                    continue
                rec.bound = True
                rec.events.append(("bound", now, source))
                dt = now - rec.ingest_mono
                if dt < 0:
                    # Unreachable while the stamp-once contract holds
                    # (the monotonic clock cannot run backwards);
                    # counted rather than trusted if it ever breaks.
                    negative += 1
                    continue
                rec.time_to_bind_s = dt
                fc_ts, _fc_sid = self._first_consider(rec)
                if fc_ts is not None and fc_ts <= now:
                    rec.first_consider_s = fc_ts - rec.ingest_mono
                    emits.append((rec.queue, dt, rec.first_consider_s))
                else:
                    emits.append((rec.queue, dt, None))
        # Metric emission outside the recorder lock (each collector has
        # its own lock; no nesting needed), grouped per queue: one
        # cardinality-cap resolution and one (bulk) histogram update per
        # queue instead of four locked observes per pod — a mass-bind
        # storm pays vectorized bucketing, not 4x locks per pod.
        if negative:
            metrics.slo_samples_dropped.inc(float(negative), "negative")
        if not emits:
            return 0
        by_queue: dict = {}
        ledger_evicted = 0
        for queue, dt, fc in emits:
            row = by_queue.get(queue)
            if row is None:
                row = by_queue[queue] = ([], [], [])
            row[0].append(dt)
            if fc is not None:
                row[1].append(fc)
                row[2].append(dt - fc)
            else:
                ledger_evicted += 1
        if ledger_evicted:
            metrics.slo_samples_dropped.inc(float(ledger_evicted),
                                            "ledger_evicted")
        for queue, (dts, fcs, scheds) in by_queue.items():
            q = metrics.bounded_label("slo", queue)
            _observe_bulk(metrics.slo_time_to_bind, dts, (q,))
            if fcs:
                _observe_bulk(metrics.slo_first_consider, fcs, (q,))
                _observe_bulk(metrics.slo_queue_wait, fcs,
                              (q, "pre_consider"))
                _observe_bulk(metrics.slo_queue_wait, scheds,
                              (q, "scheduling"))
        return len(emits)

    def note_echo(self, key: str) -> None:
        if not self.cfg().enabled:
            return
        now = time.monotonic()
        with self._lock:
            rec = self._pods.get(key)
            if rec is not None and not rec.echoed:
                rec.echoed = True
                rec.events.append(("echo", now, ""))

    def note_evicted(self, key: str, reason: str) -> None:
        if not self.cfg().enabled:
            return
        now = time.monotonic()
        with self._lock:
            rec = self._pods.get(key)
            if rec is not None and not rec.closed:
                rec.awaiting_rebind = True
                rec.echoed = False
                rec.events.append(("evicted", now, reason))

    def note_evicted_many(self, pairs) -> None:
        """Bulk eviction notes [(key, reason)] in decision order: ONE
        recorder-lock acquisition for the whole commit flush
        (cache.evict_many), same per-pod timeline writes as
        note_evicted."""
        if not self.cfg().enabled:
            return
        now = time.monotonic()
        with self._lock:
            pods = self._pods
            for key, reason in pairs:
                rec = pods.get(key)
                if rec is not None and not rec.closed:
                    rec.awaiting_rebind = True
                    rec.echoed = False
                    rec.events.append(("evicted", now, reason))

    def note_deleted(self, key: str) -> None:
        if not self.cfg().enabled:
            return
        now = time.monotonic()
        with self._lock:
            rec = self._pods.get(key)
            if rec is not None and not rec.closed:
                rec.closed = True
                rec.events.append(("deleted", now, ""))

    # ------------------------------------------------------------------
    # read API (/debug/lineage)

    def tracked(self) -> int:
        with self._lock:
            return len(self._pods)

    def _lookup(self, pod: str) -> Optional[_PodLineage]:  # holds-lock: _lock
        if "/" in pod:
            return self._pods.get(pod)
        for key in reversed(self._pods):
            if key.rpartition("/")[2] == pod:
                return self._pods[key]
        return None

    def lineage(self, pod: str) -> Optional[dict]:
        """The full "where has this pod been" timeline, answered from the
        ring.  ``pod`` may be bare or ``namespace/name``-qualified (bare
        matches the newest tracked pod of that name)."""
        if not self.cfg().enabled:
            return None
        with self._lock:
            rec = self._lookup(pod)
            if rec is None:
                return None
            events = list(rec.events)
            fc_ts, fc_sid = self._first_consider(rec)
            key, queue = rec.key, rec.queue
            ingest_mono = rec.ingest_mono
            ingest_wall = _WALL_ANCHOR + ingest_mono
            bound, closed = rec.bound, rec.closed
            ttb, fcs = rec.time_to_bind_s, rec.first_consider_s
        if fc_ts is not None:
            # Synthesize the derived stage so the timeline reads
            # ingest -> considered -> placed -> bind -> echo in one list.
            events.append(("considered", fc_ts,
                           f"s={fc_sid}" if fc_sid else ""))
        events.sort(key=lambda e: e[1])
        return {
            "pod": key,
            "queue": queue,
            "bound": bound,
            "deleted": closed,
            "ingest_wall": round(ingest_wall, 3),
            "time_to_bind_s": (round(ttb, 6) if ttb is not None else None),
            "time_to_first_consider_s": (
                round(fcs, 6) if fcs is not None
                else (round(fc_ts - ingest_mono, 6)
                      if fc_ts is not None else None)),
            "stages": [{"stage": stage,
                        "t_rel_s": round(ts - ingest_mono, 6),
                        **({"detail": detail} if detail else {})}
                       for stage, ts, detail in events],
        }

    def summary(self) -> dict:
        """Ring meta for the /debug index."""
        cfg = self.cfg()
        with self._lock:
            return {"enabled": cfg.enabled, "capacity": cfg.capacity,
                    "tracked_pods": len(self._pods),
                    "sessions_seen": self._next_session - 1}

    def dump(self) -> dict:
        """Serialize the whole ring for the replay harness
        (tools/replay.py): every tracked pod in ingest order with its
        first-visible session (the ledger seq of the first session
        opened after the pod's ingest stamp — how replay regroups
        arrivals into the recorded cycle cadence) and its raw stage
        timeline, plus the session ledger itself.  Read-only, answered
        from the ring like :meth:`lineage`."""
        cfg = self.cfg()
        with self._lock:
            opens = list(self._session_opens)
            seqs = list(self._session_seqs)
            pods = []
            for key, rec in self._pods.items():
                ix = bisect.bisect_right(opens, rec.ingest_mono)
                pods.append({
                    "pod": key,
                    "queue": rec.queue,
                    "first_session": seqs[ix] if ix < len(seqs) else None,
                    "bound": rec.bound,
                    "deleted": rec.closed,
                    "evicted": any(s == "evicted" for s, _t, _d
                                   in rec.events),
                    "stages": [{"stage": s, "t": round(t, 6),
                                **({"detail": d} if d else {})}
                               for s, t, d in rec.events],
                })
            return {"enabled": cfg.enabled,
                    "sessions": self._next_session - 1,
                    "sessions_dropped": self._sessions_dropped,
                    "pods_dropped": self._pods_dropped,
                    "ledger": [[seq, round(ts, 6)]
                               for seq, ts in zip(seqs, opens)],
                    "pods": pods}


lineage = LineageRecorder()


def refresh_lineage() -> _Cfg:
    return lineage.refresh()
