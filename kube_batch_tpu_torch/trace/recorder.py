"""Flight recorder: a lock-guarded ring buffer of completed session traces.

Holds the last N ``SessionTrace``s (N = ``KUBE_BATCH_TPU_TRACE_RING``,
default 64) so a slow cycle or a stuck-Pending job is diagnosable AFTER
the fact, without re-running anything: each trace carries its span tree
(trace/spans.py), the session's unschedulable verdicts (the
``vr.reason``/``message`` pairs Session.update_job_condition recorded),
and the solver-mask rejection tallies from tpu-allocate.  Served over
HTTP by the metrics server's ``/debug`` endpoints (cli/server.py).

Traces are immutable once recorded (the session thread drops its
reference at end_session), so readers copy the ring under the mutex and
compute summaries outside it.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .. import knobs
from ..metrics import memledger

_RING_ENV = knobs.TRACE_RING.env
_DEFAULT_RING = knobs.TRACE_RING.default

# Flat per-structure estimates for a recorded SessionTrace (span
# records, verdict/tally rows, counter triples).  The record() hook and
# the memledger auditor price traces identically, so audit_mem_ledgers
# checks hook coverage, not estimate quality.
_TRACE_BASE_EST = 512
_SPAN_EST = 160
_ENTRY_EST = 256
_COUNTER_EST = 48


def _trace_nbytes(tr) -> int:
    return (_TRACE_BASE_EST + _SPAN_EST * len(tr.spans)
            + _ENTRY_EST * (len(tr.verdicts) + len(tr.tallies))
            + _COUNTER_EST * len(tr.counters))


def _ring_actual_nbytes(rec: "FlightRecorder") -> int:
    with rec._lock:
        return sum(_trace_nbytes(t) for t in rec._traces)


class FlightRecorder:
    """# mem-ledger: trace_ring"""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            # Validated like ops/solver.shard_knobs: a malformed ring
            # size warns loudly exactly once and pins the default,
            # instead of being silently swallowed at first use.
            from .lineage import validated_ring_env
            capacity = validated_ring_env(_RING_ENV, _DEFAULT_RING)
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._traces: List = []            # guarded-by: _lock  (oldest first)
        self._by_sid: Dict[int, object] = {}  # guarded-by: _lock
        self._mem_key = memledger.ledger("trace_ring").track(
            self, sizer=_ring_actual_nbytes)

    def record(self, trace) -> None:
        """Append a completed trace, evicting the oldest beyond capacity.

        Verdict/tally values identical to the previous session's are
        deduplicated to the previous OBJECTS: a cluster with thousands of
        persistently stuck jobs re-records the same reasons every cycle,
        and without sharing, the ring would pin capacity x stuck-jobs
        copies of identical dicts and message strings."""
        with self._lock:
            prev = self._traces[-1] if self._traces else None
            if prev is not None:
                for table, prev_table in ((trace.verdicts, prev.verdicts),
                                          (trace.tallies, prev.tallies)):
                    for key, value in table.items():
                        prev_value = prev_table.get(key)
                        if prev_value is not None and prev_value == value:
                            table[key] = prev_value
            self._traces.append(trace)
            self._by_sid[trace.sid] = trace
            while len(self._traces) > self.capacity:
                old = self._traces.pop(0)
                self._by_sid.pop(old.sid, None)
            ring_nbytes = sum(_trace_nbytes(t) for t in self._traces)
        memledger.ledger("trace_ring").set(self._mem_key, ring_nbytes)

    def get(self, sid: int):
        with self._lock:
            return self._by_sid.get(sid)

    def latest(self):
        with self._lock:
            return self._traces[-1] if self._traces else None

    def traces(self) -> List:
        """Snapshot copy, oldest first."""
        with self._lock:
            return list(self._traces)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._by_sid.clear()
        memledger.ledger("trace_ring").set(self._mem_key, 0)

    # ------------------------------------------------------------------
    # read API for the /debug endpoints

    def summaries(self) -> List[dict]:
        """Recent session summaries, newest first (/debug/sessions)."""
        from .export import summarize_phases
        out = []
        for tr in reversed(self.traces()):
            evictions: Dict[str, int] = {}
            commit_flushes: Dict[str, int] = {}
            for name, _ts, value in tr.counters:
                if name.startswith("evictions."):
                    # Sum VALUES, not entries: the batched commit flush
                    # records one entry per flush carrying the whole
                    # count (trace.note_evicts), the sequential path one
                    # entry of value 1 per evict — identical totals.
                    action = name[len("evictions."):]
                    evictions[action] = (evictions.get(action, 0)
                                         + int(value))
                elif name.startswith("commit.flush."):
                    action = name[len("commit.flush."):]
                    commit_flushes[action] = (
                        commit_flushes.get(action, 0) + int(value))
            out.append({
                "session": tr.sid,
                "uid": tr.uid,
                "start": round(tr.start_time, 3),
                "duration_ms": round(tr.duration_ms, 3),
                "phases_ms": summarize_phases(tr),
                "spans": len(tr.spans),
                "verdicts": len(tr.verdicts),
                "tallies": len(tr.tallies),
                "evictions": evictions,
                # Batched commit flushes per action (trace counter
                # ``commit.flush.<action>``, value = effects carried):
                # a storm session shows e.g. {"preempt": 5001} here —
                # the per-session form of kube_batch_commit_flushes_total
                # (doc/EVICTION.md "Batched commit").
                "commit_flushes": commit_flushes,
                # Degraded-mode reasons (trace.note_degraded): which
                # cycles ran on a fallback path and why (doc/CHAOS.md).
                # Excluded from the meta copy below — one source of truth.
                "degraded": list(tr.meta.get("degraded", ())),
                "meta": {k: v for k, v in tr.meta.items()
                         if k != "degraded"},
            })
        return out

    @staticmethod
    def _lookup(table: dict, job_name: str):
        """Verdicts/tallies are keyed ``namespace/name`` (names are only
        unique per namespace).  A qualified query matches exactly; a bare
        name matches any namespace — ambiguous across namespaces, but
        the returned entry carries its full key."""
        if "/" in job_name:
            hit = table.get(job_name)
            return (job_name, hit) if hit is not None else (None, None)
        for key, value in table.items():
            if key.rpartition("/")[2] == job_name:
                return key, value
        return None, None

    def why(self, job_name: str) -> Optional[dict]:
        """Answer "why is job X pending" from the most recent session that
        recorded a verdict or rejection tally for it (/debug/why).
        ``job_name`` may be bare or ``namespace/name``-qualified.

        Precedence within that session: the plugin verdict (gang/job_valid
        — the gating reason with its human message) leads; the solver
        tally rides along as corroborating detail when present.

        ``sessions_ago`` flags staleness: 0 means the newest recorded
        session still found the job unschedulable; N > 0 means N newer
        sessions recorded nothing for it — it likely scheduled (or left
        the cluster) since."""
        for age, tr in enumerate(reversed(self.traces())):
            vkey, verdict = self._lookup(tr.verdicts, job_name)
            tkey, tally = self._lookup(tr.tallies, job_name)
            if verdict is None and tally is None:
                continue
            out = {"job": vkey or tkey, "session": tr.sid,
                   "session_start": round(tr.start_time, 3),
                   "sessions_ago": age}
            if verdict is not None:
                out.update(verdict)
            if tally is not None:
                out["solver"] = tally
                if verdict is None:
                    out["reason"] = tally.get("reason", "Unschedulable")
            return out
        return None


recorder = FlightRecorder()
