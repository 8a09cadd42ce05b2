"""Batched statement commit: the per-action effect flush.

The effect side of a session used to be a Python for-loop per task:
``Statement.commit`` (preempt) and the direct ``Session.evict`` path
(reclaim) each drove one ``cache.evict`` round-trip per victim — one
mutex acquisition, one effector call, one event append, one lineage
note, per task.  After the batched eviction solve (doc/EVICTION.md)
this commit machinery was the last sequential wall of a preemption
storm (~1.0-1.5 s of a 50k x 10k cycle).

This module accumulates an action's cluster-side effects in decision
order and flushes them as ONE fused cache update plus ONE bulk egress
call per action (``SchedulerCache.evict_many``): one mutex acquisition
for the whole truth mirror, one events extend, one lineage batch, one
victim-index-consistent restore path for failures.

Ordering contract (the bit-parity the tests pin): effects flush in the
exact order the action decided them, and no other cache event can
interleave within an action (binds egress at the gang-dispatch barrier
inside ``batch_apply``, session-only pipelines never egress), so the
cache event stream, the evictor's victim sequence, and the lineage
sample order are identical to the sequential control —
``KUBE_BATCH_TPU_BATCH_COMMIT=0``.  The concurrent shard pipeline
(tenancy/pipeline.py) extends the same contract ACROSS shards: actions
— and therefore their sinks' flushes — run only in a micro-session's
retire half, and retire halves execute in deterministic shard order, so
per-shard flush sequences never interleave no matter how many shard
dispatches are in flight (doc/TENANCY.md "Concurrent micro-sessions").

Failure contract (doc/CHAOS.md site ``commit.flush_error``): an effect
the bulk egress could not land is re-driven once through the per-task
sequential path (counted as a degraded flush); if that also fails, the
session state is restored exactly as the sequential path's per-task
failure handling would — ``unevict_session`` — so no effect is ever
dropped or double-applied.  Ambiguous outcomes are never re-driven
(the resync machinery owns them, cache/interface.py).
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Tuple

from .. import knobs

BATCH_COMMIT_ENV = knobs.BATCH_COMMIT.env


def batch_commit_enabled() -> bool:
    return knobs.BATCH_COMMIT.enabled()


class CommitSink:
    """One action's deferred cluster-effect accumulator, installed on
    the session as ``ssn._commit_sink`` for the action's lifetime
    (``action_commit`` below).  ``Statement.commit`` and the sink-aware
    ``Session.evict`` append here instead of calling the effector; the
    flush at action exit is the single egress."""

    __slots__ = ("ssn", "action", "evicts")

    def __init__(self, ssn, action: str):
        self.ssn = ssn
        self.action = action
        self.evicts: List[Tuple[object, str]] = []  # (task, reason)

    def add_evict(self, task, reason: str) -> None:
        self.evicts.append((task, reason))

    def _restore(self, task) -> None:
        """Best-effort session restore of one failed effect.  A restore
        can itself fail when the victim's released room was already
        consumed by a later pipeline (the same arithmetic dead end the
        sequential commit-failure path has); the already-queued resync
        owns the repair either way, so the flush must not die here and
        take the remaining restores with it."""
        from ..metrics import metrics
        from .statement import unevict_session
        try:
            unevict_session(self.ssn, task)
        except Exception:  # lint: allow-swallow(restore is best-effort: the failed effect's resync is already queued and the next snapshot rebuilds from truth; counted, not fatal)
            metrics.note_swallowed("commit_unevict")

    def flush(self) -> None:
        """One fused cache update + one bulk egress for everything the
        action committed.  Leaves the sink empty (an action may flush
        more than once only if it re-enters; the context manager
        flushes exactly once at exit)."""
        if not self.evicts:
            return
        from ..cache.interface import AmbiguousOutcomeError
        from ..metrics import metrics
        from ..trace import spans as trace

        ssn = self.ssn
        pairs = self.evicts
        self.evicts = []
        start = time.perf_counter()
        with trace.span("commit.flush", action=self.action,
                        batch=len(pairs)):
            failures = ssn.cache.evict_many(pairs)
            landed_counts: dict = {}
            for task, reason in pairs:
                landed_counts[reason] = landed_counts.get(reason, 0) + 1
            if failures:
                # Degrade the remainder to the per-task sequential path:
                # a failed bulk egress must not drop an effect (the
                # retry) nor double-apply one (only non-landed effects
                # are re-driven; evict_many already mirrored the landed
                # prefix).  Ambiguous outcomes are never re-driven —
                # evict_many queued their resync.
                for task, reason, exc in failures:
                    landed_counts[reason] -= 1
                    if isinstance(exc, AmbiguousOutcomeError):
                        self._restore(task)
                        continue
                    try:
                        ssn.cache.evict(task, reason)
                    except Exception:  # lint: allow-swallow(sequential-path semantics: a victim whose evict fails is restored and skipped; cache.evict queued the resync)
                        self._restore(task)
                    else:
                        landed_counts[reason] += 1
        for reason, count in landed_counts.items():
            metrics.note_evictions(reason, count)
            trace.note_evicts(reason, count)
        trace.counter(f"commit.flush.{self.action}", len(pairs))
        metrics.note_commit_flush(
            self.action, "degraded" if failures else "batched", len(pairs))
        ssn._floor_commit += time.perf_counter() - start


def _defer_to_dispatch_window(ssn, action: str) -> bool:
    """Whether this action's sink flush rides the fused dispatch window
    (doc/FUSED.md "Storm half"): a fused program with a live alloc leg
    is in flight and tpu-allocate still runs LATER in this session's
    ladder — its finish flushes the deferred sink right before touching
    the device result, so the cluster egress overlaps the device wait
    and an eviction-heavy cycle converges to one dispatch + one fused
    flush.  Event order is preserved by construction: the evicts still
    flush before the session's binds (batch_apply egresses binds after
    finish starts), and the sequential control
    (KUBE_BATCH_TPU_BATCH_COMMIT=0) never builds a sink at all."""
    from .. import knobs as _knobs
    if not (_knobs.FUSED.enabled() and _knobs.FUSED_STORM.enabled()):
        return False
    st = getattr(ssn, "_fused_state", None)
    if st is None or not st.dispatched or st.failed:
        return False
    if st.alloc_pending is None:
        # No alloc leg in flight: tpu-allocate may early-out without a
        # finish continuation, and a later action could bind before the
        # close-time safety flush — keep the at-exit flush.
        return False
    names = tuple(getattr(ssn, "_conf_actions", ()) or ())
    if action not in names or "tpu-allocate" not in names:
        return False
    return names.index(action) < names.index("tpu-allocate")


@contextlib.contextmanager
def action_commit(ssn, action: str):
    """Install a CommitSink on ``ssn`` for the duration of one action's
    execute, flushing at exit (including the exception path — effects
    already mirrored into the session MUST reach the cluster, or truth
    and session diverge until resync).  A no-op handing back the outer
    sink when one is already active (nested actions accumulate into
    their caller's flush), and a no-op entirely under the sequential
    control arm.

    Storm half (ops/fused_solver.flush_deferred): when a fused dispatch
    with a live alloc leg is in flight and tpu-allocate runs later in
    the ladder, the at-exit flush defers into that action's device-wait
    window instead — same sink, same effect order, one fused flush."""
    if not batch_commit_enabled():
        yield None
        return
    existing = getattr(ssn, "_commit_sink", None)
    if existing is not None:
        yield existing
        return
    sink = CommitSink(ssn, action)
    ssn._commit_sink = sink
    try:
        yield sink
    finally:
        ssn._commit_sink = None
        if sink.evicts and _defer_to_dispatch_window(ssn, action):
            deferred = getattr(ssn, "_deferred_flush", None)
            if deferred is None:
                deferred = []
                ssn._deferred_flush = deferred
            deferred.append(sink)
        else:
            sink.flush()
