"""Per-tenant (queue) fairness accounting: the /debug/tenants surface.

The proportion plugin's session open already computes the one thing a
fairness report needs — each queue's ``deserved`` share (the weighted
water-filling fixed point) next to what it actually holds — and the drf
open computes per-job dominant shares.  This module is just the
publication point: proportion/drf hand their per-queue rows here once
per session (O(queues) work, no extra cluster walk), the gauges land on
/metrics (queue labels cardinality-capped, metrics.bounded_label), and
``/debug/tenants`` serves the same table as JSON.

Thread model: writers are the scheduling thread (plugin opens); readers
are the HTTP debug endpoints — one lock, wholesale snapshot swaps.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from . import metrics


def _in_universe(universe, queue: str) -> bool:
    """``universe`` is a queue set OR a membership predicate (the
    tenancy ShardView's ``owns_queue``).  A predicate is what lets a
    shard-scoped publish detect a DELETED queue as departed: the
    session's current queue set can never contain it, but the shard map
    still answers whose departure it is."""
    return universe(queue) if callable(universe) else queue in universe


class TenantTable:

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: Dict[str, dict] = {}        # guarded-by: _lock
        self._drf_pending: Dict[str, float] = {}  # guarded-by: _lock
        self._session_uid = ""                  # guarded-by: _lock
        self._updated_wall = 0.0                # guarded-by: _lock

    def note_drf_job_shares(self, max_share_by_queue: Dict[str, float],
                            universe: Optional[set] = None) -> None:
        """drf's session open: the largest job share inside each queue.
        Held until proportion publishes the session's table (drf opens
        first in the shipped tier order); published standalone gauges
        immediately so a proportion-less conf still surfaces them.

        ``universe`` (a shard-scoped session, doc/TENANCY.md): a queue
        set or membership predicate — only queues INSIDE it are
        replaced/zeroed; other shards' pending shares survive the
        merge."""
        with self._lock:
            if universe is None:
                departed = [q for q in self._drf_pending
                            if q not in max_share_by_queue]
                self._drf_pending = dict(max_share_by_queue)
            else:
                departed = [q for q in self._drf_pending
                            if _in_universe(universe, q)
                            and q not in max_share_by_queue]
                merged = {q: s for q, s in self._drf_pending.items()
                          if not _in_universe(universe, q)}
                merged.update(max_share_by_queue)
                self._drf_pending = merged
        for queue, share in max_share_by_queue.items():
            metrics.set_tenant_max_job_share(queue, share)
        # Queues whose jobs all left keep their queue object but drop
        # out of the walk — zero them so the gauge can't stay stale.
        for queue in departed:
            metrics.set_tenant_max_job_share(queue, 0.0)

    def publish(self, rows: Dict[str, dict], session_uid: str = "",
                universe: Optional[set] = None) -> None:
        """Proportion's session open: one row per queue with
        share / deserved_share / allocated_share / pending_jobs /
        starvation_s / starved.  Replaces the previous session's table
        wholesale; queues that left have their gauges zeroed so /metrics
        does not report a departed tenant's last shares forever.

        ``universe`` (a shard-scoped session, doc/TENANCY.md): the merge
        form — rows outside the shard's queue universe (a set or
        membership predicate) survive, and only in-universe queues that
        vanished are zeroed."""
        with self._lock:
            drf = self._drf_pending
            if universe is None:
                departed = [q for q in self._rows if q not in rows]
                merged = {}
            else:
                departed = [q for q in self._rows
                            if _in_universe(universe, q)
                            and q not in rows]
                merged = {q: r for q, r in self._rows.items()
                          if not _in_universe(universe, q)}
            for queue, row in rows.items():
                row = dict(row)
                if queue in drf:
                    row["max_job_share"] = round(drf[queue], 4)
                merged[queue] = row
            # (departed rows are absent from `merged` by construction in
            # both branches; they only need their gauges zeroed below.)
            self._rows = merged
            self._session_uid = session_uid
            self._updated_wall = time.time()
        for queue, row in rows.items():
            metrics.set_tenant_stats(
                queue, row.get("share", 0.0),
                row.get("deserved_share", 0.0),
                row.get("allocated_share", 0.0),
                row.get("pending_jobs", 0),
                row.get("starvation_s", 0.0),
                bool(row.get("starved")))
        if departed:
            metrics.clear_tenant_gauges(departed)

    def snapshot(self) -> dict:
        """The /debug/tenants answer."""
        with self._lock:
            return {"queues": {q: dict(r) for q, r in self._rows.items()},
                    "session_uid": self._session_uid,
                    "updated": round(self._updated_wall, 3),
                    "age_s": (round(time.time() - self._updated_wall, 3)
                              if self._updated_wall else None)}

    def clear(self) -> None:
        with self._lock:
            self._rows = {}
            self._drf_pending = {}
            self._session_uid = ""
            self._updated_wall = 0.0


tenant_table = TenantTable()


def dominant_share(res, total) -> float:
    """max over dimensions of res/total — the dominant-resource fraction
    proportion/drf both use (api.share per dimension), 0.0 on an empty
    total."""
    from ..api import share
    best = 0.0
    for rn in res.resource_names():
        s = share(res.get(rn), total.get(rn))
        if s > best:
            best = s
    return best
