"""Shard ownership table: the /debug/shards surface.

Counterpart of kube_batch_tpu/tenancy/debug.py, copied whole (served at
``/debug/shards`` by cli/server.py).

Follows the /debug/tenants pattern (metrics/tenants.py): writers are the
tenancy engine (per-session queue membership) and the lease manager
(ownership + lease timing); readers are the HTTP debug endpoints — one
lock, wholesale row swaps, JSON-ready snapshot.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional


class ShardTable:

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: Dict[int, dict] = {}   # guarded-by: _lock
        self._replica = ""                 # guarded-by: _lock
        self._updated_wall = 0.0           # guarded-by: _lock

    def note_session(self, shard: int, queues, jobs: int,
                     replica: str = "", load: Optional[float] = None
                     ) -> None:
        """One shard micro-session closed: record what it actually
        scoped (the queues the shard map resolved this cycle) and the
        refreshed load EWMA feeding the claim targets (ROADMAP 2c)."""
        with self._lock:
            row = self._rows.setdefault(int(shard), {})
            row["queues"] = sorted(queues)
            row["jobs"] = int(jobs)
            row["sessions"] = row.get("sessions", 0) + 1
            row["last_session"] = round(time.time(), 3)
            if load is not None:
                row["load"] = round(float(load), 3)
            if replica:
                row["owner"] = replica
            self._replica = replica or self._replica
            self._updated_wall = time.time()

    def note_lease(self, shard: int, owner: Optional[str],
                   renew_time: float, lease_duration: float,
                   owned_here: bool) -> None:
        """The lease manager's view of one shard's lease record."""
        with self._lock:
            row = self._rows.setdefault(int(shard), {})
            row["owner"] = owner or ""
            row["owned_here"] = bool(owned_here)
            row["lease_renewed"] = round(renew_time, 3)
            row["lease_expires"] = round(renew_time + lease_duration, 3)
            self._updated_wall = time.time()

    def snapshot(self) -> dict:
        """The /debug/shards answer: shard -> owner -> queues ->
        lease expiry."""
        now = time.time()
        with self._lock:
            shards = {}
            for shard, row in sorted(self._rows.items()):
                doc = dict(row)
                expires = doc.get("lease_expires")
                if expires is not None:
                    doc["lease_expires_in_s"] = round(expires - now, 3)
                shards[str(shard)] = doc
            return {"shards": shards,
                    "replica": self._replica,
                    "updated": round(self._updated_wall, 3),
                    "age_s": (round(now - self._updated_wall, 3)
                              if self._updated_wall else None)}

    def clear(self) -> None:
        with self._lock:
            self._rows = {}
            self._replica = ""
            self._updated_wall = 0.0


shard_table = ShardTable()
