"""Queue -> shard assignment and per-shard churn attribution.

Counterpart of kube_batch_tpu/tenancy/shards.py, copied whole.

The shard map is DETERMINISTIC across processes and restarts: by default
a queue hashes to ``blake2b(queue) % num_shards`` (keyed hashing, so the
assignment is independent of PYTHONHASHSEED and identical on every
replica — two replicas that disagree about a queue's shard would both
schedule it), with explicit per-queue overrides from
``KUBE_BATCH_TPU_SHARD_MAP`` for operators that want tenant pinning
(e.g. a whale tenant alone on its own shard).

``ShardChurn`` is the per-shard form of ``SchedulerCache.churn_event``:
the cache's external ingestion paths attribute each mutation to the
affected queue's shard (queue-less mutations — nodes, PriorityClasses —
dirty every shard), and the tenancy engine drains the dirty-shard set to
decide which micro-sessions the next loop iteration runs.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, Iterable, Optional, Set

from .. import knobs

TENANCY_ENV = knobs.TENANCY.env
SHARD_MAP_ENV = knobs.SHARD_MAP.env


def tenancy_shards() -> int:
    """Configured shard count, 0 = tenancy disabled (the single-engine
    control arm).  A malformed value raises: running a silently
    different tenancy topology than configured is the conf-parsing
    failure mode scheduler._mini_yaml refuses too."""
    raw = (knobs.TENANCY.raw() or "").strip()
    if not raw or raw.lower() in ("0", "off", "false"):
        return 0
    shards = int(raw)
    if shards < 1:
        raise ValueError(
            f"{TENANCY_ENV}={raw!r}: shard count must be >= 1 (or 0/off "
            "to disable tenancy)")
    return shards


def parse_shard_overrides(spec: Optional[str],
                          num_shards: int) -> Dict[str, int]:
    """``queue:shard|queue:shard`` explicit pins.  Malformed entries and
    out-of-range shards raise — a typo must not silently strand a tenant
    on the hash default."""
    out: Dict[str, int] = {}
    if not spec:
        return out
    for entry in spec.split("|"):
        entry = entry.strip()
        if not entry:
            continue
        queue, sep, shard = entry.rpartition(":")
        if not sep or not queue:
            raise ValueError(
                f"{SHARD_MAP_ENV} entry {entry!r}: expected <queue>:<shard>")
        idx = int(shard)
        if not 0 <= idx < num_shards:
            raise ValueError(
                f"{SHARD_MAP_ENV} entry {entry!r}: shard {idx} out of "
                f"range for {num_shards} shards")
        out[queue] = idx
    return out


class ShardMap:
    """Deterministic queues -> shard assignment (hash by default,
    explicit conf override).  Immutable once built: every replica of a
    federation derives the identical map from the same configuration."""

    def __init__(self, num_shards: int,
                 overrides: Optional[Dict[str, int]] = None):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = int(num_shards)
        self.overrides = dict(overrides or {})
        for queue, shard in self.overrides.items():
            if not 0 <= shard < self.num_shards:
                raise ValueError(
                    f"shard override {queue}:{shard} out of range for "
                    f"{self.num_shards} shards")
        # Queue -> shard memo: shard_of sits on hot paths (inside the
        # ShardChurn lock on every cache mutation, and in the per-shard
        # snapshot queue filter), and the map is immutable, so each
        # queue hashes exactly once.  Bounded by the cluster's queue
        # count (operator-created objects, not adversarial input).
        self._memo: Dict[str, int] = {}

    @classmethod
    def from_env(cls, num_shards: int) -> "ShardMap":
        return cls(num_shards, parse_shard_overrides(
            knobs.SHARD_MAP.raw(), num_shards))

    def shard_of(self, queue: str) -> int:
        shard = self._memo.get(queue)
        if shard is not None:
            return shard
        pinned = self.overrides.get(queue)
        if pinned is not None:
            shard = pinned
        else:
            digest = hashlib.blake2b(str(queue).encode(),
                                     digest_size=8).digest()
            shard = int.from_bytes(digest, "big") % self.num_shards
        # dict writes are atomic under the GIL; a racing duplicate
        # compute stores the identical value.
        self._memo[queue] = shard
        return shard

    def shards_of(self, queues: Iterable[str]) -> Dict[int, list]:
        """{shard: [queues]} for a queue collection (debug surfaces)."""
        out: Dict[int, list] = {}
        for queue in queues:
            out.setdefault(self.shard_of(queue), []).append(queue)
        return out


class ShardLoad:
    """Per-shard load EWMA of (pod count, churn rate) — the claim-target
    weighting for replica federation (ROADMAP 2c, doc/TENANCY.md): a
    whale tenant's shard should count for what it costs (pods to
    snapshot/tensorize, churn events to absorb), not as one unit of N.

    ``note_churn`` ticks from the cache ingestion hot path (inside the
    ShardChurn lock, one list increment); ``note_session`` folds the
    accumulated events into a per-second rate and EWMA-blends both
    signals after each shard session.  ``load`` is read by the lease
    manager's spread deferral and /debug/shards."""

    ALPHA = 0.3          # EWMA blend per session
    CHURN_WEIGHT = 5.0   # one churn event/s ~ five resident pods of load
    MIN_RATE_WINDOW = 0.25  # s: shorter windows keep accumulating —
    # rate = events/elapsed over a milliseconds window would turn a
    # couple of events into a triple-digit rate spike, poisoning the
    # claim-target fair-share math

    def __init__(self, num_shards: int):
        self._lock = threading.Lock()
        n = int(num_shards)
        self._pods = [0.0] * n        # EWMA pods       guarded-by: _lock
        self._rate = [0.0] * n        # EWMA churn/s    guarded-by: _lock
        self._events = [0] * n        # since last fold guarded-by: _lock
        self._folded = [0.0] * n      # last fold time  guarded-by: _lock

    def note_churn(self, shard: int) -> None:
        with self._lock:
            self._events[shard] += 1

    def note_session(self, shard: int, pods: int) -> float:
        """Fold one finished shard session's observation in; returns the
        refreshed load estimate (also published as a gauge)."""
        from ..metrics import metrics
        now = time.time()
        a = self.ALPHA
        with self._lock:
            last = self._folded[shard]
            if not last:
                # First observation: start the rate window, no fold.
                self._events[shard] = 0
                self._folded[shard] = now
            elif now - last >= self.MIN_RATE_WINDOW:
                rate = self._events[shard] / max(now - last, 1e-6)
                self._events[shard] = 0
                self._folded[shard] = now
                self._rate[shard] = a * rate \
                    + (1.0 - a) * self._rate[shard]
            # else: window too short — keep accumulating events.
            self._pods[shard] = a * float(pods) \
                + (1.0 - a) * self._pods[shard]
            load = self._load_locked(shard)
        metrics.set_shard_load(shard, load)
        return load

    def _load_locked(self, shard: int) -> float:
        return self._pods[shard] + self.CHURN_WEIGHT * self._rate[shard]

    def load(self, shard: int) -> float:
        with self._lock:
            return self._load_locked(shard)

    def loads(self) -> list:
        with self._lock:
            return [self._load_locked(s) for s in range(len(self._pods))]


class ShardChurn:
    """Dirty-shard set fed by the cache's external ingestion paths.

    ``note`` is the cache-side hook (installed as
    ``SchedulerCache.shard_churn``): queue-attributed churn dirties one
    shard, queue-less churn (node/PriorityClass/unresolvable) dirties
    all — an over-approximation is always safe (a spurious micro-session
    finds nothing to do), an under-approximation would strand work."""

    def __init__(self, shard_map: ShardMap,
                 load: Optional["ShardLoad"] = None):
        self._map = shard_map
        self._load = load
        self._lock = threading.Lock()
        self._dirty: Set[int] = set(range(shard_map.num_shards))  # guarded-by: _lock

    def note(self, queue: Optional[str] = None) -> None:
        with self._lock:
            if queue is None:
                self._dirty.update(range(self._map.num_shards))
            else:
                shard = self._map.shard_of(queue)
                self._dirty.add(shard)
                if self._load is not None:
                    # Queue-attributed churn only: broadcast dirtying is
                    # bookkeeping, not per-tenant demand.
                    self._load.note_churn(shard)

    def note_shard(self, shard: int) -> None:
        """Re-mark a shard dirty (engine-side: a skipped or failed
        micro-session must not absorb the churn that requested it)."""
        with self._lock:
            self._dirty.add(shard)

    def take(self) -> Set[int]:
        """Drain the dirty-shard set (scheduler loop thread)."""
        with self._lock:
            out = self._dirty
            self._dirty = set()
            return out
