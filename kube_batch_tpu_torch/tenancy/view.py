"""ShardView: the shard-scoped face of a SchedulerCache.

One persistent view per shard wraps the shared cache and narrows exactly
three surfaces:

* ``snapshot()`` — the session sees only the shard's queues and their
  jobs (all nodes: capacity is shared cluster-wide), so tensorize/solve/
  close are O(shard), not O(cluster);
* the incremental-close bookkeeping — ``close_plan`` intersects the
  cache-wide plan with the shard's job universe and
  ``note_close_results`` merges (instead of replacing) the cache's
  active set, so shard A's close cannot clobber shard B's quiet-skip
  license;
* the write egress (``bind``/``bind_batch``/``evict``/
  ``update_job_status``) — fenced on the shard's lease when a
  federation lease manager is attached (the per-shard form of the
  cache-wide ``write_fence``), and bind egress is stamped with the
  owning replica.

Everything else delegates to the underlying cache.  The per-cache
solver-state attachments (``_tensor_cache`` / ``_inc_state`` /
``_ship_cache``) are declared as class attributes so each view grows its
OWN persistent device state: a shard's tensors, dirty rows, and
device-resident buffers never thrash against another shard's.  On the
card each view also holds its own CUDA stream, ``stream``, which the
TenancyEngine gives it (engine.py); every session over the view runs
its device work on it (scheduler.py).  The reference has no such thing:
JAX orders device work itself.

Counterpart of kube_batch_tpu/tenancy/view.py, copied whole.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Set

from ..api import ClusterInfo
from ..metrics import metrics

log = logging.getLogger(__name__)


class ShardView:
    # Per-cache solver-state attachment points (models/tensor_snapshot,
    # models/incremental, models/shipping look these up with getattr):
    # declared None here so the lookups do NOT fall through __getattr__
    # to the shared cache — each view keeps its own persistent state.
    _tensor_cache = None
    _inc_state = None
    _ship_cache = None
    # The view's own CUDA stream (engine.assign_shard_streams); None on
    # the CPU, where sessions work on the current stream.
    stream = None

    def __init__(self, cache, shard: int, shard_map, replica: str = "",
                 lease_live: Optional[Callable[[int], bool]] = None):
        self._cache = cache
        self.shard = int(shard)
        self._map = shard_map
        self.replica = replica
        self._lease_live = lease_live
        # Job uids / queue names the LAST shard snapshot served: the
        # close-bookkeeping merge universe (scheduler loop thread only —
        # shard sessions within one engine snapshot strictly serially,
        # even when the concurrent pipeline overlaps their device
        # windows).  _last_pods feeds the shard-load EWMA (ROADMAP 2c).
        self._last_jobs: Set[str] = set()
        self._last_queues: tuple = ()
        self._last_pods: int = 0

    def __getattr__(self, name):
        return getattr(self._cache, name)

    def __repr__(self) -> str:
        return (f"ShardView(shard={self.shard}, replica={self.replica!r}, "
                f"cache={self._cache!r})")

    # -- shard-scoped snapshot ----------------------------------------------

    def _mine(self, queue: str) -> bool:
        return self._map.shard_of(queue) == self.shard

    def owns_queue(self, queue: str) -> bool:
        """Whether this shard owns ``queue`` under the shard map — the
        tenant-table publication universe (metrics/tenants.py): a
        MEMBERSHIP TEST rather than the session's current queue set, so
        a queue that was deleted from the cluster still counts as this
        shard's departure to detect and zero."""
        return self._mine(queue)

    def snapshot(self) -> ClusterInfo:
        """The shard's slice of the cache snapshot: this shard's queues,
        those queues' jobs, ALL nodes (shared capacity — another
        tenant's binds are visible as used resources, exactly as they
        are to a later cycle of the global engine)."""
        info = self._cache.snapshot()
        out = ClusterInfo()
        out.nodes = info.nodes
        out.queues = {name: q for name, q in info.queues.items()
                      if self._mine(name)}
        queues = out.queues
        out.jobs = {uid: job for uid, job in info.jobs.items()
                    if job.queue in queues}
        self._last_jobs = set(out.jobs)
        self._last_queues = tuple(queues)
        self._last_pods = sum(len(job.tasks) for job in out.jobs.values())
        return out

    # -- incremental-close bookkeeping, shard-scoped ------------------------

    def close_plan(self):
        plan = self._cache.close_plan()
        if plan is None:
            return None
        active, recloned, seqmap = plan
        jobs = self._last_jobs
        return (active & jobs, recloned & jobs, seqmap)

    def note_close_results(self, active: set) -> None:
        # Merge against THIS shard's job universe: jobs of other shards
        # keep their cache-wide quiet/active verdicts untouched.
        self._cache.note_close_results(
            set(active), universe=self._last_jobs | set(active))

    # -- fenced write egress ------------------------------------------------

    def _check_shard_fence(self) -> None:
        """Per-shard write fence (doc/TENANCY.md "Failover contract"):
        once this replica can no longer prove a live lease on the shard
        — renewal failed past the deadline, the lease was stolen, or an
        injected clock skew says our clock ran past it — every cluster
        write for the shard refuses.  The new owner may already be
        scheduling these queues; racing it would turn failover into a
        double-bind attempt (the truth store's 409 would still reject
        it, but the fence keeps the loser from ever sending)."""
        if self._lease_live is not None and not self._lease_live(self.shard):
            metrics.note_shard_lease(self.shard, "fenced_write")
            raise RuntimeError(
                f"shard {self.shard} lease lost: refusing cluster write "
                "(another replica may already own this shard)")

    def bind(self, task, hostname: str) -> None:
        self._check_shard_fence()
        self._cache.bind(task, hostname)
        metrics.note_shard_binds(self.shard, self.replica, 1)

    def bind_batch(self, tasks) -> None:
        self._check_shard_fence()
        self._cache.bind_batch(tasks)
        metrics.note_shard_binds(self.shard, self.replica, len(tasks))

    def evict(self, task, reason: str) -> None:
        self._check_shard_fence()
        self._cache.evict(task, reason)

    def evict_many(self, pairs) -> list:
        """Fenced form of the batched commit flush's bulk evict
        (SchedulerCache.evict_many): without this override the flush
        would fall through __getattr__ to the unfenced cache method and
        a lease-lost replica could bulk-DELETE a whole victim batch
        into a shard another replica already owns."""
        self._check_shard_fence()
        return self._cache.evict_many(pairs)

    def update_job_status(self, job):
        self._check_shard_fence()
        return self._cache.update_job_status(job)
