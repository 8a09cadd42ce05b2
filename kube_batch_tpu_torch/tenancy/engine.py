"""TenancyEngine: per-shard micro-sessions in place of the global cycle.

The scheduler loop keeps its event-driven shape (churn wakes it,
coalescing window, periodic revalidation, crash-loop backoff — see
scheduler.py); the engine changes WHAT one loop iteration runs:

* a churn-woken iteration runs one shard-scoped session per DIRTY shard
  (the per-shard form of the coalesced micro-session), in ascending
  shard order — tenant A's storm schedules A's shard over and over
  while B's quiet shard is untouched until B churns;
* a periodic iteration (schedule_period expired with no churn) and the
  full-session floor run EVERY owned shard — the same revalidation
  cadence the global engine gets from its timeout cycles;
* each shard carries its OWN crash-loop backoff: a persistently failing
  shard (poisoned job, wedged tensorize) is skipped with exponential
  backoff while the other shards keep their schedule — chaos/SLO
  isolation, pinned by tests/test_torch_tenancy.py.

With a ShardLeaseManager attached (active-active federation), only
OWNED shards run and every write is fenced on the shard lease
(view.py); without one, a single replica owns all shards.

Counterpart of kube_batch_tpu/tenancy/engine.py, copied whole.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import torch

from ..metrics import metrics
from .debug import shard_table
from .leases import ShardLeaseManager
from .pipeline import ShardPipeline, concurrent_shards_enabled
from .shards import ShardChurn, ShardLoad, ShardMap, tenancy_shards
from .view import ShardView

log = logging.getLogger(__name__)


def assign_shard_streams(views, device) -> None:
    """Give each shard view its own CUDA stream on a card ``device``
    (nothing on the CPU).  torch.cuda.Stream takes the next stream of
    PyTorch's per-device pool, which goes round-robin over 32 streams,
    so the views' streams, taken here one after the other, are distinct
    up to 32 shards.  Past 32, shards share streams: still correct, but
    their device work runs one after the other (logged)."""
    if device is None or torch.device(device).type != "cuda":
        return
    for view in views:
        view.stream = torch.cuda.Stream(device)
    handles = {view.stream.cuda_stream for view in views}
    if len(handles) < len(views):
        log.warning("%d shard views share %d CUDA streams: sessions of "
                    "shards on one stream serialise their device work",
                    len(views), len(handles))


def engine_from_env(scheduler) -> Optional["TenancyEngine"]:
    """Build the engine when KUBE_BATCH_TPU_TENANCY asks for shards;
    None keeps the single global engine (the control arm)."""
    shards = tenancy_shards()
    if not shards:
        return None
    return TenancyEngine(scheduler, ShardMap.from_env(shards))


class TenancyEngine:

    def __init__(self, scheduler, shard_map: ShardMap, replica: str = "",
                 lease_mgr: Optional[ShardLeaseManager] = None):
        self.scheduler = scheduler
        self.cache = scheduler.cache
        self.map = shard_map
        self.replica = replica or (lease_mgr.identity if lease_mgr
                                   else "single")
        self.leases: Optional[ShardLeaseManager] = None
        # Per-shard load EWMA (pods + churn rate): feeds the federation's
        # load-weighted claim targets (ROADMAP 2c) and /debug/shards.
        self.load = ShardLoad(shard_map.num_shards)
        self.churn = ShardChurn(shard_map, load=self.load)
        self.views = [ShardView(self.cache, shard, shard_map,
                                replica=self.replica)
                      for shard in range(shard_map.num_shards)]
        assign_shard_streams(self.views, getattr(scheduler, "device", None))
        # Concurrent shard micro-sessions (doc/TENANCY.md "Concurrent
        # micro-sessions"): dirty shards pipeline their host phases
        # through each other's async dispatch windows, retiring in
        # deterministic shard order.  KUBE_BATCH_TPU_CONCURRENT_SHARDS=0
        # keeps the strictly sequential control arm.
        self.pipeline: Optional[ShardPipeline] = (
            ShardPipeline(self) if concurrent_shards_enabled() else None)
        # Per-shard crash-loop backoff (scheduler loop thread only).
        self._failures: Dict[int, int] = {}
        self._next_ok: Dict[int, float] = {}
        # Per-shard periodic floor (scheduler loop thread only): when a
        # shard last ran, so SUSTAINED churn in one shard cannot
        # suppress the quiet shards' schedule_period revalidation —
        # back-to-back churn-woken iterations would otherwise never see
        # an empty dirty set.
        self._last_run: Dict[int, float] = {}
        # Last full-cluster load refresh (scheduler loop thread only).
        self._loads_refreshed = 0.0
        if lease_mgr is not None:
            self.attach_leases(lease_mgr)
        # Per-shard churn attribution: the cache's external ingestion
        # paths call shard_churn(queue) alongside the churn_event wake.
        # Foreign cache objects without the attribute degrade to the
        # always-all-dirty periodic pass, like churn_event's fallback.
        try:
            self.cache.shard_churn = self.churn.note
        except AttributeError:  # lint: allow-swallow(read-only cache object: every loop iteration then runs as a periodic all-shards pass, the pre-tenancy cadence)
            pass

    def attach_leases(self, lease_mgr: ShardLeaseManager) -> None:
        """Wire active-active federation: ownership filters the shard
        walk, the lease fences the write egress, and a freshly claimed
        shard is marked dirty so its first session under this replica
        runs immediately (warm-started from the shared compile cache)."""
        self.leases = lease_mgr
        self.replica = lease_mgr.identity
        if lease_mgr._on_claim is None:
            lease_mgr._on_claim = self.churn.note_shard
        if getattr(lease_mgr, "shard_load", None) is None:
            # Load-weighted claim targets (ROADMAP 2c): the replica
            # mirrors the whole cluster, so its own EWMA is a usable
            # estimate of every shard's load — claim deferral weighs
            # load, not raw shard counts.
            lease_mgr.shard_load = self.load.load
        for view in self.views:
            view.replica = lease_mgr.identity
            view._lease_live = lease_mgr.lease_live

    def owned_shards(self):
        if self.leases is None:
            return range(self.map.num_shards)
        return self.leases.owned_shards()

    def run_cycle(self, force_full: bool = False) -> None:
        """One loop iteration: the dirty (or, on a periodic/full pass,
        every owned) shard's micro-session, failure-isolated per shard.
        Never raises — per-shard backoff replaces the global crash-loop
        backoff for shard-session failures."""
        dirty = self.churn.take()
        owned = list(self.owned_shards())
        now = time.time()
        if force_full or not dirty:
            # Periodic revalidation / full-session floor: every owned
            # shard runs (the global engine's timeout-cycle analog).
            run_set = list(owned)
        else:
            # Dirty shards, PLUS any owned shard that has not run for a
            # full schedule_period: one tenant's continuous storm keeps
            # the dirty set non-empty forever, and without this floor
            # the quiet shards would only revalidate at the FULL_EVERY
            # cadence — the global engine gives every job a look each
            # period, and so must the sharded one.
            period = max(self.scheduler.schedule_period, 1e-3)
            run_set = [s for s in owned
                       if s in dirty
                       or now - self._last_run.get(s, 0.0) >= period]
        if force_full:
            from ..models import incremental
            for shard in run_set:
                incremental.request_full(self.views[shard])
        runnable = []
        for shard in sorted(run_set):
            if self._next_ok.get(shard, 0.0) > now:
                # Backing off: the churn that asked for this session is
                # NOT absorbed — the shard stays dirty for the retry.
                self.churn.note_shard(shard)
                continue
            runnable.append(shard)
        self._refresh_loads(now)
        if self.pipeline is not None and len(runnable) > 1 \
                and "session_once" not in self.scheduler.__dict__:
            # Concurrent micro-sessions: successive shards' host phases
            # overlap their predecessors' device-dispatch windows; the
            # cluster-mutating retire halves run in this exact order.
            # An instance-level session_once (a test double / embedder
            # wrapper) cannot be split into halves, so it keeps the
            # sequential walk — the run_once test-double contract,
            # extended.
            self.pipeline.run(runnable)
        else:
            for shard in runnable:
                self._run_shard(shard)
        self._publish()

    # -- stop()/drain plumbing (any thread) ---------------------------------

    def request_drain(self) -> None:
        """Scheduler.stop(): the pipeline must stop issuing new shard
        dispatches and drain in flight before the loop joins."""
        if self.pipeline is not None:
            self.pipeline.request_drain()

    def abandon_inflight(self):
        """Scheduler.stop() after the join: abandon whatever a wedged
        loop left registered.  Returns the stuck shard ids."""
        if self.pipeline is None:
            return []
        return self.pipeline.abandon_inflight()

    # -- per-shard outcome bookkeeping (shared by the sequential arm and
    #    the pipeline's begin/retire halves) --------------------------------

    def _note_shard_failure(self, shard: int) -> None:
        """Failure bookkeeping — MUST run inside the except block (the
        log path reads sys.exc_info)."""
        failures = self._failures.get(shard, 0) + 1
        self._failures[shard] = failures
        period = max(self.scheduler.schedule_period, 1e-3)
        delay = min(self.scheduler._max_backoff,
                    period * (2.0 ** min(failures, 32)))
        self._next_ok[shard] = time.time() + delay
        self.churn.note_shard(shard)
        metrics.note_shard_session(shard, "error")
        metrics.register_schedule_attempt("error")
        metrics.note_cycle_failure("shard")
        metrics.set_degraded(f"shard{shard}_backoff", True)
        self.scheduler._log_cycle_error(f"shard{shard}")

    def _note_shard_ok(self, shard: int, view) -> None:
        if self._failures.pop(shard, None):
            metrics.set_degraded(f"shard{shard}_backoff", False)
        self._next_ok.pop(shard, None)
        metrics.note_shard_session(shard, "ok")
        load = self.load.note_session(shard, view._last_pods)
        shard_table.note_session(shard, view._last_queues,
                                 len(view._last_jobs),
                                 replica=self.replica, load=load)

    def _refresh_loads(self, now: float) -> None:
        """Fold EVERY shard's pod count into the load EWMA — owned or
        not — from this replica's full-cluster mirror (ROADMAP 2c).
        Per-session folds only cover shards this engine runs, and a
        fair-share computed from own-shards-only estimates (everyone
        else's shards floored at ~zero) made every replica think it was
        hogging the fleet — the shed oscillation the soak caught.  One
        O(jobs) walk under the cache mutex, at most once per second."""
        if now - self._loads_refreshed < 1.0:
            return
        self._loads_refreshed = now
        counts = [0] * self.map.num_shards
        shard_of = self.map.shard_of
        mutex = getattr(self.cache, "mutex", None)
        jobs = getattr(self.cache, "jobs", None)
        if jobs is None:
            return
        import contextlib
        with (mutex if mutex is not None else contextlib.nullcontext()):
            for job in jobs.values():
                if job.queue:
                    counts[shard_of(job.queue)] += len(job.tasks)
        for shard, pods in enumerate(counts):
            self.load.note_session(shard, pods)

    def _run_shard(self, shard: int) -> None:
        view = self.views[shard]
        self._last_run[shard] = time.time()
        try:
            self.scheduler.session_once(view, shard=shard)
        except Exception:  # per-shard failure isolation: the loop-survival contract, scoped
            self._note_shard_failure(shard)
        else:
            self._note_shard_ok(shard, view)

    def _publish(self) -> None:
        if self.leases is None:
            # Single-replica mode: this process owns every shard with no
            # lease; /debug/shards still answers ownership.
            for shard in range(self.map.num_shards):
                metrics.set_shard_owner(shard, self.replica)
