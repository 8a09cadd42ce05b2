"""SchedulerCache: the cluster mirror and effector hub.

Mirrors kube-batch pkg/scheduler/cache/cache.go and event_handlers.go:
informer callbacks mutate the in-memory model under one lock; ``snapshot()``
deep-clones Ready nodes, queues, and jobs-with-podgroups and resolves job
priority from PriorityClasses; ``bind``/``evict`` go through pluggable
effectors with status revert + resync on failure; pods without a PodGroup get
shadow groups.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

from .. import knobs
from ..api import (ClusterInfo, JobInfo, NodeInfo, Pod, PodGroup, QueueInfo,
                   TaskInfo, TaskStatus, allocated_status, get_job_id,
                   job_terminated, pod_key)
from ..api.job_info import TaskInfo as _TaskInfo
from ..api.queue_info import Queue, queue_from_versioned
from ..api.pod_group_info import from_versioned
from ..chaos import plan as chaos_plan
from ..metrics import memledger, metrics
from ..trace import spans as trace
from ..trace.lineage import lineage as pod_lineage
from .assume import (assume_walk, exact, exact_sum, group_sums,
                     insert_clones)
from .interface import (AmbiguousOutcomeError, Binder, Cache, Evictor,
                        StatusUpdater, VolumeBinder)
from .shadow import create_shadow_pod_group, shadow_group_key, shadow_pod_group

# Bind-egress retry policy (doc/CHAOS.md "Graceful degradation"):
# transient, UNAMBIGUOUS failures (timeout before send, 5xx) retry with
# bounded exponential backoff + full jitter; ambiguous outcomes (the POST
# was delivered, the outcome unproven) are never retried — a duplicate
# Binding POST is not idempotent — and route through resync instead.
BIND_RETRIES_ENV = knobs.BIND_RETRIES.env
_DEF_BIND_RETRIES = knobs.BIND_RETRIES.default
_BIND_BACKOFF_BASE_S = 0.05
_BIND_BACKOFF_CAP_S = 0.5

# The carried spans of the informer's handler runs (trace/spans.py
# HandlerRuns): adds and updates, and deletes.
_INGEST = "cache.ingest"
_DELETE = "cache.delete"


def _bind_retries() -> int:
    return knobs.BIND_RETRIES.value()


def _backoff_sleep(delay: float) -> float:
    """Sleep one backoff step with full jitter; returns the next delay.
    Jitter decorrelates retry waves across schedulers sharing one
    apiserver — it never influences a scheduling decision."""
    time.sleep(min(delay, _BIND_BACKOFF_CAP_S) * (0.5 + random.random() / 2))
    return delay * 2.0


def _retryable_bind_error(exc: Exception) -> bool:
    """Transient-only retry classification.  Permanent rejections —
    store conflicts (the simulator's already-assigned ValueError, the
    edge's 4xx responses) — cannot heal on a re-POST; retrying them just
    sleeps on the scheduling thread before the same resync.  Ambiguous
    outcomes are handled separately (never retried)."""
    if isinstance(exc, AmbiguousOutcomeError):
        return False
    if isinstance(exc, ValueError):
        return False  # store conflict (e.g. nodeName already set)
    status = getattr(exc, "status", None)
    if status is not None and 400 <= int(status) < 500 and status != 429:
        return False  # the request itself is rejected; 5xx/429 retry
    return True


from collections import deque as _deque

# Flat per-entry estimates for the cache's growable diagnostics/reuse
# stores (one event 3-tuple; one pooled job/node clone).  Hooks and the
# memledger auditors price entries identically, so audit_mem_ledgers
# checks hook coverage, not estimate quality.
_EVENT_EST = 96
_CLONE_EST = 640


def _event_ring_actual_nbytes(d: "_EventDeque") -> int:
    return _EVENT_EST * len(d)


def _pool_actual_nbytes(cache: "SchedulerCache") -> int:
    with cache.mutex:
        return _CLONE_EST * (len(cache._pooled_jobs)
                             + len(cache._pooled_nodes))


class _EventDeque(_deque):
    """The cache's local event deque, tee'd into the cluster event
    recorder: every append (3-tuples of reason, object key, message)
    also egresses asynchronously when a recorder is configured.

    Defer window (doc/TENANCY.md "Concurrent micro-sessions"): the shard
    pipeline runs a successor shard's snapshot BEFORE its predecessors'
    commits retire, but the snapshot can append events (the no-spec
    FailedScheduling replay).  ``begin_defer``/``end_defer`` redirect
    appends FROM THE CALLING THREAD ONLY into a buffer the pipeline
    flushes at that shard's retire slot, so the event sequence stays
    bit-identical to the sequential arm.  Reflector threads keep
    appending straight through a window.

    # mem-ledger: event_ring
    """

    def __init__(self, maxlen=10000, recorder=None):
        super().__init__(maxlen=maxlen)
        self._recorder = recorder
        self._defer_tid = None   # thread id owning the defer window
        self._deferred = None
        self._mem_key = memledger.ledger("event_ring").track(
            self, sizer=_event_ring_actual_nbytes)

    def begin_defer(self) -> None:
        import threading as _threading
        self._deferred = []
        self._defer_tid = _threading.get_ident()

    def end_defer(self) -> list:
        """Close the window and hand back what it captured (the caller
        replays it with extend() at the owning retire slot)."""
        out = self._deferred or []
        self._defer_tid = None
        self._deferred = None
        return out

    def append(self, item):
        if self._defer_tid is not None:
            import threading as _threading
            if _threading.get_ident() == self._defer_tid:
                self._deferred.append(item)
                return
        super().append(item)
        memledger.ledger("event_ring").set(self._mem_key,
                                           _EVENT_EST * len(self))
        if self._recorder is not None:
            try:
                self._recorder.record(*item)
            except Exception:
                # Events are best-effort diagnostics, but a recorder that
                # fails every enqueue should not fail invisibly.
                from ..metrics import metrics
                metrics.note_swallowed("event_record")

    def extend(self, items):
        if self._recorder is None and self._defer_tid is None:
            super().extend(items)
            memledger.ledger("event_ring").set(self._mem_key,
                                               _EVENT_EST * len(self))
            return
        for item in items:
            self.append(item)


class _SnapState:
    """The generation-keyed snapshot map (doc/INCREMENTAL.md "floors"):
    the previous cycle's ClusterInfo entries, kept in TRUTH-DICT ORDER so
    an incremental refresh walks only epoch-dirty objects while handing
    the session a dict whose iteration order is bit-identical to the full
    walk's (plugin-open float accumulation is order-dependent; a reordered
    jobs dict would break the INCREMENTAL=0 parity gate).

    Order discipline: every (re)insertion into the truth dicts stamps a
    monotone ``_ins_seq``, so truth iteration order == ascending seq
    order.  The map mirrors that: in-place value replacement keeps a
    key's position; an insertion whose seq tops the high-water mark
    appends; anything else (a node flipping back to Ready, a no-spec job
    regaining its PodGroup) forces one seq-sort rebuild of the map — rare
    by construction, O(dirty) otherwise.

    All fields are guarded by the owning cache's mutex (informer threads
    feed the dirty sets, the scheduling thread consumes them)."""

    __slots__ = ("jobs", "nodes", "jobs_seq", "nodes_seq", "job_hw",
                 "node_hw", "dirty_jobs", "dirty_nodes", "no_spec",
                 "valid", "full", "close_active", "recloned_jobs",
                 "close_walk_all", "agg_valid", "agg_total", "grid_cap",
                 "grid_used", "grid_max")

    def __init__(self):
        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.jobs_seq: Dict[str, int] = {}
        self.nodes_seq: Dict[str, int] = {}
        self.job_hw = -1          # high-water _ins_seq present in jobs
        self.node_hw = -1
        self.dirty_jobs: set = set()
        self.dirty_nodes: set = set()
        # Spec-less jobs (no PodGroup/PDB): the full walk emits one
        # FailedScheduling event per walk for each — replayed in seq
        # order on incremental walks so the event stream stays
        # bit-identical to the control.
        self.no_spec: Dict[str, int] = {}
        self.valid = False        # a full walk has populated the map
        self.full = False         # next snapshot must run the full walk
        # close_session bookkeeping: uids whose last close was NOT
        # provably silent (they must be re-processed every cycle), and
        # the uids the latest snapshot re-cloned (fresh clones carry no
        # quiet verdict yet).
        self.close_active: set = set()
        self.recloned_jobs: set = set()
        self.close_walk_all = True
        # Node-open aggregates (doc/INCREMENTAL.md "floors"): the
        # cluster total-allocatable sum and the per-node quantized
        # (cap, used) grid entries the drf/proportion/nodeorder opens
        # otherwise rebuild O(nodes) every session — maintained from the
        # same entry changes the map itself sees.  agg_total is None
        # whenever ANY node's allocatable has a non-integer dimension
        # (float re-association would break bit parity; the plugins then
        # keep their own walk — the exactness gate of
        # models/incremental.resource_exact).  grid_max is None when a
        # component maximum may have shrunk (lazy recompute at read).
        self.agg_valid = False
        self.agg_total = None   # {"cpu","mem","sc"} exact-int floats
        self.grid_cap: Dict[str, tuple] = {}
        self.grid_used: Dict[str, tuple] = {}
        self.grid_max = None


class SchedulerCache(Cache):
    """In-memory cluster mirror (cache.go:73-105).

    # mem-ledger: snapshot_pool
    """

    def __init__(self, scheduler_name: str = "kube-batch",
                 default_queue: str = "default",
                 binder: Optional[Binder] = None,
                 evictor: Optional[Evictor] = None,
                 status_updater: Optional[StatusUpdater] = None,
                 volume_binder: Optional[VolumeBinder] = None,
                 priority_class_enabled: bool = True,
                 event_recorder=None):
        self.mutex = threading.RLock()
        self.scheduler_name = scheduler_name
        self.default_queue = default_queue
        # --priority-class flag: when disabled, PriorityClass objects are
        # ignored (the reference skips the informer, cache.go:337-344).
        self.priority_class_enabled = priority_class_enabled

        # Informer callbacks (reflector threads) and the scheduling loop
        # both touch the mirror; graftlint enforces the guarded-by
        # relation (doc/LINT.md rule 1).
        self.jobs: Dict[str, JobInfo] = {}          # guarded-by: mutex
        self.nodes: Dict[str, NodeInfo] = {}        # guarded-by: mutex
        self.queues: Dict[str, Queue] = {}          # guarded-by: mutex
        self.priority_classes: Dict[str, object] = {}  # guarded-by: mutex
        self.default_priority_class = None          # guarded-by: mutex

        self.binder = binder
        self.evictor = evictor
        self.status_updater = status_updater
        self.volume_binder = volume_binder

        # Failed-effect repair queue (cache.go:602-624): tasks whose async
        # bind/evict failed are resynced against cluster ground truth.
        self.err_tasks: List[TaskInfo] = []         # guarded-by: mutex
        self.deleted_jobs: List[JobInfo] = []       # guarded-by: mutex
        # Recorded cluster events (bounded; the reference emits to the k8s
        # event stream which is similarly retention-limited).  When an
        # event_recorder is configured (cluster.ClusterEventRecorder),
        # every event ALSO egresses to the cluster's events resource
        # (cache.go:238-240 recorder) — the local deque stays for tests
        # and in-process observers.
        self.events = _EventDeque(maxlen=10000, recorder=event_recorder)
        self.event_recorder = event_recorder

        # Incremental-snapshot support: a monotonically increasing epoch,
        # stamped onto each job/node at mutation time (``mod_epoch``), lets
        # snapshot() reuse last cycle's clones for objects the informers
        # have not touched, and lets tensorization (models/tensor_snapshot)
        # reuse per-job/per-node tensor blocks.  Sessions invalidate pooled
        # clones they mutate via discard_pooled_{job,node}.
        self.epoch: int = 0                        # guarded-by: mutex
        # uid -> (epoch, clone) / name -> (epoch, clone)
        self._pooled_jobs: Dict[str, tuple] = {}   # guarded-by: mutex
        self._pooled_nodes: Dict[str, tuple] = {}  # guarded-by: mutex
        self._mem_pool = memledger.ledger("snapshot_pool").track(
            self, sizer=_pool_actual_nbytes)
        # Incremental snapshot (doc/INCREMENTAL.md "floors"): dict-order
        # seq counter + the generation-keyed snapshot map; None while the
        # control arm (KUBE_BATCH_TPU_INCREMENTAL=0) runs, so the full
        # walk stays the unmodified oracle.
        self._obj_seq: int = 0                     # guarded-by: mutex
        self._snap_state = None                    # guarded-by: mutex

        # Leadership write fence.  The reference fences by exiting the
        # process on lost lease (server.go:135-137); here an in-flight
        # run_once would otherwise finish its cycle and could still
        # bind/evict after a standby acquired the lease.  When set (by
        # ServerRuntime under leader election) every cluster write checks
        # it first and refuses once leadership is gone.
        self.write_fence = None  # Optional[Callable[[], bool]]

        # Churn notification for the event-driven scheduler loop
        # (scheduler.py, doc/INCREMENTAL.md "micro-sessions"): the
        # scheduler installs a threading.Event here and every EXTERNAL
        # ingestion path (informer callbacks, resync repair) sets it —
        # the loop then wakes immediately instead of sleeping out its
        # schedule_period.  Deliberately NOT fired by the scheduler's
        # own writes (_assume_bound_many, the evict truth mirror): waking on
        # self-inflicted churn would spin the loop one no-op cycle per
        # bind.  threading.Event.set is atomic, so the field needs no
        # lock of its own; it is installed once before cache.run().
        self.churn_event = None  # Optional[threading.Event]

        # Per-shard churn attribution (kube_batch_tpu/tenancy/,
        # doc/TENANCY.md): when the tenancy engine runs, it installs
        # ShardChurn.note here and every external ingestion path passes
        # the affected QUEUE alongside the wake — so one tenant's churn
        # dirties one shard instead of waking a global cycle.  None
        # (queue unresolvable) over-approximates to all shards, which is
        # always safe.  Installed once before cache.run(), like
        # churn_event; the callable takes its own lock.
        self.shard_churn = None  # Optional[Callable[[Optional[str]], None]]

        # Lazy-mirror flush chokepoint (edge/client.RemoteCluster,
        # doc/INGEST.md): under KUBE_BATCH_TPU_LAZY_MIRROR the remote
        # mirror defers dataclass materialization of MODIFIED frames for
        # objects nothing has read yet.  snapshot() is the moment the
        # scheduler observes cluster state, so it must drain that
        # deferral first — new_scheduler_cache installs the cluster's
        # flush_pending here when the cluster has one.  Called BEFORE
        # taking self.mutex: the flush fires informer callbacks that
        # re-enter cache ingestion (which takes mutex itself).
        self.mirror_flush = None  # Optional[Callable[[], int]]

        # Handler runs on the trace (trace/spans.py HandlerRuns): every
        # external handler call is timed under the mutex it already
        # holds, its seconds summed into /metrics.  None under
        # KUBE_BATCH_TPU_TRACE=0: no clock is read.
        self._runs = (trace.HandlerRuns(fold=metrics.note_handler_seconds)
                      if trace.enabled() else None)  # guarded-by: mutex

    # ------------------------------------------------------------------
    # epoch stamping + clone pool

    def _touch_job(self, job: JobInfo) -> None:  # holds-lock: mutex
        job.mod_epoch = self.epoch
        st = self._snap_state
        if st is not None:
            st.dirty_jobs.add(job.uid)

    def _touch_node(self, node: NodeInfo) -> None:  # holds-lock: mutex
        node.mod_epoch = self.epoch
        st = self._snap_state
        if st is not None:
            st.dirty_nodes.add(node.name)

    def _stamp_seq(self, obj) -> int:  # holds-lock: mutex
        """Stamp a monotone dict-insertion sequence number onto a truth
        object the moment it enters self.jobs/self.nodes: truth dicts
        iterate in insertion order, so ascending ``_ins_seq`` IS the
        truth order — the invariant the incremental snapshot map's
        ordering discipline stands on (_SnapState)."""
        self._obj_seq += 1
        obj._ins_seq = self._obj_seq
        return self._obj_seq

    def _obj_seq_of(self, obj) -> int:  # holds-lock: mutex
        seq = getattr(obj, "_ins_seq", None)
        if seq is None:
            # Pre-existing object (state enabled after ingestion began):
            # lazy stamps during an ordered walk assign ascending seqs
            # consistent with the current dict order.
            seq = self._stamp_seq(obj)
        return seq

    def _snap_full_invalidate(self) -> None:  # holds-lock: mutex
        """Queue/PriorityClass-level changes alter job filtering or
        priorities without bumping any job epoch: the next snapshot must
        run the full walk."""
        st = self._snap_state
        if st is not None:
            st.full = True

    def request_full_snapshot(self) -> None:
        """The scheduler's periodic full-session floor also revalidates
        the snapshot map (models/incremental.request_full)."""
        with self.mutex:
            self._snap_full_invalidate()

    def _mem_pool_refresh_locked(self) -> None:  # holds-lock: mutex
        """Re-price the clone pool after a mutation.  The ledger lock is
        a leaf, so nesting it under the mutex is safe."""
        memledger.ledger("snapshot_pool").set(
            self._mem_pool, _CLONE_EST * (len(self._pooled_jobs)
                                          + len(self._pooled_nodes)))

    def discard_pooled_job(self, uid: str) -> None:
        """Called by a Session the moment it mutates a job clone: the clone
        is no longer a faithful copy of cache truth and must not be reused
        by the next snapshot.  Runs on the scheduling thread while
        reflector threads repopulate the pool inside snapshot() — the pop
        must see the mutex like every other pool access (found by
        graftlint's guarded-by check)."""
        with self.mutex:
            self._pooled_jobs.pop(uid, None)
            self._mem_pool_refresh_locked()
            st = self._snap_state
            if st is not None:
                st.dirty_jobs.add(uid)

    def discard_pooled_node(self, name: str) -> None:
        with self.mutex:
            self._pooled_nodes.pop(name, None)
            self._mem_pool_refresh_locked()
            st = self._snap_state
            if st is not None:
                st.dirty_nodes.add(name)

    def _note_churn(self, queue: Optional[str] = None) -> None:
        """Wake the scheduler loop: external cluster state changed.
        ``queue`` attributes the churn to one tenant's shard when the
        tenancy engine runs (None = affects every shard)."""
        sc = self.shard_churn
        if sc is not None:
            sc(queue)
        ev = self.churn_event
        if ev is not None:
            ev.set()

    def _queue_of_job(self, job_uid: Optional[str]) -> Optional[str]:  # holds-lock: mutex
        """The churn-attribution queue for a job key, or None when it
        cannot be resolved (the safe all-shards over-approximation)."""
        if not job_uid:
            return None
        job = self.jobs.get(job_uid)
        if job is None:
            return None
        return job.queue or None

    @staticmethod
    def _pg_fingerprint(pg) -> tuple:
        """PodGroup identity for self-echo detection: the spec fields the
        scheduler reads plus the full status.  Conditions carry the
        session-unique transition_id, so two different sessions' writes
        never collide."""
        spec = getattr(pg, "spec", None)
        status = getattr(pg, "status", None)
        return (
            getattr(spec, "min_member", None),
            getattr(spec, "queue", None),
            getattr(spec, "priority_class_name", None),
            getattr(status, "phase", None),
            getattr(status, "running", None),
            getattr(status, "failed", None),
            getattr(status, "succeeded", None),
            tuple((c.type, c.status, c.reason, c.message,
                   getattr(c, "transition_id", None))
                  for c in (getattr(status, "conditions", None) or ())))

    # ------------------------------------------------------------------
    # lifecycle

    def run(self) -> None:
        pass  # informer wiring handled by the Cluster simulator / edge

    def wait_for_cache_sync(self) -> bool:
        return True

    # ------------------------------------------------------------------
    # pod / task ingestion (event_handlers.go:72-161)

    def _get_or_create_job(self, ti: _TaskInfo) -> Optional[JobInfo]:  # holds-lock: mutex
        if not ti.job:
            # No PodGroup annotation: only pods of our scheduler get shadow
            # groups (event_handlers.go:45-70).
            if ti.pod.spec.scheduler_name != self.scheduler_name:
                return None
            key = shadow_group_key(ti.pod)
            ti.job = key
            if key not in self.jobs:
                job = JobInfo(key)
                job.set_pod_group(create_shadow_pod_group(ti.pod))
                job.queue = self.default_queue
                self.jobs[key] = job
                self._stamp_seq(job)
            return self.jobs[key]
        if ti.job not in self.jobs:
            self.jobs[ti.job] = JobInfo(ti.job)
            self._stamp_seq(self.jobs[ti.job])
        return self.jobs[ti.job]

    def _add_task(self, ti: _TaskInfo) -> None:  # holds-lock: mutex
        job = self._get_or_create_job(ti)
        if job is not None:
            # Watch streams can redeliver an ADDED on relist (the network
            # edge's reflector, or the replay/live-event overlap at
            # connect): treat a duplicate as an update so job aggregates
            # don't double-count (the reference logs 'pod already exists'
            # and skips; replacing is the resync-friendly form).
            if ti.uid in job.tasks:
                self._delete_task(job.tasks[ti.uid])
                job = self._get_or_create_job(ti)
            job.add_task_info(ti)
            self._touch_job(job)
        # Terminated pods no longer hold node resources: the reference's
        # addTask only does node accounting for live tasks
        # (event_handlers.go:86 isTerminated gate).
        if ti.status in (TaskStatus.Succeeded, TaskStatus.Failed):
            return
        if ti.node_name:
            if ti.node_name not in self.nodes:
                self._placeholder_node(ti.node_name)
            self._node_add(self.nodes[ti.node_name], ti)

    def _placeholder_node(self, name: str) -> None:  # holds-lock: mutex
        """A node the cache has not seen yet: its tasks arrived first."""
        node = NodeInfo(None)
        node.name = name
        self.nodes[name] = node
        self._stamp_seq(node)

    def _node_add(self, node: NodeInfo, ti: _TaskInfo) -> None:  # holds-lock: mutex
        """``node.add_task(ti)``; an overcommit is an event, not an error."""
        self._touch_node(node)
        try:
            node.add_task(ti)
        except ValueError as exc:
            # Informer truth can transiently overcommit a node; the
            # reference logs and tolerates (event_handlers.go AddPod),
            # letting OutOfSync detection exclude the node if accounting
            # stays inconsistent.
            self.events.append(("FailedAddTask", pod_key(ti.pod), str(exc)))

    def _delete_task(self, ti: _TaskInfo) -> None:  # holds-lock: mutex
        job = self.jobs.get(ti.job)
        if job is not None:
            existing = job.tasks.get(ti.uid)
            if existing is not None:
                job.delete_task_info(existing)
                ti = existing
            self._touch_job(job)
            if job_terminated(job):
                del self.jobs[job.uid]
                self._pooled_jobs.pop(job.uid, None)
                self._mem_pool_refresh_locked()
        if ti.node_name and ti.node_name in self.nodes:
            self._touch_node(self.nodes[ti.node_name])
            try:
                self.nodes[ti.node_name].remove_task(ti)
            except KeyError:
                pass

    def _task_info(self, pod: Pod) -> Optional[_TaskInfo]:
        """Build a TaskInfo, tolerating malformed resource quantities: one
        bad pod must not crash the informer callback (it is recorded as an
        event and skipped, like the reference logs-and-continues)."""
        try:
            return _TaskInfo(pod)
        except ValueError as exc:
            self.events.append(("FailedParsePod", pod_key(pod), str(exc)))
            return None

    def _lineage_capture(self, ti, pod):  # holds-lock: mutex
        """Snapshot the facts the pod-lineage hook needs (key, queue,
        bound-at-truth, edge ingest stamp) while the mutex is already
        held; the lineage recorder itself is driven AFTER the mutex is
        released (_lineage_emit) so lineage bookkeeping never extends
        the informer's cache-mutex hold — the session snapshot cannot
        be delayed by it."""
        if not pod_lineage.cfg().enabled:
            return None
        if ti.node_name:
            job = self.jobs.get(ti.job)
            return (pod_key(pod), job.queue if job is not None else "",
                    True, None)
        if ti.status == TaskStatus.Pending:
            job = self.jobs.get(ti.job)
            return (pod_key(pod), job.queue if job is not None else "",
                    False, getattr(pod, "_ingest_ts", None))
        return None

    @staticmethod
    def _lineage_emit(cap, source: str) -> None:
        """Pod-lineage hook for EXTERNAL ingestion (informer callbacks,
        resync repair) — deliberately not wired into _add_task, so the
        scheduler's own _assume_bound_many mirror never records an echo it
        did not receive.  A Pending unbound pod starts (or keeps) its
        timeline with the edge decode's monotonic stamp when one rode
        in on the object; a node-carrying delivery of a tracked pod is
        the bind landing at truth (first proof emits the SLO sample;
        the stamp-once/first-wins contract in trace/lineage.py is what
        keeps samples non-negative and single-counted across relists,
        resyncs, and ambiguous binds)."""
        if cap is None:
            return
        key, queue, bound, ingest_ts = cap
        if bound:
            pod_lineage.note_bound(key, queue, source=source)
            pod_lineage.note_echo(key)
        else:
            pod_lineage.note_ingest(key, ingest_ts, queue=queue)

    def add_pod(self, pod: Pod) -> None:
        lin = None
        queue = None
        with self.mutex:
            runs = self._runs
            start = time.perf_counter() if runs is not None else 0.0
            self.epoch += 1
            ti = self._task_info(pod)
            if ti is not None:
                self._add_task(ti)
                lin = self._lineage_capture(ti, pod)
                queue = self._queue_of_job(ti.job)
            if runs is not None:
                runs.note(_INGEST, "add_pod", start, time.perf_counter())
        self._lineage_emit(lin, "echo")
        self._note_churn(queue)

    def update_pod(self, old_pod: Pod, new_pod: Pod) -> None:
        lin = None
        queue = old_queue = None
        with self.mutex:
            runs = self._runs
            start = time.perf_counter() if runs is not None else 0.0
            self.epoch += 1
            old_ti = self._task_info(old_pod)
            if old_ti is not None:
                # Resolve BEFORE the delete: if the task is moving to a
                # job in another queue, the SOURCE queue's shard must be
                # dirtied too or its stale state strands until the next
                # periodic pass.
                old_queue = self._queue_of_job(old_ti.job)
                self._delete_task(old_ti)
            ti = self._task_info(new_pod)
            if ti is not None:
                self._add_task(ti)
                lin = self._lineage_capture(ti, new_pod)
                queue = self._queue_of_job(ti.job)
            if runs is not None:
                runs.note(_INGEST, "update_pod", start, time.perf_counter())
        self._lineage_emit(lin, "echo")
        if old_queue is not None and old_queue != queue:
            self._note_churn(old_queue)
        self._note_churn(queue)

    def delete_pod(self, pod: Pod) -> None:
        queue = None
        with self.mutex:
            runs = self._runs
            start = time.perf_counter() if runs is not None else 0.0
            self.epoch += 1
            ti = self._task_info(pod)
            if ti is not None:
                # Resolve BEFORE the delete: a last-task delete drops
                # the terminated job from self.jobs.
                queue = self._queue_of_job(ti.job)
                self._delete_task(ti)
            if runs is not None:
                runs.note(_DELETE, "delete_pod", start, time.perf_counter())
        pod_lineage.note_deleted(pod_key(pod))
        self._note_churn(queue)

    def sync_task(self, old_task: TaskInfo, cluster_pod: Optional[Pod]) -> None:
        """Refetch ground truth for a task whose effect failed
        (event_handlers.go:101-119)."""
        lin = None
        queue = None
        with self.mutex:
            self.epoch += 1
            old_queue = self._queue_of_job(old_task.job)
            self._delete_task(old_task)
            if cluster_pod is not None:
                ti = self._task_info(cluster_pod)
                if ti is not None:
                    self._add_task(ti)
                    lin = self._lineage_capture(ti, cluster_pod)
                    queue = self._queue_of_job(ti.job)
        self._lineage_emit(lin, "resync")
        # Both sides dirty when ground truth moved the task across
        # queues: the source shard must re-observe the departure.
        if old_queue is not None and old_queue != queue:
            self._note_churn(old_queue)
        self._note_churn(queue if queue is not None else old_queue)

    # ------------------------------------------------------------------
    # node ingestion (event_handlers.go:296-365)

    def add_node(self, node) -> None:
        self._ingest_node(node, "add_node")

    def update_node(self, old_node, new_node) -> None:
        self._ingest_node(new_node, "update_node")

    def _ingest_node(self, node, handler: str) -> None:
        with self.mutex:
            runs = self._runs
            start = time.perf_counter() if runs is not None else 0.0
            self.epoch += 1
            if node.name in self.nodes:
                self.nodes[node.name].set_node(node)
            else:
                self.nodes[node.name] = NodeInfo(node)
                self._stamp_seq(self.nodes[node.name])
            self._touch_node(self.nodes[node.name])
            if runs is not None:
                runs.note(_INGEST, handler, start, time.perf_counter())
        self._note_churn()

    def delete_node(self, node) -> None:
        with self.mutex:
            runs = self._runs
            start = time.perf_counter() if runs is not None else 0.0
            self.epoch += 1
            self.nodes.pop(node.name, None)
            self._pooled_nodes.pop(node.name, None)
            self._mem_pool_refresh_locked()
            st = self._snap_state
            if st is not None:
                st.dirty_nodes.add(node.name)
            if runs is not None:
                runs.note(_DELETE, "delete_node", start, time.perf_counter())
        self._note_churn()

    # ------------------------------------------------------------------
    # PodGroup / Queue / PriorityClass ingestion

    def add_pod_group(self, pg) -> None:
        """Accepts a v1alpha1 or v1alpha2 PodGroup (event_handlers.go
        version-converting handlers)."""
        self._ingest_pod_group(pg, "add_pod_group")

    def update_pod_group(self, old_pg, new_pg) -> None:
        self._ingest_pod_group(new_pg, "update_pod_group")

    def _ingest_pod_group(self, pg, handler: str) -> None:
        internal = from_versioned(pg) if not isinstance(pg, PodGroup) else pg
        key = f"{internal.metadata.namespace}/{internal.metadata.name}"
        with self.mutex:
            runs = self._runs
            start = time.perf_counter() if runs is not None else 0.0
            self.epoch += 1
            if key not in self.jobs:
                self.jobs[key] = JobInfo(key)
                self._stamp_seq(self.jobs[key])
            job = self.jobs[key]
            # Self-echo detection: the watch echo of OUR OWN PodGroup
            # status write (update_job_status records the pushed
            # fingerprint below) must not wake the scheduler loop — a
            # persistently unschedulable gang gets a fresh condition
            # (new transition_id) written every session, and counting
            # its echo as churn would spin the event-driven loop at the
            # coalesce cadence forever.  The epoch still bumps (content
            # did change; tensors must refresh), only the WAKE is
            # suppressed.  Sticky until the next push: a repeat echo of
            # the identical object is a no-op for scheduling either way.
            self_echo = (getattr(job, "_pushed_status_fp", None)
                         == self._pg_fingerprint(internal)
                         and job._pushed_status_fp is not None)
            # The job's previous queue, BEFORE the spec lands: a
            # PodGroup whose spec.queue moved must dirty the SOURCE
            # shard too (it still mirrors the job until it re-snapshots).
            old_queue = job.queue or None
            job.set_pod_group(internal)
            if not job.queue:
                job.queue = self.default_queue
            self._touch_job(job)
            queue = job.queue or None
            if runs is not None:
                runs.note(_INGEST, handler, start, time.perf_counter())
        if not self_echo:
            if old_queue is not None and old_queue != queue:
                self._note_churn(old_queue)
            self._note_churn(queue)

    def delete_pod_group(self, pg) -> None:
        internal = from_versioned(pg) if not isinstance(pg, PodGroup) else pg
        key = f"{internal.metadata.namespace}/{internal.metadata.name}"
        with self.mutex:
            runs = self._runs
            start = time.perf_counter() if runs is not None else 0.0
            self.epoch += 1
            job = self.jobs.get(key)
            if job is not None:
                queue = job.queue or None
                job.unset_pod_group()
                self._touch_job(job)
                if job_terminated(job):
                    del self.jobs[key]
                    self._pooled_jobs.pop(key, None)
                    self._mem_pool_refresh_locked()
                else:
                    self.deleted_jobs.append(job)
            if runs is not None:
                runs.note(_DELETE, "delete_pod_group", start,
                          time.perf_counter())
        if job is not None:
            self._note_churn(queue)

    def add_queue(self, queue) -> None:
        self._ingest_queue(queue, "add_queue")

    def update_queue(self, old_queue, new_queue) -> None:
        self._ingest_queue(new_queue, "update_queue")

    def _ingest_queue(self, queue, handler: str) -> None:
        q = queue if isinstance(queue, Queue) else queue_from_versioned(queue)
        with self.mutex:
            runs = self._runs
            start = time.perf_counter() if runs is not None else 0.0
            self.queues[q.metadata.name] = q
            self._snap_full_invalidate()
            if runs is not None:
                runs.note(_INGEST, handler, start, time.perf_counter())
        self._note_churn(q.metadata.name)

    def delete_queue(self, queue) -> None:
        name = queue.metadata.name if hasattr(queue, "metadata") else str(queue)
        with self.mutex:
            runs = self._runs
            start = time.perf_counter() if runs is not None else 0.0
            self.queues.pop(name, None)
            self._snap_full_invalidate()
            if runs is not None:
                runs.note(_DELETE, "delete_queue", start, time.perf_counter())
        self._note_churn(name)

    def add_pdb(self, pdb) -> None:
        """Legacy gang source; PDB jobs land in the default queue
        (event_handlers.go:664-681)."""
        self._ingest_pdb(pdb, "add_pdb")

    def update_pdb(self, old_pdb, new_pdb) -> None:
        self._ingest_pdb(new_pdb, "update_pdb")

    def _ingest_pdb(self, pdb, handler: str) -> None:
        key = f"{pdb.metadata.namespace}/{pdb.metadata.name}"
        with self.mutex:
            runs = self._runs
            start = time.perf_counter() if runs is not None else 0.0
            self.epoch += 1
            if key not in self.jobs:
                self.jobs[key] = JobInfo(key)
                self._stamp_seq(self.jobs[key])
            job = self.jobs[key]
            job.set_pdb(pdb)
            job.queue = self.default_queue
            self._touch_job(job)
            if runs is not None:
                runs.note(_INGEST, handler, start, time.perf_counter())
        self._note_churn(self.default_queue)

    def delete_pdb(self, pdb) -> None:
        key = f"{pdb.metadata.namespace}/{pdb.metadata.name}"
        with self.mutex:
            runs = self._runs
            start = time.perf_counter() if runs is not None else 0.0
            self.epoch += 1
            job = self.jobs.get(key)
            if job is not None:
                queue = job.queue or None
                job.unset_pdb()
                self._touch_job(job)
                if job_terminated(job):
                    del self.jobs[key]
                    self._pooled_jobs.pop(key, None)
                    self._mem_pool_refresh_locked()
                else:
                    self.deleted_jobs.append(job)
            if runs is not None:
                runs.note(_DELETE, "delete_pdb", start, time.perf_counter())
        if job is not None:
            self._note_churn(queue)

    def add_priority_class(self, pc) -> None:
        if not self.priority_class_enabled:
            return
        with self.mutex:
            runs = self._runs
            start = time.perf_counter() if runs is not None else 0.0
            self.priority_classes[pc.metadata.name] = pc
            if pc.global_default:
                self.default_priority_class = pc
            self._snap_full_invalidate()
            if runs is not None:
                runs.note(_INGEST, "add_priority_class", start,
                          time.perf_counter())
        # PriorityClass changes alter job priorities without bumping any
        # job epoch (snapshot() re-resolves priority every cycle), so
        # the wake is the only thing making the loop react before the
        # period floor.
        self._note_churn()

    def delete_priority_class(self, pc) -> None:
        with self.mutex:
            runs = self._runs
            start = time.perf_counter() if runs is not None else 0.0
            self.priority_classes.pop(pc.metadata.name, None)
            if (self.default_priority_class is not None
                    and self.default_priority_class.metadata.name
                    == pc.metadata.name):
                self.default_priority_class = None
            self._snap_full_invalidate()
            if runs is not None:
                runs.note(_DELETE, "delete_priority_class", start,
                          time.perf_counter())
        self._note_churn()

    # ------------------------------------------------------------------
    # snapshot (cache.go:627-683)

    def snapshot(self) -> ClusterInfo:
        """Clone the cluster state for one session (cache.go:627-683).

        Incremental, twice over: clones from the previous cycle are
        pooled and reused when (a) the informers have not touched the
        object since it was cloned (``mod_epoch`` match) and (b) the
        previous session did not mutate the clone (sessions call
        discard_pooled_* the moment they touch one) — and the WALK itself
        is O(dirty): the generation-keyed snapshot map (_SnapState) keeps
        the previous ClusterInfo entries in truth order, so a steady
        cycle revalidates only the objects in the dirty sets instead of
        re-checking every pooled entry.  Queue/PriorityClass changes and
        the periodic full-session floor force the full walk, which is
        also the KUBE_BATCH_TPU_INCREMENTAL=0 control (bit-identical
        dicts and events either way — the churn parity gate pins it)."""
        from ..models.incremental import incremental_enabled

        flush = self.mirror_flush
        if flush is not None:  # before mutex: flush re-enters ingestion
            flush()
        with self.mutex:
            st = self._snap_state
            if not incremental_enabled():
                # Control arm: drop any map so a later re-enable starts
                # from a fresh full walk instead of a stale baseline.
                self._snap_state = None
                info = self._snapshot_full_locked(None)
            elif st is None or not st.valid or st.full:
                if st is None:
                    st = self._snap_state = _SnapState()
                info = self._snapshot_full_locked(st)
            else:
                info = self._snapshot_incremental_locked(st)
            # The walk above is the pool's only GROWTH chokepoint
            # (_clone_job_locked and the node loops insert); re-price
            # once per snapshot instead of per insert.
            self._mem_pool_refresh_locked()
        return info

    def _clone_job_locked(self, uid: str, job: JobInfo) -> JobInfo:  # holds-lock: mutex
        """One job's session clone: pooled when epoch-clean, else a fresh
        snapshot_clone; priority re-resolved from PriorityClasses (the
        incremental walk only reaches here for dirty jobs — PriorityClass
        changes force the full walk, so clean clones' priorities hold)."""
        pooled_j = self._pooled_jobs
        entry = pooled_j.get(uid)
        if entry is not None and entry[0] == job.mod_epoch:
            clone = entry[1]
        else:
            clone = job.snapshot_clone()
            # Epoch captured HERE, under the mutex: tensorization must
            # key its caches on the truth state this clone reflects, not
            # on live truth a reflector thread may have already moved
            # past (TOCTOU).
            clone.snap_epoch = job.mod_epoch
            pooled_j[uid] = (job.mod_epoch, clone)
        if clone.pod_group is not None:
            pc_name = clone.pod_group.spec.priority_class_name
            if self.default_priority_class is not None:
                clone.priority = self.default_priority_class.value
            pc = self.priority_classes.get(pc_name)
            if pc is not None:
                clone.priority = pc.value
        return clone

    def _snapshot_full_locked(self, st) -> ClusterInfo:  # holds-lock: mutex
        """The reference full walk (the INCREMENTAL=0 control), doubling
        as the map (re)build when ``st`` is given."""
        info = ClusterInfo()
        pooled_n = self._pooled_nodes
        if st is not None:
            st.no_spec.clear()
        for name, node in self.nodes.items():
            if not node.ready():
                continue  # OutOfSync/NotReady nodes excluded (cache.go:638-643)
            entry = pooled_n.get(name)
            if entry is not None and entry[0] == node.mod_epoch:
                info.nodes[name] = entry[1]
            else:
                clone = node.snapshot_clone()
                clone.snap_epoch = node.mod_epoch  # see _clone_job_locked
                pooled_n[name] = (node.mod_epoch, clone)
                info.nodes[name] = clone
        for name, queue in self.queues.items():
            info.queues[name] = QueueInfo(queue)
        for uid, job in self.jobs.items():
            # Jobs without a scheduling spec (PodGroup or legacy PDB)
            # are skipped (cache.go:650-656).
            if job.pod_group is None and job.pdb is None:
                self.events.append(
                    ("FailedScheduling", uid, "job without PodGroup"))
                if st is not None:
                    st.no_spec[uid] = self._obj_seq_of(job)
                continue
            # Jobs whose queue is missing are skipped (cache.go:658-662).
            if job.queue not in info.queues:
                continue
            info.jobs[uid] = self._clone_job_locked(uid, job)
        walked = len(self.nodes) + len(self.jobs)
        metrics.set_snapshot_objects(walked, 0)
        if st is not None:
            st.jobs = dict(info.jobs)
            st.nodes = dict(info.nodes)
            st.jobs_seq = {uid: self._obj_seq_of(self.jobs[uid])
                           for uid in info.jobs}
            st.nodes_seq = {name: self._obj_seq_of(self.nodes[name])
                            for name in info.nodes}
            st.job_hw = self._obj_seq
            st.node_hw = self._obj_seq
            st.dirty_jobs.clear()
            st.dirty_nodes.clear()
            st.valid = True
            st.full = False
            st.recloned_jobs = set(info.jobs)
            st.close_walk_all = True
            self._agg_rebuild_locked(st, info.nodes)
        return info

    def _agg_rebuild_locked(self, st, nodes: Dict) -> None:  # holds-lock: mutex
        """Node-open aggregates from scratch (the full-walk path): the
        exact-int total-allocatable sum and the quantized grid entries —
        vectorized like plugins/nodeorder.GridUsage (column quantization
        is value-identical to per-value quantize_value)."""
        import numpy as np

        from ..models.incremental import resource_exact
        from ..ops.resources import quantize_columns

        total = {"cpu": 0.0, "mem": 0.0, "sc": {}}
        exact = True
        names = list(nodes)
        clones = list(nodes.values())
        for clone in clones:
            al = clone.allocatable
            if exact and not resource_exact(al):
                exact = False
            total["cpu"] += al.milli_cpu
            total["mem"] += al.memory
            if al.scalar_resources:
                sc = total["sc"]
                for k, v in al.scalar_resources.items():
                    sc[k] = sc.get(k, 0.0) + v
        if names:
            arr = np.empty((len(names), 2), np.float64)
            arr[:, 0] = [c.allocatable.milli_cpu for c in clones]
            arr[:, 1] = [c.allocatable.memory for c in clones]
            caps = quantize_columns(arr)
            arr[:, 0] = [c.used.milli_cpu for c in clones]
            arr[:, 1] = [c.used.memory for c in clones]
            useds = quantize_columns(arr)
            st.grid_cap = {n: (int(c), int(m)) for n, (c, m)
                           in zip(names, caps.tolist())}
            st.grid_used = {n: (int(c), int(m)) for n, (c, m)
                            in zip(names, useds.tolist())}
        else:
            st.grid_cap = {}
            st.grid_used = {}
        st.grid_max = None
        st.agg_total = total if exact else None
        st.agg_valid = True

    def _agg_apply_locked(self, st, name: str, old, new) -> None:  # holds-lock: mutex
        """Apply one map-entry change (old clone -> new clone, either
        side None) to the node-open aggregates.  Exact by the integer
        gate: removing a previously-added integer value and adding the
        replacement reassociates nothing a fresh sum would not."""
        if not st.agg_valid or old is new:
            return
        from ..models.incremental import resource_exact
        from ..ops.resources import quantize_value

        t = st.agg_total
        if t is not None:
            for clone, sign in ((old, -1.0), (new, 1.0)):
                if clone is None:
                    continue
                al = clone.allocatable
                if not resource_exact(al):
                    st.agg_total = t = None
                    break
                t["cpu"] += sign * al.milli_cpu
                t["mem"] += sign * al.memory
                if al.scalar_resources:
                    sc = t["sc"]
                    for k, v in al.scalar_resources.items():
                        sc[k] = sc.get(k, 0.0) + sign * v
        if new is None:
            old_cap = st.grid_cap.pop(name, None)
            st.grid_used.pop(name, None)
            if (old_cap is not None and st.grid_max is not None
                    and (old_cap[0] >= st.grid_max[0]
                         or old_cap[1] >= st.grid_max[1])):
                st.grid_max = None  # a component max may have shrunk
            return
        cap = (quantize_value(new.allocatable.milli_cpu, 0),
               quantize_value(new.allocatable.memory, 1))
        old_cap = st.grid_cap.get(name)
        st.grid_cap[name] = cap
        st.grid_used[name] = (quantize_value(new.used.milli_cpu, 0),
                              quantize_value(new.used.memory, 1))
        if st.grid_max is not None:
            if (old_cap is not None
                    and (old_cap[0] >= st.grid_max[0]
                         or old_cap[1] >= st.grid_max[1])
                    and (cap[0] < old_cap[0] or cap[1] < old_cap[1])):
                st.grid_max = None
            else:
                st.grid_max = (max(st.grid_max[0], cap[0]),
                               max(st.grid_max[1], cap[1]))

    def node_open_aggregates(self):
        """(total_allocatable | None, grid_cap, grid_used, shift) for
        the session the latest snapshot produced, or None when the map
        is cold / the control arm runs.  Dicts are fresh copies (the
        nodeorder GridUsage mutates its ``used`` live); the total is a
        private Resource.  total is None — with the grids still served —
        when some allocatable dimension is fractional (the exactness
        gate; callers keep their own walk for the total then)."""
        from ..api.resource import Resource
        from ..models.incremental import incremental_enabled
        from ..ops.resources import score_shift_for

        if not incremental_enabled():
            return None
        with self.mutex:
            st = self._snap_state
            if st is None or not st.agg_valid:
                return None
            if st.grid_max is None:
                st.grid_max = (
                    max((c[0] for c in st.grid_cap.values()), default=0),
                    max((c[1] for c in st.grid_cap.values()), default=0))
            shift = (score_shift_for(st.grid_max[0]),
                     score_shift_for(st.grid_max[1]))
            total = None
            if st.agg_total is not None:
                total = Resource.__new__(Resource)
                total.milli_cpu = st.agg_total["cpu"]
                total.memory = st.agg_total["mem"]
                total.scalar_resources = dict(st.agg_total["sc"])
                total.max_task_num = 0
            return total, dict(st.grid_cap), dict(st.grid_used), shift

    @staticmethod
    def _snap_insert(target: Dict, seqmap: Dict, hw: int,
                     inserts: List[tuple]) -> int:
        """Insert (seq, key, value) rows into an order-kept map: appends
        when every new seq tops the high-water mark (the steady case —
        fresh truth insertions), otherwise one seq-sort rebuild (re-ready
        node / job regaining its spec)."""
        if not inserts:
            return hw
        inserts.sort()
        if inserts[0][0] > hw:
            for seq, key, value in inserts:
                target[key] = value
                seqmap[key] = seq
            return inserts[-1][0]
        items = sorted(
            [(seqmap[k], k, v) for k, v in target.items()]
            + inserts)
        target.clear()
        seqmap.clear()
        for seq, key, value in items:
            target[key] = value
            seqmap[key] = seq
        return items[-1][0] if items else -1

    def _snapshot_incremental_locked(self, st) -> ClusterInfo:  # holds-lock: mutex
        """O(dirty) walk: revalidate exactly the objects whose epoch
        moved (or whose clone the last session mutated), splice them into
        the order-kept map, and replay the per-walk no-spec events."""
        info = ClusterInfo()
        walked = 0

        inserts: List[tuple] = []
        for name in st.dirty_nodes:
            walked += 1
            old = st.nodes.get(name)
            node = self.nodes.get(name)
            if node is None or not node.ready():
                st.nodes.pop(name, None)
                st.nodes_seq.pop(name, None)
                if old is not None:
                    self._agg_apply_locked(st, name, old, None)
                continue
            entry = self._pooled_nodes.get(name)
            if entry is not None and entry[0] == node.mod_epoch:
                clone = entry[1]
            else:
                clone = node.snapshot_clone()
                clone.snap_epoch = node.mod_epoch
                self._pooled_nodes[name] = (node.mod_epoch, clone)
            self._agg_apply_locked(st, name, old, clone)
            seq = self._obj_seq_of(node)
            if st.nodes_seq.get(name) == seq:
                st.nodes[name] = clone  # same position, new value
            else:
                st.nodes.pop(name, None)
                st.nodes_seq.pop(name, None)
                inserts.append((seq, name, clone))
        st.node_hw = self._snap_insert(st.nodes, st.nodes_seq, st.node_hw,
                                       inserts)
        st.dirty_nodes.clear()

        for name, queue in self.queues.items():
            info.queues[name] = QueueInfo(queue)

        # recloned accumulates across walks and is consumed per close
        # (note_close_results): with the global engine every close
        # consumes the whole set (bit-identical to the old wholesale
        # replace); with the tenancy engine each shard's close consumes
        # only its own jobs, so a fresh clone of shard B's job survives
        # shard A's intervening snapshot/close pair.
        inserts = []
        for uid in st.dirty_jobs:
            walked += 1
            job = self.jobs.get(uid)
            if job is None:
                st.jobs.pop(uid, None)
                st.jobs_seq.pop(uid, None)
                st.no_spec.pop(uid, None)
                st.recloned_jobs.discard(uid)
                continue
            if job.pod_group is None and job.pdb is None:
                st.jobs.pop(uid, None)
                st.jobs_seq.pop(uid, None)
                st.no_spec[uid] = self._obj_seq_of(job)
                st.recloned_jobs.discard(uid)
                continue
            st.no_spec.pop(uid, None)
            if job.queue not in info.queues:
                st.jobs.pop(uid, None)
                st.jobs_seq.pop(uid, None)
                st.recloned_jobs.discard(uid)
                continue
            clone = self._clone_job_locked(uid, job)
            st.recloned_jobs.add(uid)
            seq = self._obj_seq_of(job)
            if st.jobs_seq.get(uid) == seq:
                st.jobs[uid] = clone
            else:
                st.jobs.pop(uid, None)
                st.jobs_seq.pop(uid, None)
                inserts.append((seq, uid, clone))
        st.job_hw = self._snap_insert(st.jobs, st.jobs_seq, st.job_hw,
                                      inserts)
        st.dirty_jobs.clear()
        st.close_walk_all = False

        # The control emits one FailedScheduling event per spec-less job
        # on EVERY walk, in truth order — replay for event bit-parity.
        if st.no_spec:
            for uid, _seq in sorted(st.no_spec.items(),
                                    key=lambda kv: kv[1]):
                self.events.append(
                    ("FailedScheduling", uid, "job without PodGroup"))

        info.nodes = dict(st.nodes)
        info.jobs = dict(st.jobs)
        metrics.set_snapshot_objects(
            walked, len(info.nodes) + len(info.jobs) + len(st.no_spec))
        return info

    # ------------------------------------------------------------------
    # close_session bookkeeping (shared with the tenancy ShardView)

    def close_plan(self):
        """close_session's O(touched) walk plan: (active, recloned,
        seqmap), or None when the whole-session walk must run (first
        session, full snapshot, control arm).  See _SnapState."""
        with self.mutex:
            st = self._snap_state
            if st is None or st.close_walk_all:
                return None
            return (set(st.close_active), set(st.recloned_jobs),
                    dict(st.jobs_seq))

    def note_close_results(self, active: set, universe=None) -> None:
        """Record which jobs' close outcome was NOT provably silent —
        the re-process set for the next incremental close.

        ``universe`` scopes the result to the jobs this close actually
        walked (the tenancy ShardView's shard slice): verdicts for jobs
        OUTSIDE the universe are preserved instead of replaced, so one
        shard's close cannot clear another shard's active flags.  None
        (the global engine) replaces wholesale, the pre-tenancy
        behavior.  Either way, the walked jobs' pending fresh-reclone
        marks are consumed (see _snapshot_incremental_locked)."""
        with self.mutex:
            st = self._snap_state
            if st is None:
                return
            if universe is None:
                st.close_active = set(active)
                st.recloned_jobs.clear()
            else:
                scope = set(universe)
                st.close_active = (st.close_active - scope) | set(active)
                st.recloned_jobs -= scope

    # ------------------------------------------------------------------
    # effectors (cache.go:425-535)

    def _fence_lost(self) -> bool:
        return self.write_fence is not None and not self.write_fence()

    def _check_write_fence(self) -> None:
        if self._fence_lost():
            raise RuntimeError(
                "leadership lost: refusing cluster write (a standby may "
                "already be leading)")

    def _binder_bind(self, pod, hostname: str) -> None:
        """One bind through the effector, with the chaos engine's egress
        fault sites threaded in (doc/CHAOS.md sites ``bind.timeout``,
        ``bind.http5xx``, ``bind.ambiguous``) — a single no-op branch
        when the chaos engine is off."""
        plan = chaos_plan.PLAN
        if plan is None:
            self.binder.bind(pod, hostname)
            return
        if plan.fire("bind.timeout"):
            raise TimeoutError(
                "chaos: bind request timed out before send (injected)")
        if plan.fire("bind.http5xx"):
            raise KeyError("chaos: POST bind: 503 injected")
        ambiguous = plan.fire("bind.ambiguous")
        self.binder.bind(pod, hostname)
        if ambiguous is not None:
            # The bind LANDED server-side; the caller only sees a dead
            # connection — the landed-or-not ambiguity the resync
            # machinery must repair without a blind re-POST.
            raise AmbiguousOutcomeError(
                "chaos: connection lost after the bind POST was "
                "delivered (injected)")

    def _bind_with_backoff(self, pod, hostname: str) -> None:
        """Single-bind form of the egress retry policy (see module
        constants): bounded exponential backoff with jitter for
        transient, unambiguous failures; ambiguous outcomes propagate
        immediately (never re-POST)."""
        retries = _bind_retries()
        delay = _BIND_BACKOFF_BASE_S
        for attempt in range(retries + 1):
            try:
                self._binder_bind(pod, hostname)
                return
            except Exception as exc:
                if attempt >= retries or not _retryable_bind_error(exc):
                    raise
                metrics.note_bind_retry()
                delay = _backoff_sleep(delay)

    def _assume_bound_many(self, tasks, hostname: Optional[str] = None
                           ) -> None:
        """Mirror our own successful binds into cache truth AHEAD of the
        watch echo (kube-scheduler's assume semantics).  On a remote edge
        the echo lags the POST; until it lands, snapshots would still see
        a pod Pending, and the next session would re-place it — a
        duplicate (409-rejected) Binding POST at best, a double-bind at
        worst.  Each cached task is replaced by a copy bound to its node
        (``hostname``, or the task's own ``node_name`` when None), the
        state the echo's update path will leave, so the echo itself is an
        idempotent replacement.  A task whose echo already landed, as it
        always has on the in-process cluster, or that is gone, is skipped.

        One mutex acquisition and one epoch bump for the batch.  The end
        state is the one the task-by-task delete and re-add
        (``_delete_task``, ``_task_info``, ``_add_task``) leaves in batch
        order, dict orders, events and every bit included, without its
        per-task work:

        - no re-parse: the bound task is the cached one's ``clone_lite``
          (its request vectors come from containers a bind does not
          change) with the stamped pod, its status and its node;
        - a fused job move: out of its status bucket, to the end of
          ``tasks`` and of its new bucket, as delete and re-add leave it;
          ``total_request`` keeps its value and ``allocated`` grows once
          per job (``_settle_moved``);
        - each node's ``idle``, ``used`` and ``releasing`` move once, by
          the sum of its new tasks, where that sum fits ``idle``
          (``_mirror_node``).

        Sums stand in for steps only where they give the same bits
        (``assume.exact_sum``).  Otherwise, and for a task already allocated
        or whose job has no gang source (its delete may drop the job),
        the task-by-task steps run, in batch order, ``FailedAddTask``
        events included."""
        slow: set = set()             # uids that took a per-task step
        moved: Dict[JobInfo, list] = {}   # job -> its fused tasks
        groups: Dict[str, list] = {}      # node -> its new tasks
        on_nodes: list = []               # every node's new tasks, in order

        def step_job(job, cached, bound):
            self._assume_exact(job, cached, bound, moved, slow)  # lint: disable=lock-discipline (only the walk below calls it, under the mutex)

        with self.mutex:
            self.epoch += 1
            mirrored, skipped = assume_walk(
                self.jobs, self.nodes, tasks, hostname, moved, groups,
                on_nodes, step_job, self._placeholder_node)
            if not mirrored:
                self.epoch -= 1  # nothing was stamped with it
            for job, fused in moved.items():
                self._settle_moved(job, fused, slow)
            nodes = self.nodes
            stepped = {host for host, group in groups.items()
                       if not self._mirror_node(nodes[host], host, group)}
            if stepped:
                for bound in on_nodes:
                    if bound.node_name in stepped:
                        slow.add(bound.uid)
                        self._node_add(nodes[bound.node_name], bound)
        metrics.note_assume_mirrored(mirrored - len(slow), len(slow),
                                     skipped)

    def _assume_exact(self, job, cached, bound, moved, slow):  # holds-lock: mutex
        """The job side of one bound task, step by step as the informer
        handlers take it: for a task already allocated, or whose job has
        no gang source, so that its delete may drop the job.  The job's
        fused tasks before it are settled first, keeping the order of
        its vector steps."""
        fused = moved.pop(job, None)
        if fused is not None:
            self._settle_moved(job, fused, slow)
        self._delete_task(cached)
        home = self._get_or_create_job(bound)
        if home is not None:
            home.add_task_info(bound)
            self._touch_job(home)
        slow.add(bound.uid)

    def _settle_moved(self, job, fused, slow) -> None:  # holds-lock: mutex
        """The job vectors' part of ``fused``, the job's tasks the
        assume mirror moved to their bound copies: ``total_request`` is
        unchanged by each task's delete and re-add, and ``allocated``
        grows by the newly allocated requests, each by their sum where
        that gives the steps' bits, else step by step in batch order."""
        job._ready_num = None
        total = exact_sum(fused)
        summed = total is not None and exact(job.total_request)
        if not summed:
            for t in fused:
                job.total_request.sub(t.resreq)
                job.total_request.add(t.resreq)
        alloc = [t for t in fused if allocated_status(t.status)]
        if alloc:
            if summed and exact(job.allocated):
                job.allocated.add(total if len(alloc) == len(fused)
                                  else exact_sum(alloc))
            else:
                summed = False
                for t in alloc:
                    job.allocated.add(t.resreq)
        if not summed:
            slow.update(t.uid for t in fused)
        self._touch_job(job)

    def _mirror_node(self, node, host, group) -> bool:  # holds-lock: mutex
        """``node.add_task`` of each task of ``group`` with the vectors
        moved once, or False, leaving the node untouched, where that
        would not give the steps' end state: a node without its API
        object or of another name, a pod key already on the node or
        twice in the group, a request that ``exact_sum`` refuses,
        vectors that are not ``exact``, or a sum that does not fit
        ``idle``.  Each step checks that its task fits what the ones
        before left (``less_equal``, with its tolerance); with exact
        non-negative parts the last step's check is the sum's, and it
        implies the others'.  No bound task is Pipelined
        (``get_task_status``), so each takes from ``idle``; the
        Releasing ones add to ``releasing`` too."""
        if node.node is None or node.name != host:
            return False
        sums = group_sums(node.tasks, group)
        if sums is None:
            return False
        total, releasing = sums
        if (not exact(total) or not exact(node.idle)
                or not exact(node.used) or not total.less_equal(node.idle)):
            return False
        if releasing is not None:
            if not exact(node.releasing):
                return False
            node.releasing.add(releasing)
        node.idle.sub_lenient(total)
        node.used.add(total)
        insert_clones(node.tasks, group)
        self._touch_node(node)
        return True

    def _lineage_bound(self, tasks, source: str) -> None:
        """Bind egress proven for ``tasks``: resolve queues under the
        mutex in one pass, then hand the whole batch to the lineage
        recorder (one recorder-lock acquisition, trace/lineage.py)."""
        if not pod_lineage.cfg().enabled:
            return
        with self.mutex:
            pairs = [(pod_key(t.pod),
                      job.queue if (job := self.jobs.get(t.job)) is not None
                      else "")
                     for t in tasks]
        pod_lineage.note_bound_many(pairs, source=source)

    def bind(self, task: TaskInfo, hostname: str) -> None:
        """Delegate to the Binder; revert task status and queue a resync on
        failure (cache.go:491-535)."""
        if self.binder is None:
            raise RuntimeError("no binder configured")
        self._check_write_fence()
        pod_lineage.note_bind_sent((pod_key(task.pod),))
        try:
            self._bind_with_backoff(task.pod, hostname)
            self._assume_bound_many((task,), hostname)
            self._lineage_bound((task,), "bind")
            self.events.append(("Scheduled", pod_key(task.pod), hostname))
        except AmbiguousOutcomeError:
            # Delivered but unproven: don't guess — the resync worker
            # refetches ground truth and repairs whichever way it landed
            # (cache.go:602-624), before the next cycle can re-place.
            metrics.note_bind_ambiguous("unproven")
            self._resync_task(task)
            raise
        except Exception:
            self._resync_task(task)
            raise

    def _bind_many(self, pairs) -> list:
        """binder.bind_many, or — when a chaos plan is active — a
        per-bind loop through the instrumented single-bind path so the
        egress fault sites see every bind (outcome-equivalent: bind_many
        is per-task isolated either way)."""
        if chaos_plan.PLAN is None:
            return self.binder.bind_many(pairs)
        failures = []
        for pod, hostname in pairs:
            try:
                self._binder_bind(pod, hostname)
            except Exception as exc:  # per-task failure isolation
                failures.append((pod, hostname, exc))
        return failures

    def bind_batch(self, tasks: List[TaskInfo]) -> None:
        """Bulk bind with per-task failure isolation: failed tasks queue a
        resync exactly as bind() does; the rest proceed (the reference's
        per-bind goroutines give the same isolation).  Transient failures
        retry in bounded backoff waves; ambiguous outcomes never retry
        and always resync (doc/CHAOS.md)."""
        if self.binder is None:
            raise RuntimeError("no binder configured")
        self._check_write_fence()
        with trace.span("cache.lineage"):
            if pod_lineage.cfg().enabled:
                pod_lineage.note_bind_sent([pod_key(t.pod) for t in tasks])
        with trace.span("cache.bind"):
            pending = [(t.pod, t.node_name) for t in tasks]
            retries = _bind_retries()
            delay = _BIND_BACKOFF_BASE_S
            ambiguous: list = []
            final_failures: list = []
            for attempt in range(retries + 1):
                failures = self._bind_many(pending)
                retryable = []
                for pod, hostname, exc in failures:
                    if isinstance(exc, AmbiguousOutcomeError):
                        ambiguous.append((pod, hostname, exc))
                    elif _retryable_bind_error(exc):
                        retryable.append((pod, hostname, exc))
                    else:
                        final_failures.append((pod, hostname, exc))
                if not retryable or attempt >= retries:
                    final_failures.extend(retryable)
                    break
                metrics.note_bind_retry()
                delay = _backoff_sleep(delay)
                pending = [(pod, hostname) for pod, hostname, _ in retryable]
        failed_uids = set()
        for pod, _hostname, _exc in ambiguous:
            metrics.note_bind_ambiguous("unproven")
            failed_uids.add(pod.metadata.uid)
        for pod, _hostname, _exc in final_failures:
            failed_uids.add(pod.metadata.uid)
        landed = tasks
        with trace.span("cache.assume"):
            if failed_uids:
                landed = []
                for t in tasks:
                    if t.uid in failed_uids:
                        self._resync_task(t)
                    else:
                        landed.append(t)
            self._assume_bound_many(landed)
            # One bulk event write for the batch.
            self.events.extend(("Scheduled", pod_key(t.pod), t.node_name)
                               for t in landed)
        if landed:
            with trace.span("cache.lineage"):
                self._lineage_bound(landed, "bind")

    def evict(self, task: TaskInfo, reason: str) -> None:
        """Delegate to the Evictor (cache.go:425-488)."""
        if self.evictor is None:
            raise RuntimeError("no evictor configured")
        self._check_write_fence()
        # Resolve the job under the mutex: the evict runs on the scheduler
        # thread while reflector callbacks mutate self.jobs (found by
        # graftlint's guarded-by check).
        with self.mutex:
            job = self.jobs.get(task.job)
        try:
            # Chaos sites (doc/CHAOS.md): ``evict.error`` fails before
            # the DELETE is sent; ``evict.ambiguous`` lets it land and
            # then drops the connection — the resync worker must observe
            # the pod already gone and reconcile (no eviction is ever
            # lost or double-guessed).  No-op branch when chaos is off.
            plan = chaos_plan.PLAN
            ambiguous = None
            if plan is not None:
                if plan.fire("evict.error"):
                    raise OSError(
                        "chaos: evict DELETE failed before send (injected)")
                ambiguous = plan.fire("evict.ambiguous")
            self.evictor.evict(task.pod)
            if ambiguous is not None:
                raise AmbiguousOutcomeError(
                    "chaos: connection lost after the evict DELETE was "
                    "delivered (injected)")
            pod_lineage.note_evicted(pod_key(task.pod), reason)
            self.events.append(("Evict", pod_key(task.pod), reason))
        except Exception:
            self._resync_task(task)
            raise
        # Mirror cluster-side status transition (cache.go:447-459).
        with self.mutex:
            if job is not None and task.uid in job.tasks:
                self.epoch += 1
                job.update_task_status(job.tasks[task.uid], TaskStatus.Releasing)
                self._touch_job(job)
                node = self.nodes.get(task.node_name)
                if node is not None:
                    self._touch_node(node)
                    try:
                        node.update_task(job.tasks[task.uid])
                    except (KeyError, ValueError):
                        pass

    def evict_many(self, pairs) -> list:
        """Bulk evict [(task, reason)] — the batched commit flush's
        fused cache update (doc/EVICTION.md "Batched commit"): one
        fence check, one bulk egress (evictor.evict_many, the
        bind_pods_many twin), ONE mutex acquisition for the whole truth
        mirror, one events extend, and one lineage batch, instead of
        the per-task round-trip evict() pays.  Event content and order
        equal the sequential loop's — pairs are egressed and mirrored
        in decision order.

        Chaos sites (doc/CHAOS.md): ``commit.flush_error`` aborts the
        bulk egress mid-batch (one activation per flush; the magnitude
        picks the abort point), so the suffix fails wholesale — the
        caller's degradation path re-drives it per task.  With any plan
        active the egress runs per task through the instrumented
        single-evict sites (``evict.error``/``evict.ambiguous``) so
        existing fault schedules see every evict.

        Returns [(task, reason, exc)] failures, in order, not mirrored.
        AMBIGUOUS failures are resync-queued here (they must never be
        blindly re-driven); other failures are the caller's to drive —
        the commit flush retries them through the per-task evict(),
        which queues its own resync on failure, so each failed effect
        is queued exactly once."""
        pairs = list(pairs)
        if not pairs:
            return []
        if self.evictor is None:
            raise RuntimeError("no evictor configured")
        self._check_write_fence()
        plan = chaos_plan.PLAN
        results: List[tuple] = []  # (task, reason, exc | None)
        if plan is None:
            failures = self.evictor.evict_many([t.pod for t, _ in pairs])
            failed_uid = {pod.metadata.uid: exc for pod, exc in failures}
            results = [(t, r, failed_uid.get(t.pod.metadata.uid))
                       for t, r in pairs]
        else:
            fault = plan.fire("commit.flush_error")
            abort_at = (int(fault.magnitude * len(pairs))
                        if fault is not None else len(pairs))
            aborted = RuntimeError(
                "chaos: bulk evict egress aborted mid-batch (injected)")
            for i, (t, r) in enumerate(pairs):
                if i >= abort_at:
                    results.append((t, r, aborted))
                    continue
                try:
                    if plan.fire("evict.error"):
                        raise OSError("chaos: evict DELETE failed before "
                                      "send (injected)")
                    ambiguous = plan.fire("evict.ambiguous")
                    self.evictor.evict(t.pod)
                    if ambiguous is not None:
                        raise AmbiguousOutcomeError(
                            "chaos: connection lost after the evict DELETE "
                            "was delivered (injected)")
                except Exception as exc:  # lint: allow-swallow(per-task failure isolation: the exception rides the results row back to the flush's degradation path)
                    results.append((t, r, exc))
                else:
                    results.append((t, r, None))
        landed = [(t, r) for t, r, exc in results if exc is None]
        failures = [(t, r, exc) for t, r, exc in results
                    if exc is not None]
        if landed:
            if pod_lineage.cfg().enabled:
                pod_lineage.note_evicted_many(
                    [(pod_key(t.pod), r) for t, r in landed])
            # One mutex acquisition for the whole truth mirror (the
            # per-task evict() re-acquires per victim), with the fused
            # status-flip fast paths: move_task_status skips the
            # delete/re-add Resource churn (Running -> Releasing is one
            # allocated-vector sub either way), release_resident skips
            # the node-side idle round trip and re-clone.  Both
            # replicate the slow paths' dict-order side effect (the
            # moved task lands at the END of the job/node task dicts —
            # the next snapshot's iteration order depends on it, and
            # iteration order feeds the solver's tie-breaks).
            with self.mutex:
                self.epoch += 1
                for t, _r in landed:
                    job = self.jobs.get(t.job)
                    if job is None:
                        continue
                    truth = job.tasks.get(t.uid)
                    if truth is None:
                        continue
                    job.move_task_status(truth, TaskStatus.Releasing)
                    del job.tasks[truth.uid]
                    job.tasks[truth.uid] = truth
                    self._touch_job(job)
                    node = self.nodes.get(t.node_name)
                    if node is not None:
                        self._touch_node(node)
                        try:
                            node.release_resident(truth)
                        except (KeyError, ValueError):
                            pass
            self.events.extend(("Evict", pod_key(t.pod), r)
                               for t, r in landed)
        ambiguous_failures = [t for t, _r, exc in failures
                              if isinstance(exc, AmbiguousOutcomeError)]
        if ambiguous_failures:
            with self.mutex:
                self.err_tasks.extend(ambiguous_failures)
        return failures

    def _resync_task(self, task: TaskInfo) -> None:
        with self.mutex:
            self.err_tasks.append(task)

    def process_resync_tasks(self, cluster=None) -> None:
        """Drain the error queue against the cluster's ground truth
        (cache.go:602-611 processResyncTask).  Pops run under the mutex;
        the (possibly remote) ground-truth fetch and the resync itself run
        outside it — sync_task re-acquires, and holding the mutex across a
        network read would stall every informer callback."""
        while True:
            with self.mutex:
                if not self.err_tasks:
                    return
                task = self.err_tasks.pop()
            try:
                cluster_pod = cluster.get_pod(task.namespace, task.name) \
                    if cluster is not None else None
            except Exception:
                # Ground truth unreachable: re-queue and retry next
                # period — dropping the task would leave the failed
                # effect unrepaired forever (and the rest of the queue
                # faces the same dead edge right now).
                with self.mutex:
                    self.err_tasks.append(task)
                metrics.note_swallowed("resync_fetch")
                return
            self.sync_task(task, cluster_pod)

    def process_cleanup_jobs(self) -> None:
        """Drop terminated jobs queued for deletion (cache.go:576-600).
        A pop here is a truth mutation like any other: the incremental
        snapshot map must see it (dirty mark), or it would keep serving
        the removed job until the FULL_EVERY floor."""
        with self.mutex:
            remaining = []
            st = self._snap_state
            for job in self.deleted_jobs:
                if job_terminated(job):
                    self.jobs.pop(job.uid, None)
                    if st is not None:
                        st.dirty_jobs.add(job.uid)
                else:
                    remaining.append(job)
            self.deleted_jobs = remaining

    def update_job_status(self, job: JobInfo) -> JobInfo:
        """Push PodGroup status to the cluster (cache.go:763-775)."""
        try:
            # Fence check inside the try: a lost lease refuses the cluster
            # write but the finally still records the (local, fence-aware)
            # events — they must survive a failed status write.
            self._check_write_fence()
            if self.status_updater is not None and not shadow_pod_group(job.pod_group):
                # Record what we are about to push so its watch echo is
                # not mistaken for external churn (see add_pod_group) —
                # BEFORE the push: on the in-process cluster the
                # informer echo fires synchronously inside it.  A spec
                # change by an external controller carries different
                # spec fields and still wakes the loop; a failed push
                # leaves a fingerprint no echo will ever match... except
                # an identical external write, which is a no-op anyway.
                with self.mutex:
                    truth = self.jobs.get(job.uid)
                    if truth is not None:
                        truth._pushed_status_fp = \
                            self._pg_fingerprint(job.pod_group)
                self.status_updater.update_pod_group(job.pod_group)
        finally:
            # Events + pod conditions must survive a failed status write
            # (e.g. the PodGroup was deleted mid-session): the reference
            # records them regardless of the UpdatePodGroup outcome.
            self.record_job_status_event(job)
        return job

    def record_job_status_event(self, job: JobInfo) -> None:
        """Unschedulable events + pod conditions for stuck tasks
        (cache.go RecordJobStatusEvent)."""
        from ..api.pod_group_info import PodGroupPending, PodGroupUnknown
        job_err = job.fit_error()
        if not shadow_pod_group(job.pod_group):
            pg_unschedulable = job.pod_group is not None and \
                job.pod_group.status.phase in (PodGroupUnknown, PodGroupPending)
            pdb_unschedulable = job.pdb is not None and \
                bool(job.task_status_index.get(TaskStatus.Pending))
            if pg_unschedulable or pdb_unschedulable:
                pending = len(job.task_status_index.get(TaskStatus.Pending, {}))
                self.events.append(
                    ("Unschedulable", job.uid,
                     f"{pending}/{len(job.tasks)} tasks in gang "
                     f"unschedulable: {job_err}"))
        # Pod conditions for Allocated and Pending tasks before the job is
        # discarded (cache.go:754-763).
        for status in (TaskStatus.Allocated, TaskStatus.Pending):
            for task in job.task_status_index.get(status, {}).values():
                self.task_unschedulable(task, job_err)

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        if self.volume_binder is not None:
            self._check_write_fence()
            self.volume_binder.allocate_volumes(task, hostname)

    def bind_volumes(self, task: TaskInfo) -> None:
        if self.volume_binder is not None:
            self._check_write_fence()
            self.volume_binder.bind_volumes(task)

    def task_unschedulable(self, task: TaskInfo, message: str) -> None:
        """Record the pod condition for an unschedulable task
        (cache.go:548-568).

        Never raises: callers (record_job_status_event → close_session)
        treat it as non-failing, so a lost fence skips only the cluster
        write — the local event still records."""
        if self.status_updater is not None and not self._fence_lost():
            self.status_updater.update_pod_condition(
                task.pod, ("PodScheduled", "False", "Unschedulable", message))
        self.events.append(("FailedScheduling", pod_key(task.pod), message))
