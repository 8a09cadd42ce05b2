"""Session: snapshot-backed working state for one scheduling cycle.

Mirrors kube-batch pkg/scheduler/framework/session.go (lifecycle,
Allocate/Pipeline/Evict/dispatch) and session_plugins.go (the tiered decision
combinators: victim-intersection with first-decisive-tier for Preemptable/
Reclaimable, veto-AND for JobReady/JobPipelined/JobValid/Overused,
first-nonzero comparison chains for the order functions, all-tiers AND for
predicates, concatenation for node-order functions).
"""

from __future__ import annotations

import time
import uuid
from typing import Callable, Dict, List, Optional

from ..api import (ClusterInfo, FitError, JobInfo, NodeInfo, QueueInfo,
                   TaskInfo, TaskStatus, ValidateResult, allocated_status,
                   pod_key)
from ..api.node_info import lazy_insert
from ..api.pod_group_info import (PodGroupCondition, PodGroupPending,
                                  PodGroupRunning, PodGroupUnknown,
                                  PodGroupUnschedulableType)
from ..chaos import plan as chaos_plan
from ..metrics import memledger, metrics
from ..native import apply_placements as native_apply
from ..trace import spans as trace
from ..trace.lineage import lineage as pod_lineage
from ..utils.priority_queue import PriorityQueue, SortedDrainQueue
from .events import AllocateBatch, Event, EventHandler
from .interface import Plugin


class Session:
    """One scheduling cycle's working state + plugin callback registries
    (session.go:37-61)."""

    def __init__(self, cache):
        self.uid: str = str(uuid.uuid4())
        self.cache = cache
        # Queue-shard scope (doc/TENANCY.md): the owning shard when this
        # session runs over a tenancy ShardView, else None (the global
        # engine).  Plugins use it to publish shard-SCOPED fairness rows
        # (metrics/tenants.py) instead of wholesale table replaces.
        self.shard = getattr(cache, "shard", None)

        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.tiers: List[Tier] = []

        # Clones this session has mutated: their pooled copies must not be
        # reused by the next snapshot, and tensorization must not serve
        # cached blocks for them (cache.py snapshot / tensor_snapshot.py).
        # The delta-shipping layer (models/shipping.py) relies on these
        # being complete: a mutation that bypasses _dirty_job/_dirty_node
        # would leave the next cycle staging stale rows.
        self.mutated_jobs: set = set()
        self.mutated_nodes: set = set()

        # Cross-action pre-scan results: a pipelined action computes
        # snapshot-derived facts during its device-wait window and later
        # actions consume them instead of re-walking the session (e.g.
        # tpu-allocate answers backfill's BestEffort discovery from the
        # tensorizer's rows).  Entries are valid for this session only.
        self.prescan: Dict[str, object] = {}

        self.plugins: Dict[str, Plugin] = {}
        self.event_handlers: List[EventHandler] = []
        self.job_order_fns: Dict[str, Callable] = {}
        self.queue_order_fns: Dict[str, Callable] = {}
        self.task_order_fns: Dict[str, Callable] = {}
        # Optional static-key forms of task_order_fns: key_fn(task) must
        # sort ascending exactly like the cmp fn.  When EVERY enabled
        # task-order plugin registers one, task_sort_key() lets the
        # actions replace O(n)-scan comparator queues with sorted drains
        # (task keys are immutable within a session).
        self.task_order_key_fns: Dict[str, Callable] = {}
        self.predicate_fns: Dict[str, Callable] = {}
        self.preemptable_fns: Dict[str, Callable] = {}
        self.reclaimable_fns: Dict[str, Callable] = {}
        self.overused_fns: Dict[str, Callable] = {}
        self.job_ready_fns: Dict[str, Callable] = {}
        self.job_pipelined_fns: Dict[str, Callable] = {}
        self.job_valid_fns: Dict[str, Callable] = {}
        self.node_order_fns: Dict[str, List] = {}

        # Batched commit (framework/commit.py): the active per-action
        # effect sink, installed by ``action_commit`` for the duration
        # of one eviction action's execute.  None = the sequential
        # per-task effector path (the KUBE_BATCH_TPU_BATCH_COMMIT=0
        # control, and every action that never evicts).
        self._commit_sink = None
        # Shard-pipeline de-alias hook (tenancy/pipeline.py): called with
        # an iterable of node names BEFORE the first session mutation of
        # each node, so in-flight successor sessions sharing pooled
        # clones can take private copies before the object changes.
        # None outside a pipelined retire (zero overhead: one attribute
        # read per first-touch)  — doc/TENANCY.md "Concurrent
        # micro-sessions".
        self._dirty_node_hook = None
        # Shard-pipeline conflict fence (set by tpu-allocate's begin
        # half): (node_names, feasible_mask) naming the nodes whose state
        # this session's outcome can depend on, or _pipeline_reads_all
        # when the footprint is unbounded (fallback/backfill/volumes) —
        # the pipeline reruns this session when a predecessor mutates
        # inside the footprint.
        self._pipeline_fence = None
        self._pipeline_reads_all = False
        # True only for sessions opened by the shard pipeline's begin
        # half (Scheduler.begin_shard_session): fence derivation is
        # skipped everywhere else, so the sequential control keeps its
        # exact per-session work profile.
        self._pipeline_active = False
        # Set by the pipeline when ANY predecessor committed mutations
        # after this session's snapshot: a retire half that then needs
        # the unbounded host fallback must abort for the sequential
        # rerun instead of reading stale state (StaleSessionAbort).
        self._pipeline_stale = False
        # Per-session commit/apply floor accumulators (published as
        # ``cycle_floor_ms{floor="commit"|"apply"}`` at close): the
        # effect-side wall time — sequential per-task effector calls or
        # batched flushes for commit; the placement apply phase for
        # apply — so storm regressions are attributable in the bench
        # gate (doc/EVICTION.md "Batched commit").
        self._floor_commit = 0.0
        self._floor_apply = 0.0

        # Lazily resolved tier-walk chains for the order comparators:
        # heap-heavy actions (a preemption storm pushes/pops thousands
        # of jobs and tasks) call these per comparison, and the
        # tier x plugin x dict-lookup walk per call dominated them.
        # Registrations are fixed once open_session returns, so the
        # first call freezes the chain.
        self._job_order_chain: Optional[List[Callable]] = None
        self._task_order_chain: Optional[List[Callable]] = None
        self._task_key_fn = False  # False = uncomputed, None = unavailable

    # ------------------------------------------------------------------
    # registration (session_plugins.go:25-77)

    def add_job_order_fn(self, name, fn):
        self.job_order_fns[name] = fn

    def add_queue_order_fn(self, name, fn):
        self.queue_order_fns[name] = fn

    def add_task_order_fn(self, name, fn):
        self.task_order_fns[name] = fn

    def add_task_order_key_fn(self, name, key_fn):
        self.task_order_key_fns[name] = key_fn

    def add_predicate_fn(self, name, fn):
        self.predicate_fns[name] = fn

    def add_preemptable_fn(self, name, fn):
        self.preemptable_fns[name] = fn

    def add_reclaimable_fn(self, name, fn):
        self.reclaimable_fns[name] = fn

    def add_overused_fn(self, name, fn):
        self.overused_fns[name] = fn

    def add_job_ready_fn(self, name, fn):
        self.job_ready_fns[name] = fn

    def add_job_pipelined_fn(self, name, fn):
        self.job_pipelined_fns[name] = fn

    def add_job_valid_fn(self, name, fn):
        self.job_valid_fns[name] = fn

    def add_node_order_fns(self, name, prioritizers):
        """prioritizers: list of (weight, NodeOrderFn)."""
        self.node_order_fns[name] = prioritizers

    def add_event_handler(self, handler: EventHandler):
        self.event_handlers.append(handler)

    # ------------------------------------------------------------------
    # tiered combinators (session_plugins.go:80-369)

    def _victims(self, fns: Dict[str, Callable], flag_attr: str,
                 claimer: TaskInfo, claimees: List[TaskInfo]) -> List[TaskInfo]:
        """Within a tier victims are intersected across plugins; the first
        tier whose intersection is non-None decides (go:80-162; note Go's
        nil-vs-empty distinction: a tier whose plugins all return nil defers
        to the next tier, an empty-but-initialized result decides 'none')."""
        victims: Optional[List[TaskInfo]] = None
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not getattr(plugin, flag_attr):
                    continue
                fn = fns.get(plugin.name)
                if fn is None:
                    continue
                candidates = fn(claimer, claimees)
                if victims is None:
                    victims = candidates if candidates is not None else []
                else:
                    cand_uids = {c.uid for c in (candidates or [])}
                    victims = [v for v in victims if v.uid in cand_uids]
            if victims is not None:
                return victims
        return victims or []

    def preemptable(self, preemptor: TaskInfo, preemptees: List[TaskInfo]):
        return self._victims(self.preemptable_fns, "enabled_preemptable",
                             preemptor, preemptees)

    def reclaimable(self, reclaimer: TaskInfo, reclaimees: List[TaskInfo]):
        return self._victims(self.reclaimable_fns, "enabled_reclaimable",
                             reclaimer, reclaimees)

    def overused(self, queue: QueueInfo) -> bool:
        """Any plugin saying overused wins (go:165-181; note: not gated by an
        enable flag in the reference either)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.overused_fns.get(plugin.name)
                if fn is not None and fn(queue):
                    return True
        return False

    def job_ready(self, job: JobInfo) -> bool:
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_job_ready:
                    continue
                fn = self.job_ready_fns.get(plugin.name)
                if fn is not None and not fn(job):
                    return False
        return True

    def job_pipelined(self, job: JobInfo) -> bool:
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_job_pipelined:
                    continue
                fn = self.job_pipelined_fns.get(plugin.name)
                if fn is not None and not fn(job):
                    return False
        return True

    def job_valid(self, job: JobInfo) -> Optional[ValidateResult]:
        """First failing validator wins (go:228-244; not flag-gated)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.job_valid_fns.get(plugin.name)
                if fn is None:
                    continue
                vr = fn(job)
                if vr is not None and not vr.pass_:
                    return vr
        return None

    def job_order_fn(self, l: JobInfo, r: JobInfo) -> bool:
        """First non-zero comparison wins; fallback creation-time then UID
        (go:247-271)."""
        chain = self._job_order_chain
        if chain is None:
            chain = self._job_order_chain = [
                fn for tier in self.tiers for plugin in tier.plugins
                if plugin.enabled_job_order
                and (fn := self.job_order_fns.get(plugin.name)) is not None]
        for fn in chain:
            j = fn(l, r)
            if j != 0:
                return j < 0
        if l.creation_timestamp == r.creation_timestamp:
            return l.uid < r.uid
        return l.creation_timestamp < r.creation_timestamp

    def queue_order_fn(self, l: QueueInfo, r: QueueInfo) -> bool:
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_queue_order:
                    continue
                fn = self.queue_order_fns.get(plugin.name)
                if fn is None:
                    continue
                j = fn(l, r)
                if j != 0:
                    return j < 0
        lt = l.queue.metadata.creation_timestamp
        rt = r.queue.metadata.creation_timestamp
        if lt == rt:
            return l.uid < r.uid
        return lt < rt

    def task_compare_fns(self, l: TaskInfo, r: TaskInfo) -> int:
        chain = self._task_order_chain
        if chain is None:
            chain = self._task_order_chain = [
                fn for tier in self.tiers for plugin in tier.plugins
                if plugin.enabled_task_order
                and (fn := self.task_order_fns.get(plugin.name)) is not None]
        for fn in chain:
            j = fn(l, r)
            if j != 0:
                return j
        return 0

    def task_order_fn(self, l: TaskInfo, r: TaskInfo) -> bool:
        res = self.task_compare_fns(l, r)
        if res != 0:
            return res < 0
        lt = l.pod.metadata.creation_timestamp
        rt = r.pod.metadata.creation_timestamp
        if lt == rt:
            return l.uid < r.uid
        return lt < rt

    def task_sort_key(self) -> Optional[Callable]:
        """Static ascending sort key equivalent to task_order_fn, or None
        when some enabled task-order plugin has no key form.  Task keys
        are immutable within a session (the cmp chain reads only
        priority/timestamps/uid-class fields), so a one-time sort equals
        the comparator queue's live re-evaluation exactly — including
        the creation-time/UID total-order fallback."""
        if self._task_key_fn is not False:
            return self._task_key_fn
        key_fns = []
        for tier in self.tiers:
            for plugin in tier.plugins:
                if (plugin.enabled_task_order
                        and plugin.name in self.task_order_fns):
                    kf = self.task_order_key_fns.get(plugin.name)
                    if kf is None:
                        self._task_key_fn = None
                        return None
                    key_fns.append(kf)
        if len(key_fns) == 1:
            k0 = key_fns[0]

            def key(t, _k0=k0):
                return (_k0(t), t.pod.metadata.creation_timestamp, t.uid)
        else:
            def key(t, _ks=tuple(key_fns)):
                return (*[k(t) for k in _ks],
                        t.pod.metadata.creation_timestamp, t.uid)
        self._task_key_fn = key
        return key

    def task_queue(self, items=()):
        """Queue over tasks in task_order_fn order.  A one-sort drain
        when every enabled task-order plugin registered a static key
        form (task keys are immutable within a session), else the live
        comparator queue — identical pop order either way."""
        key = self.task_sort_key()
        if key is not None:
            return SortedDrainQueue(key, items)
        q = PriorityQueue(self.task_order_fn)
        for t in items:
            q.push(t)
        return q

    def victims_queue(self, victims):
        """Victims in REVERSED task order — lowest priority evicted
        first (preempt.go:213-218)."""
        key = self.task_sort_key()
        if key is not None:
            return SortedDrainQueue(key, victims, reverse=True)
        q = PriorityQueue(lambda l, r: not self.task_order_fn(l, r))
        for v in victims:
            q.push(v)
        return q

    def predicate_fn(self, task: TaskInfo, node: NodeInfo) -> None:
        """All enabled predicates across all tiers must pass (go:334-351).
        Raises FitError on the first rejection."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_predicate:
                    continue
                fn = self.predicate_fns.get(plugin.name)
                if fn is not None:
                    fn(task, node)

    def node_prioritizers(self) -> List:
        """Concatenate enabled (weight, fn) prioritizers (go:354-369)."""
        configs: List = []
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_node_order:
                    continue
                prioritizers = self.node_order_fns.get(plugin.name)
                if prioritizers:
                    configs.extend(prioritizers)
        return configs

    # ------------------------------------------------------------------
    # decisions (session.go:186-345)

    def statement(self):
        from .statement import Statement
        return Statement(self)

    def _dirty_job(self, uid: str) -> None:
        """Record that this session mutated job ``uid``'s clone (and evict
        it from the cache's snapshot pool).  Every session-side mutation
        path MUST route through here or _dirty_node — a missed call means
        the next cycle schedules on a stale clone."""
        if uid not in self.mutated_jobs:
            self.mutated_jobs.add(uid)
            discard = getattr(self.cache, "discard_pooled_job", None)
            if discard is not None:
                discard(uid)

    def _dirty_node(self, name: str) -> None:
        if name not in self.mutated_nodes:
            hook = self._dirty_node_hook
            if hook is not None:
                # Every mutation path dirties BEFORE touching the clone
                # (the contract above), so the pipeline's de-alias guard
                # always runs while the object is still bit-identical to
                # its snapshot.  Batch walks that mutate before their
                # settle-phase dirty marks pre-declare via
                # _predeclare_nodes instead.
                hook((name,))
            self.mutated_nodes.add(name)
            discard = getattr(self.cache, "discard_pooled_node", None)
            if discard is not None:
                discard(name)

    def _predeclare_nodes(self, names) -> None:
        """Announce the node set a batch walk is about to mutate (the
        native/columnar apply writes node clones before its settle-phase
        _dirty_node calls): gives the shard pipeline's de-alias guard its
        before-the-mutation window.  No-op outside a pipelined retire."""
        hook = self._dirty_node_hook
        if hook is not None:
            hook(names)

    def _fire_allocate(self, task: TaskInfo):
        for eh in self.event_handlers:
            if eh.allocate_func is not None:
                eh.allocate_func(Event(task))

    def _fire_deallocate(self, task: TaskInfo):
        for eh in self.event_handlers:
            if eh.deallocate_func is not None:
                eh.deallocate_func(Event(task))

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        """Session-only assignment onto releasing resources (session.go:194-232)."""
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job} when pipelining")
        self._dirty_job(task.job)
        job.update_task_status(task, TaskStatus.Pipelined)
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        self._dirty_node(hostname)
        node.add_task(task)
        self._fire_allocate(task)
        log = getattr(self, "_fused_mutlog", None)
        if log is not None:
            log.append(("pipeline", task.uid, hostname))

    def allocate(self, task: TaskInfo, hostname: str) -> None:
        """Assign idle resources; dispatch the whole gang once JobReady
        (session.go:235-288)."""
        if task.pod.spec.volumes:
            # Volume-less pods skip the binder round-trip (the gate all
            # placement paths share: batch_apply applies the same one, so
            # batch and sequential end states stay identical).
            self.cache.allocate_volumes(task, hostname)
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job}")
        self._dirty_job(task.job)
        job.update_task_status(task, TaskStatus.Allocated)
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        self._dirty_node(hostname)
        node.add_task(task)
        self._fire_allocate(task)
        log = getattr(self, "_fused_mutlog", None)
        if log is not None:
            log.append(("allocate", task.uid, hostname))

        if self.job_ready(job):
            # Gang barrier: dispatch every Allocated task of the job at once.
            for t in list(job.task_status_index.get(TaskStatus.Allocated, {}).values()):
                self.dispatch(t)

    def dispatch(self, task: TaskInfo) -> None:
        """Bind to the cluster (session.go:290-314)."""
        if task.pod.spec.volumes:  # same gate as allocate()/batch_apply
            self.cache.bind_volumes(task)
        self.cache.bind(task, task.node_name)
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job}")
        self._dirty_job(task.job)
        job.move_task_status(task, TaskStatus.Binding)
        metrics.observe_task_schedule_latency(
            time.time() - task.pod.metadata.creation_timestamp)

    def _fire_allocate_batch(self, batch) -> None:
        for eh in self.event_handlers:
            if eh.batch_allocate_func is not None:
                eh.batch_allocate_func(batch)
            elif eh.allocate_func is not None:
                for t in batch.tasks:
                    eh.allocate_func(Event(t))

    def _apply_sequential(self, placements) -> None:
        """Exact per-task replay (the pre-batch apply path): used when the
        batch feasibility pre-check trips, so infeasible placements are
        rejected individually exactly as allocate()/pipeline() would."""
        for task, hostname, kind in placements:
            try:
                if kind == 1:
                    self.allocate(task, hostname)
                else:
                    self.pipeline(task, hostname)
            except (KeyError, ValueError):
                # Mirror the reference's log-and-continue on bind errors
                # (allocate.go:162-166); cache resync repairs divergence.
                continue

    def batch_apply(self, placements, agg=None) -> None:
        """Apply a solved placement sequence in bulk.

        ``placements``: iterable of (task, hostname, kind) with kind
        1=allocate, 2=pipeline, in solve order.  Final state is identical
        to calling allocate()/pipeline() per task in that order: status
        moves, node accounting, and plugin event state are all linear in
        the placed tasks, and the gang dispatch barrier depends only on
        final readiness (ready_task_num never decreases while allocating),
        so per-node/per-job aggregation commutes (f64 sums may reassociate;
        the <=1e-10 relative drift is far inside every epsilon).

        ``agg``: optional BatchAggregates precomputed from the solver's own
        arrays (models/tensor_snapshot.build_apply_aggregates); with it the
        per-task loop is only index moves + node-clone inserts."""
        from ..api.resource import Resource

        with trace.span("apply.walk"):
            placements = list(placements)
            # Feasibility pre-check: the sequential path rejects a placement
            # whose request exceeds idle beyond epsilon (node_info.go AddTask)
            # and the action skips it.  Summed aggregates can't reproduce that
            # per-task skip, so if any node's total looks overdrawn (solver bug
            # or stale snapshot), replay the whole batch through the exact
            # per-task path instead.  With agg the sums already exist
            # (vectorized); without it, build them once and reuse below.
            if agg is not None:
                check_alloc, check_pipe = agg.node_alloc, agg.node_pipe
            else:
                check_alloc, check_pipe = {}, {}
                for task, hostname, kind in placements:
                    accs = check_alloc if kind == 1 else check_pipe
                    acc = accs.get(hostname)
                    if acc is None:
                        acc = accs[hostname] = Resource.empty()
                    acc.add(task.resreq)
            for accs, pool in ((check_alloc, "idle"),
                               (check_pipe, "releasing")):
                for hostname, acc in accs.items():
                    node = self.nodes.get(hostname)
                    if node is not None and not acc.less_equal(
                            getattr(node, pool)):
                        self._apply_sequential(placements)
                        return

            if self._dirty_node_hook is not None:
                self._predeclare_nodes({h for _t, h, _k in placements})
            node_alloc: dict = check_alloc
            node_pipe: dict = check_pipe
            touched_jobs: dict = {}
            applied: List[TaskInfo] = []
            skipped = []
            jobs_get = self.jobs.get
            nodes_get = self.nodes.get
            allocate_volumes = self.cache.allocate_volumes
            applied_append = applied.append
            allocated_st = TaskStatus.Allocated
            pipelined_st = TaskStatus.Pipelined
            # With agg, status-index moves are deferred and batched per job
            # (same end state: index moves commute within the batch); the
            # whole-bucket case — every Pending task of a job allocated, the
            # norm for gang jobs — moves the bucket dict wholesale instead of
            # one pop+insert per task.  The per-placement pass itself runs in
            # C when the native extension built (kube_batch_tpu_torch/native).
            alloc_moves: dict = {}
            pipe_moves: dict = {}
            if agg is not None and native_apply is not None:
                (applied, skipped, touched_jobs, alloc_moves,
                 pipe_moves) = native_apply(self.jobs, self.nodes, placements,
                                            allocate_volumes)
            else:
                for task, hostname, kind in placements:
                    job = jobs_get(task.job)
                    node = nodes_get(hostname)
                    if job is None or node is None:
                        skipped.append((task, hostname, kind))
                        continue
                    key = pod_key(task.pod)  # f"{namespace}/{name}", cached
                    if key in node.tasks:  # add_task would raise; log-and-skip
                        skipped.append((task, hostname, kind))
                        continue
                    if kind == 1:
                        if task.pod.spec.volumes:
                            # Volume-less pods skip the binder round-trip:
                            # every VolumeBinder is a no-op without claims,
                            # and 50k no-op calls cost ~30 ms per cycle.
                            try:
                                allocate_volumes(task, hostname)
                            except (KeyError, ValueError):
                                # e.g. a missing PVC: skip this placement
                                # exactly as the sequential path's per-task
                                # catch would.
                                skipped.append((task, hostname, kind))
                                continue
                        if agg is None:
                            job.move_task_status(task, allocated_st)
                        else:
                            alloc_moves.setdefault(task.job, []).append(task)
                    else:
                        if agg is None:
                            job.move_task_status(task, pipelined_st)
                        else:
                            pipe_moves.setdefault(task.job, []).append(task)
                    task.node_name = node.name
                    lazy_insert(node.tasks, key, task)
                    touched_jobs[task.job] = job
                    applied_append(task)

        self._settle_batch(node_alloc, node_pipe, touched_jobs, applied,
                           skipped, agg, alloc_moves, pipe_moves)

    def _settle_batch(self, node_alloc, node_pipe, touched_jobs, applied,
                      skipped, agg, alloc_moves, pipe_moves) -> None:
        """The result-independent back half of a batch apply, shared by
        the placement-tuple path (batch_apply) and the columnar path
        (batch_apply_solved): deferred status-index moves, dirty marks,
        lineage, skip settlement, per-node/per-job accounting, the
        plugin batch event, and the gang dispatch barrier — in exactly
        the order the tuple path always ran them — then the binds of the
        tasks the barrier dispatched."""
        with trace.span("apply.settle"):
            dispatching, now = self._settle(
                node_alloc, node_pipe, touched_jobs, applied, skipped, agg,
                alloc_moves, pipe_moves)
        if dispatching:
            self.cache.bind_batch(dispatching)
            metrics.observe_task_schedule_latencies(
                [now - t.pod.metadata.creation_timestamp
                 for t in dispatching])

    def _settle(self, node_alloc, node_pipe, touched_jobs, applied,
                skipped, agg, alloc_moves, pipe_moves):
        """``_settle_batch`` up to the binds: (the tasks the gang barrier
        dispatched, the barrier's wall-clock time)."""
        if alloc_moves or pipe_moves:
            allocated_st, pipelined_st = (TaskStatus.Allocated,
                                          TaskStatus.Pipelined)
            for uid, job in touched_jobs.items():
                to_alloc = alloc_moves.get(uid, ())
                to_pipe = pipe_moves.get(uid, ())
                index = job.task_status_index
                pend = index.get(TaskStatus.Pending)
                if (to_alloc and not to_pipe and pend is not None
                        and len(to_alloc) == len(pend)
                        and all(pend.get(t.uid) is t for t in to_alloc)):
                    # Whole-bucket move: Pending becomes Allocated.
                    del index[TaskStatus.Pending]
                    for t in pend.values():
                        t.status = allocated_st
                    existing = index.get(allocated_st)
                    if existing:
                        existing.update(pend)
                    else:
                        index[allocated_st] = pend
                    job._ready_num = None  # bypassed move_task_index
                else:
                    for t in to_alloc:
                        job.move_task_index(t, allocated_st)
                    for t in to_pipe:
                        job.move_task_index(t, pipelined_st)

        for uid in touched_jobs:
            self._dirty_job(uid)
        for accs in (node_alloc, node_pipe):
            for hostname in accs:
                self._dirty_node(hostname)

        # Pod lineage: one bulk "placed" record for the whole batch (the
        # cycle context set by tpu-allocate names the action/route).
        # Untracked pods are skipped inside; O(applied) key builds only
        # while lineage is enabled.
        if applied and pod_lineage.cfg().enabled:
            pod_lineage.note_placed([pod_key(t.pod) for t in applied],
                                    session=trace.current_session_id())

        # Remove contributions of skipped placements so the (pre)computed
        # sums describe exactly what was applied.
        for task, hostname, kind in skipped:
            if kind == 1 and hostname in node_alloc:
                node_alloc[hostname].sub_lenient(task.resreq)
            elif hostname in node_pipe:
                node_pipe[hostname].sub_lenient(task.resreq)
            if agg is not None:
                if task.job in agg.job_alloc and kind == 1:
                    agg.job_alloc[task.job].sub_lenient(task.resreq)
                if agg.job_sums and task.job in agg.job_sums:
                    agg.job_sums[task.job].sub_lenient(task.resreq)
                if agg.node_quanta and hostname in agg.node_quanta:
                    from ..ops.resources import quantize_value
                    qc, qm = agg.node_quanta[hostname]
                    agg.node_quanta[hostname] = (
                        qc - quantize_value(task.resreq.milli_cpu, 0),
                        qm - quantize_value(task.resreq.memory, 1))

        if agg is not None:
            # Settle job.allocated with one aggregate per job (only
            # Allocated counts: Pipelined is not an allocated status).
            for uid, res in agg.job_alloc.items():
                job = self.jobs.get(uid)
                if job is not None:
                    job.allocated.add(res)

        # Node accounting, one vector op per touched node (node_info.go
        # AddTask semantics summed; sub_lenient reproduces the sequential
        # path's epsilon-tolerant end state).
        for hostname, acc in node_alloc.items():
            node = self.nodes.get(hostname)
            if node is not None:
                node.idle.sub_lenient(acc)
                node.used.add(acc)
        for hostname, acc in node_pipe.items():
            node = self.nodes.get(hostname)
            if node is not None:
                node.releasing.sub_lenient(acc)
                node.used.add(acc)

        self._fire_allocate_batch(AllocateBatch(
            tasks=applied,
            job_sums=None if agg is None else agg.job_sums,
            node_quanta=None if agg is None else agg.node_quanta))

        # Gang barrier: dispatch every Allocated task of each now-ready job
        # (session.go:277-285; end state matches the interleaved loop).
        # Bulk form of dispatch(): Allocated and Binding are both
        # allocated_status, so job.allocated is invariant and the whole
        # status bucket moves at once; binds and latency metrics batch.
        now = time.time()
        dispatching: List[TaskInfo] = []
        for job in touched_jobs.values():
            if not self.job_ready(job):
                continue
            moving = job.task_status_index.pop(TaskStatus.Allocated, None)
            if not moving:
                continue
            # Allocated -> Binding keeps ready_task_num invariant (both
            # are allocated statuses), but reset the memo anyway: this
            # path bypasses move_task_index.
            job._ready_num = None
            binding = job.task_status_index[TaskStatus.Binding]
            moving_items = list(moving.items())
            if not any(t.pod.spec.volumes for t in moving.values()):
                # Volume-free fast path: no bind_volumes call can raise,
                # so the whole bucket moves in bulk.
                for t in moving.values():
                    t.status = TaskStatus.Binding
                binding.update(moving)
                dispatching.extend(moving.values())
                continue
            for i, (uid, t) in enumerate(moving_items):
                try:
                    if t.pod.spec.volumes:  # no-op (and raise-free) without
                        self.cache.bind_volumes(t)
                except (KeyError, ValueError):
                    # Sequential-path semantics: dispatch() propagates the
                    # error out of allocate(), so this and the job's
                    # remaining Allocated tasks stay Allocated this cycle
                    # (session.go:290-314 error return; allocate.go:164
                    # logs and moves on).  Already-dispatched tasks keep
                    # their Binding status, as in the interleaved loop.
                    alloc = job.task_status_index[TaskStatus.Allocated]
                    for ruid, rt in moving_items[i:]:
                        alloc[ruid] = rt
                    break
                t.status = TaskStatus.Binding
                binding[uid] = t
                dispatching.append(t)
        return dispatching, now

    def batch_apply_solved(self, tasks_arr, node_names_arr, assignment,
                           kind, ordered, jobix, job_uids, agg) -> None:
        """Columnar apply of a device solve: the same end state as
        ``batch_apply`` over (task, hostname, kind) tuples, fed directly
        from the solver's arrays and the staged index->TaskInfo table —
        no per-placement tuple materialization, no per-placement
        job/node dict resolution, and the status-index move lists
        grouped by numpy instead of per-task setdefault/append.

        Bit parity with the tuple path (pinned by the pipeline/churn/
        commit parity gates): the per-placement walk runs in solve
        order, ``touched_jobs`` keeps first-touch order (the gang
        dispatch barrier iterates it — bind order depends on it), and
        the per-job move lists keep placement order via stable sorts
        (status-index dict order feeds the bind batch).

        ``tasks_arr``: [P_real+] object ndarray (index -> TaskInfo);
        ``node_names_arr``: [N] object ndarray of node names;
        ``assignment``/``kind``: [P] result vectors; ``ordered``:
        placed rows in placement order; ``jobix``: [P_real] task -> job
        index; ``job_uids``: job index -> uid; ``agg``:
        BatchAggregates (required — the pre-check and accounting read
        it)."""
        sel = ordered
        with trace.span("apply.walk"):
            n_idx = assignment[sel]

            # Feasibility pre-check, identical to batch_apply: an
            # overdrawn node total means the solver and session disagree
            # — replay the whole batch through the exact per-task path.
            for accs, pool in ((agg.node_alloc, "idle"),
                               (agg.node_pipe, "releasing")):
                for hostname, acc in accs.items():
                    node = self.nodes.get(hostname)
                    if node is not None and not acc.less_equal(
                            getattr(node, pool)):
                        self._apply_sequential(
                            list(zip(tasks_arr[sel].tolist(),
                                     node_names_arr[n_idx].tolist(),
                                     kind[sel].tolist())))
                        return

            if self._dirty_node_hook is not None:
                self._predeclare_nodes(set(node_names_arr[n_idx].tolist()))

            # Native columns walk: the same C per-placement pass the
            # tuple path runs (kube_batch_tpu_torch/native), fed three
            # parallel lists — no per-placement tuple packing.  Returns
            # exactly the settle inputs, with touched_jobs/moves in
            # first-touch placement order by dict-insertion construction.
            if native_apply is not None:
                (applied, skipped, touched_jobs, alloc_moves,
                 pipe_moves) = native_apply(
                    self.jobs, self.nodes,
                    (tasks_arr[sel].tolist(), node_names_arr[n_idx].tolist(),
                     kind[sel].tolist()),
                    self.cache.allocate_volumes)
            else:
                (applied, skipped, touched_jobs, alloc_moves,
                 pipe_moves) = self._walk_columns(
                    tasks_arr, node_names_arr, kind, sel, n_idx, jobix,
                    job_uids)
        self._settle_batch(agg.node_alloc, agg.node_pipe, touched_jobs,
                           applied, skipped, agg, alloc_moves, pipe_moves)

    def _walk_columns(self, tasks_arr, node_names_arr, kind, sel, n_idx,
                      jobix, job_uids):
        """The Python columnar fallback of ``batch_apply_solved``'s walk:
        (applied, skipped, touched_jobs, alloc_moves, pipe_moves), as
        the native walk returns them.  Object fan-out resolves each
        unique node/job once, then numpy takes; the per-task loop keeps
        only the work that is inherently per object."""
        import numpy as np

        node_objs = np.empty(len(node_names_arr), dtype=object)
        node_objs[:] = [self.nodes.get(n)
                        for n in node_names_arr.tolist()]
        job_objs = np.empty(len(job_uids), dtype=object)
        job_objs[:] = [self.jobs.get(u) for u in job_uids]

        t_col = tasks_arr[sel]
        k_list = kind[sel].tolist()
        node_col = node_objs[n_idx]
        job_col = job_objs[jobix[sel]]

        applied: List[TaskInfo] = []
        applied_append = applied.append
        skip_pos: List[int] = []
        allocate_volumes = self.cache.allocate_volumes
        pos = 0
        for task, node, job, k in zip(t_col, node_col, job_col, k_list):
            if job is None or node is None:
                skip_pos.append(pos)
                pos += 1
                continue
            key = pod_key(task.pod)
            ntasks = node.tasks
            if key in ntasks:  # add_task would raise; log-and-skip
                skip_pos.append(pos)
                pos += 1
                continue
            if k == 1 and task.pod.spec.volumes:
                try:
                    allocate_volumes(task, node.name)
                except (KeyError, ValueError):
                    skip_pos.append(pos)
                    pos += 1
                    continue
            task.node_name = node.name
            lazy_insert(ntasks, key, task)
            applied_append(task)
            pos += 1

        # Applied rows + numpy grouping for the deferred status moves.
        if skip_pos:
            mask = np.ones(sel.shape[0], dtype=bool)
            mask[skip_pos] = False
            applied_sel = sel[mask]
            skipped = [(t_col[i], node_names_arr[int(n_idx[i])], k_list[i])
                       for i in skip_pos]
        else:
            applied_sel = sel
            skipped = []

        jseq = jobix[applied_sel]
        # touched_jobs in FIRST-TOUCH order (np.unique sorts by job
        # index; argsort of the first-occurrence positions restores the
        # placement-order first touch the tuple path records).
        uniq, first = np.unique(jseq, return_index=True)
        touch_order = uniq[np.argsort(first, kind="stable")].tolist()
        touched_jobs = {job_uids[i]: job_objs[i] for i in touch_order}

        alloc_moves: dict = {}
        pipe_moves: dict = {}
        k_arr = kind[applied_sel]
        for kk, moves in ((1, alloc_moves), (2, pipe_moves)):
            rows = applied_sel[k_arr == kk]
            if not rows.size:
                continue
            jr = jobix[rows]
            o = np.argsort(jr, kind="stable")  # placement order per job
            rows_sorted = rows[o]
            jr_sorted = jr[o]
            groups, starts = np.unique(jr_sorted, return_index=True)
            bounds = np.append(starts, rows_sorted.shape[0])
            for gi, j in enumerate(groups.tolist()):
                moves[job_uids[j]] = tasks_arr[
                    rows_sorted[bounds[gi]:bounds[gi + 1]]].tolist()
        return applied, skipped, touched_jobs, alloc_moves, pipe_moves

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """Evict through the cache, then mirror in-session (session.go:317-345).

        Batched commit (framework/commit.py): with the action's
        CommitSink active, the session mirror applies immediately (the
        rest of the walk depends on it) and the cluster effect defers
        to the action's single flush — same mirror, same decision
        order, one egress.  The sequential body below is the
        KUBE_BATCH_TPU_BATCH_COMMIT=0 control."""
        # The ``commit`` floor times exactly the CLUSTER-EFFECT side
        # (the machinery the batched flush replaces): the per-task
        # cache.evict round-trip here, or the sink flush.  The session
        # mirror below is identical work in both arms and deliberately
        # outside the floor.
        sink = self._commit_sink
        if sink is None:
            start = time.perf_counter()
            self.cache.evict(reclaimee, reason)
            metrics.note_eviction(reason)  # "reclaim" on the direct path
            trace.note_evict(reason)
            self._floor_commit += time.perf_counter() - start
        job = self.jobs.get(reclaimee.job)
        if job is None:
            if sink is not None:
                # The sequential path has already egressed by the time
                # it discovers the missing job: keep the effect (the
                # flush will evict) and surface the same error.
                sink.add_evict(reclaimee, reason)
            log = getattr(self, "_fused_mutlog", None)
            if log is not None:
                # Cluster effect without the session mirror: no storm
                # leg can model this — a kind the proof never matches.
                log.append(("evict_error", reclaimee.uid,
                            reclaimee.node_name))
            raise KeyError(f"failed to find job {reclaimee.job}")
        # Fused Releasing transition (ROADMAP 5a): the session-clone twin
        # of the truth mirror's evict_many fast path — one status-index
        # move plus a releasing add per victim instead of the
        # delete/re-add Resource churn and the node-side remove/clone/add
        # round trip, with the same dict-order side effects (both tasks
        # dicts end with the victim at the END, exactly as the slow pair
        # leaves them).
        self._dirty_job(reclaimee.job)
        job.release_task(reclaimee)
        node = self.nodes.get(reclaimee.node_name)
        if node is not None:
            self._dirty_node(reclaimee.node_name)
            node.release_resident(reclaimee)
        self._fire_deallocate(reclaimee)
        if sink is not None:
            sink.add_evict(reclaimee, reason)
        log = getattr(self, "_fused_mutlog", None)
        if log is not None:
            log.append(("evict", reclaimee.uid, reclaimee.node_name))

    def update_job_condition(self, job_info: JobInfo, cond: PodGroupCondition):
        """Upsert a PodGroup condition by type (session.go:348-369)."""
        job = self.jobs.get(job_info.uid)
        if job is None:
            raise KeyError(f"failed to find job {job_info.namespace}/{job_info.name}")
        self._dirty_job(job.uid)
        if cond.type == PodGroupUnschedulableType and cond.status == "True":
            # Every unschedulable verdict (job_valid gate at open, gang's
            # close pass) flows through here: record it in the session
            # trace so /debug/why answers from the flight recorder.
            # Namespace-qualified: job names are only unique per
            # namespace, and a bare-name key would let ns-b/train
            # clobber ns-a/train's reason.
            trace.note_verdict(f"{job.namespace}/{job.name}",
                               cond.reason, cond.message)
        conditions = job.pod_group.status.conditions
        for i, c in enumerate(conditions):
            if c.type == cond.type:
                conditions[i] = cond
                return
        conditions.append(cond)


# ----------------------------------------------------------------------
# lifecycle (framework.go:30-63, session.go:63-184)

def open_session(cache, tiers: List[Tier],
                 plugin_builders=None) -> Session:
    from .registry import get_plugin_builder

    ssn = Session(cache)
    # Memory-ledger baseline for the session's mem_delta trace
    # annotation (close_session; doc/OBSERVABILITY.md "Memory ledger").
    ssn._mem_open = memledger.totals()
    with trace.span("snapshot"):
        # Chaos site: a session-open snapshot failure is the whole cycle
        # dying at its first step — the loop must swallow it and back off
        # (doc/CHAOS.md site ``session.snapshot``; no-op branch when the
        # chaos engine is off).
        plan = chaos_plan.PLAN
        if plan is not None and plan.fire("session.snapshot"):
            raise RuntimeError("chaos: session snapshot failed (injected)")
        snap_start = time.perf_counter()
        snapshot: ClusterInfo = cache.snapshot()
        metrics.set_cycle_floor("snapshot",
                                time.perf_counter() - snap_start)
    # Wire-decode floor: the wall time reflector threads spent decoding
    # watch frames since the last session — attributed to the cycle that
    # absorbs the churn (0 for in-process caches; the wire A/B reads it).
    metrics.set_cycle_floor("decode", metrics.take_decode_seconds())
    # Pod-lineage session ledger: this open is the "first consider" for
    # every pod ingested since the previous one (trace/lineage.py).
    pod_lineage.note_session_open()
    ssn.jobs = snapshot.jobs
    ssn.nodes = snapshot.nodes
    ssn.queues = snapshot.queues
    ssn.tiers = tiers

    # Instantiate plugins and open them on the session.
    for tier in tiers:
        for option in tier.plugins:
            if option.name in ssn.plugins:
                continue
            builder = (plugin_builders or {}).get(option.name) \
                if plugin_builders else None
            if builder is None:
                builder = get_plugin_builder(option.name)
            if builder is None:
                raise KeyError(f"failed to get plugin {option.name}")
            plugin = builder(option.arguments)
            ssn.plugins[plugin.name()] = plugin

    for plugin in ssn.plugins.values():
        start = time.time()
        with trace.span("plugin." + plugin.name(), on="open"):
            plugin.on_session_open(ssn)
        metrics.observe_plugin_latency(plugin.name(), "OnSessionOpen",
                                       time.time() - start)

    # Gate invalid jobs (gang minAvailable) out of the session, recording the
    # unschedulable condition (session.go:89-108).
    #
    # Wire fast path: jobs provably passing (valid >= minAvailable from
    # the persistent per-job columns, the only check the stock gang
    # validator performs) skip the validator chain — a passing job is
    # unobservable through this gate, so the skip is bit-parity
    # (models/incremental.job_valid_pass_uids; None = control arm or a
    # non-stock validator registered, full walk below).
    from ..models.incremental import job_valid_pass_uids
    fast_pass = job_valid_pass_uids(ssn)
    for job in list(ssn.jobs.values()):
        if fast_pass is not None and job.uid in fast_pass:
            continue
        vr = ssn.job_valid(job)
        if vr is not None and not vr.pass_:
            if job.pod_group is not None:
                cond = PodGroupCondition(
                    type=PodGroupUnschedulableType, status="True",
                    transition_id=ssn.uid, last_transition_time=time.time(),
                    reason=vr.reason, message=vr.message)
                ssn.update_job_condition(job, cond)
                try:
                    ssn.cache.update_job_status(job)
                except Exception:
                    # A failed PodGroup status write must not abort the
                    # session open; countable instead of invisible.
                    metrics.note_swallowed("job_status_update")
            del ssn.jobs[job.uid]

    return ssn


def _close_one_job(ssn: Session, job: JobInfo) -> bool:
    """One job's close-out — the exact per-job body of the reference
    walk (session.go:119-144).  Returns True when the outcome was
    provably SILENT: nothing was pushed, no event was appended, no pod
    condition was written, AND (because the clone is bit-unchanged until
    it re-enters the dirty set) re-running it next cycle would be just as
    silent — the license for the incremental close to skip it."""
    if job.pod_group is None:
        ssn.cache.record_job_status_event(job)
        return _close_is_silent(job)
    status = job.pod_group.status
    phase, running, failed, succeeded = _derive_job_status(ssn, job)
    if (job.uid in ssn.mutated_jobs
            or (status.phase, status.running, status.failed,
                status.succeeded) != (phase, running, failed,
                                      succeeded)):
        # The session touched the job (placements, conditions) or the
        # derived status moved: push it.  mutated_jobs matters for
        # condition-only changes (e.g. gang Unschedulable), which the
        # phase/count compare cannot see.
        ssn._dirty_job(job.uid)
        status.phase = phase
        status.running = running
        status.failed = failed
        status.succeeded = succeeded
        try:
            ssn.cache.update_job_status(job)
        except Exception:
            # Same policy as open_session's discard path: the close
            # must finish; the failure is counted.
            metrics.note_swallowed("job_status_update")
        return False  # pushed (and the echo re-dirties it anyway)
    ssn.cache.record_job_status_event(job)
    return _close_is_silent(job)


def _close_is_silent(job: JobInfo) -> bool:
    """Whether record_job_status_event(job) observably did anything:
    mirrors its guards exactly — a non-shadow Pending/Unknown PodGroup
    (or a PDB job with Pending tasks) appends an Unschedulable event, and
    any Allocated/Pending task gets a pod condition + FailedScheduling
    event.  A True verdict is stable for an unchanged clone, so the
    incremental close may skip the job until it re-enters a dirty set."""
    from ..cache.shadow import shadow_pod_group
    pg = job.pod_group
    if not shadow_pod_group(pg):
        if pg is not None and pg.status.phase in (PodGroupUnknown,
                                                  PodGroupPending):
            return False
        if job.pdb is not None and \
                job.task_status_index.get(TaskStatus.Pending):
            return False
    if job.task_status_index.get(TaskStatus.Allocated) \
            or job.task_status_index.get(TaskStatus.Pending):
        return False
    return True


def close_session(ssn: Session) -> None:
    # Fused-dispatch ledger hygiene (ops/fused_solver.py): an alloc leg
    # nobody consumed retires its in-flight handle, a deferred commit
    # flush nobody reached egresses, the storm capture is released.
    from ..ops import fused_solver
    fused_solver.finalize_session(ssn)
    # plugin_close floor: the gang not-ready walk dominates this loop at
    # scale; the vectorized form (plugins/gang.py) must actually kill it
    # — the bench gate watches this number (doc/INCREMENTAL.md).
    plugin_close_start = time.perf_counter()
    for plugin in ssn.plugins.values():
        start = time.time()
        with trace.span("plugin." + plugin.name(), on="close"):
            plugin.on_session_close(ssn)
        metrics.observe_plugin_latency(plugin.name(), "OnSessionClose",
                                       time.time() - start)
    metrics.set_cycle_floor("plugin_close",
                            time.perf_counter() - plugin_close_start)

    # PodGroup status writeback (session.go:119-144).  The status write is
    # gated on an actual change: a no-op UpdatePodGroup would differ from
    # the derived state by nothing, and skipping it keeps pristine job
    # clones reusable by the snapshot pool (events and pod conditions are
    # still recorded every cycle, as the reference does).
    #
    # Incremental close (doc/INCREMENTAL.md "floors"): after an
    # incremental snapshot, only the session's touched jobs, the freshly
    # re-cloned ones, and the jobs whose last close was not provably
    # silent are walked — every skipped job is bit-unchanged since a
    # close that observably did nothing, so the event stream, condition
    # writes, and status pushes are identical to the full walk (the
    # churn parity gate pins it).  Candidates run in truth (seq) order so
    # multi-job event interleaving matches the control exactly.
    from ..models import incremental
    close_start = time.perf_counter()
    plan = None
    if incremental.incremental_enabled():
        close_plan = getattr(ssn.cache, "close_plan", None)
        if close_plan is not None:
            plan = close_plan()
    walked = 0
    if plan is None:
        active = set()
        for job in ssn.jobs.values():
            walked += 1
            if not _close_one_job(ssn, job):
                active.add(job.uid)
        if incremental.incremental_enabled():
            note = getattr(ssn.cache, "note_close_results", None)
            if note is not None:
                note(active)
    else:
        old_active, recloned, seqmap = plan
        process = old_active | recloned | set(ssn.mutated_jobs)
        active = set(old_active)
        tail = float("inf")
        for uid in sorted(process, key=lambda u: seqmap.get(u, tail)):
            job = ssn.jobs.get(uid)
            if job is None:
                active.discard(uid)
                continue
            walked += 1
            if _close_one_job(ssn, job):
                active.discard(uid)
            else:
                active.add(uid)
        ssn.cache.note_close_results(active)
    metrics.set_close_objects_walked(walked)
    metrics.set_cycle_floor("close", time.perf_counter() - close_start)

    # Commit/apply floors (doc/EVICTION.md "Batched commit"): the
    # session's accumulated effect-side wall time — what the eviction
    # actions paid committing effects to the cluster (batched flushes
    # or the sequential per-task control) and what tpu-allocate paid
    # applying placements.  Published every session so the bench gate
    # and the commit A/B can attribute storm regressions.
    metrics.set_cycle_floor("commit", ssn._floor_commit)
    metrics.set_cycle_floor("apply", ssn._floor_apply)

    # Publish the cycle's mutation footprint: the dirty-set sizes that
    # bound the next cycle's incremental staging and delta ship.  The
    # incremental session state accumulates the same footprint as the
    # churn the NEXT cycle's plan reports (models/incremental.py).
    metrics.set_session_mutations(len(ssn.mutated_jobs),
                                  len(ssn.mutated_nodes))
    from ..models import incremental
    incremental.note_session_mutations(ssn.cache, len(ssn.mutated_jobs),
                                       len(ssn.mutated_nodes))

    # Per-session memory footprint: which ledgers this session grew or
    # shrank, annotated onto the trace ("which session peaked the stage
    # buffers" is then a /debug/sessions read, not a bisection).
    mem_open = getattr(ssn, "_mem_open", None)
    if mem_open is not None:
        mem_delta = {name: nbytes - mem_open.get(name, 0)
                     for name, nbytes in memledger.totals().items()
                     if nbytes != mem_open.get(name, 0)}
        if mem_delta:
            trace.set_meta(mem_delta=mem_delta)

    ssn.jobs = {}
    ssn.nodes = {}
    ssn.queues = {}
    ssn.plugins = {}
    ssn.event_handlers = []
    ssn.prescan = {}


def _derive_job_status(ssn: Session, job_info: JobInfo):
    """(phase, running, failed, succeeded) from session state, without
    mutating (session.go:146-184)."""
    status = job_info.pod_group.status
    unschedulable = any(
        c.type == PodGroupUnschedulableType and c.status == "True"
        and c.transition_id == ssn.uid
        for c in status.conditions)

    if job_info.task_status_index.get(TaskStatus.Running) and unschedulable:
        phase = PodGroupUnknown
    else:
        allocated = 0
        for st, tasks in job_info.task_status_index.items():
            if allocated_status(st):
                allocated += len(tasks)
        if allocated >= job_info.pod_group.spec.min_member:
            phase = PodGroupRunning
        else:
            phase = PodGroupPending
    return (phase,
            len(job_info.task_status_index.get(TaskStatus.Running, {})),
            len(job_info.task_status_index.get(TaskStatus.Failed, {})),
            len(job_info.task_status_index.get(TaskStatus.Succeeded, {})))


def job_status(ssn: Session, job_info: JobInfo):
    """Derive and apply the PodGroup phase (session.go:146-184)."""
    status = job_info.pod_group.status
    (status.phase, status.running, status.failed,
     status.succeeded) = _derive_job_status(ssn, job_info)
    return status
