"""Proportion plugin: weighted max-min fair queue shares.

Mirrors kube-batch pkg/scheduler/plugins/proportion/proportion.go:
iterative water-filling of per-queue ``deserved`` by weight, capped at each
queue's total request, redistributing surplus until nothing remains
(:101-154); queue order by share; Reclaimable keeps queues at >= deserved;
Overused when deserved <= allocated.

The water-filling fixed point is also implemented on-device as a
``lax.while_loop`` in ``ops.fairness.proportion_deserved``; this host version
is the parity oracle.
"""

from __future__ import annotations

import time
from typing import Dict, List

from ..api import (QueueInfo, Resource, TaskInfo, TaskStatus,
                   allocated_status, minimum, share)
from ..framework import Arguments, EventHandler, Plugin


class _QueueAttr:
    __slots__ = ("queue_id", "name", "weight", "share", "deserved",
                 "allocated", "request")

    def __init__(self, queue_id: str, name: str, weight: int):
        self.queue_id = queue_id
        self.name = name
        self.weight = weight
        self.share = 0.0
        self.deserved = Resource.empty()
        self.allocated = Resource.empty()
        self.request = Resource.empty()


class ProportionPlugin(Plugin):

    def __init__(self, arguments: Arguments):
        self.arguments = arguments
        self.total_resource = Resource.empty()
        self.queue_attrs: Dict[str, _QueueAttr] = {}

    def name(self) -> str:
        return "proportion"

    def _update_share(self, attr: _QueueAttr) -> None:
        res = 0.0
        for rn in attr.deserved.resource_names():
            s = share(attr.allocated.get(rn), attr.deserved.get(rn))
            if s > res:
                res = s
        attr.share = res

    def on_session_open(self, ssn) -> None:
        from ..models.incremental import cluster_total_allocatable
        cached_total = cluster_total_allocatable(ssn)
        if cached_total is not None:
            # Snapshot-map running sum (exact-int gated): identical
            # floats to the walk below (doc/INCREMENTAL.md "floors").
            self.total_resource = cached_total
        else:
            for node in ssn.nodes.values():
                self.total_resource.add(node.allocatable)

        # Aggregate allocated/request per queue (proportion.go:69-99).
        # Incremental open (doc/INCREMENTAL.md): a job clone the
        # informers have not touched contributes the same per-task add
        # sequence every cycle, so its (allocated, request) subtotal is
        # cached on the clone and added in ONE step.  Caching is gated
        # on every contributing value being an exact binary integer
        # (models/incremental.resource_exact): integer partial sums are
        # exactly representable, so the collapsed add equals the
        # per-task sequence bit for bit — fractional quantities keep
        # the original walk and are never cached.  The clone is the
        # validity token (mutated clones leave the snapshot pool).
        # KUBE_BATCH_TPU_INCREMENTAL=0 restores the unconditional walk.
        from ..models.incremental import (plugin_cache_enabled,
                                          resource_exact)
        reuse = plugin_cache_enabled(ssn.cache)
        # Per-queue rolling exactness: a collapsed add is only exact
        # while the queue ACCUMULATOR is still an exact integer — one
        # fractional job earlier in the walk poisons every later
        # collapsed add of that queue (acc + (t1+..+tn) reassociates vs
        # ((acc+t1)+..)+tn once acc is fractional).  The prefix before
        # the first fractional contribution is integer-exact in both
        # arms, so gating consumption on the running flag is airtight.
        q_exact: Dict[str, bool] = {}
        # Per-tenant fairness accounting (metrics/tenants.py): pending
        # demand + the oldest still-waiting job per queue, tracked inside
        # the SAME O(jobs) walk the open already does (two dict ops per
        # job — no new cluster walk, identical in both churn-A/B arms).
        q_pending: Dict[str, list] = {}  # queue -> [n_jobs, oldest_ts]
        for job in ssn.jobs.values():
            if job.queue not in self.queue_attrs:
                queue = ssn.queues.get(job.queue)
                if queue is None:
                    continue
                self.queue_attrs[job.queue] = _QueueAttr(
                    queue.uid, queue.name, queue.weight)
            attr = self.queue_attrs[job.queue]
            if job.task_status_index.get(TaskStatus.Pending):
                # A zero/missing creationTimestamp is UNKNOWN, not the
                # epoch: it must not win the oldest-waiter min, or a
                # wire PodGroup without the field reports ~55 years of
                # starvation.  inf never wins and yields 0.0 age when
                # every pending job's timestamp is unknown.
                ts = job.creation_timestamp or float("inf")
                pend = q_pending.get(job.queue)
                if pend is None:
                    q_pending[job.queue] = [1, ts]
                else:
                    pend[0] += 1
                    if ts < pend[1]:
                        pend[1] = ts
            qe = q_exact.get(job.queue, True)
            cached = getattr(job, "_prop_open_agg", None) \
                if reuse and qe else None
            if cached is not None:
                # Cached subtotals are exact by construction, so the
                # queue accumulator stays exact.
                attr.allocated.add(cached[0])
                attr.request.add(cached[1])
                continue
            if reuse and qe:
                alloc_sub = Resource.empty()
                req_sub = Resource.empty()
                exact = True
                for status, tasks in job.task_status_index.items():
                    if allocated_status(status):
                        for t in tasks.values():
                            attr.allocated.add(t.resreq)
                            attr.request.add(t.resreq)
                            alloc_sub.add(t.resreq)
                            req_sub.add(t.resreq)
                            if exact and not resource_exact(t.resreq):
                                exact = False
                    elif status == TaskStatus.Pending:
                        for t in tasks.values():
                            attr.request.add(t.resreq)
                            req_sub.add(t.resreq)
                            if exact and not resource_exact(t.resreq):
                                exact = False
                # Subtotal bound too: requests are non-negative, so an
                # in-range subtotal bounds every partial sum the control
                # walk passes through — the collapsed add stays exact.
                if exact and resource_exact(alloc_sub) \
                        and resource_exact(req_sub):
                    job._prop_open_agg = (alloc_sub, req_sub)
                else:
                    # The accumulator may be fractional from here on:
                    # no later job of this queue may consume a cached
                    # subtotal this session.
                    q_exact[job.queue] = False
                continue
            for status, tasks in job.task_status_index.items():
                if allocated_status(status):
                    for t in tasks.values():
                        attr.allocated.add(t.resreq)
                        attr.request.add(t.resreq)
                elif status == TaskStatus.Pending:
                    for t in tasks.values():
                        attr.request.add(t.resreq)

        # Water-filling of deserved (proportion.go:101-154).
        remaining = self.total_resource.clone()
        meet: Dict[str, bool] = {}
        while True:
            total_weight = sum(a.weight for a in self.queue_attrs.values()
                               if a.queue_id not in meet)
            if total_weight == 0:
                break
            increased = Resource.empty()
            decreased = Resource.empty()
            for attr in self.queue_attrs.values():
                if attr.queue_id in meet:
                    continue
                old_deserved = attr.deserved.clone()
                attr.deserved.add(
                    remaining.clone().multi(attr.weight / total_weight))
                if attr.request.less(attr.deserved):
                    attr.deserved = minimum(attr.deserved, attr.request)
                    meet[attr.queue_id] = True
                self._update_share(attr)
                inc, dec = attr.deserved.diff(old_deserved)
                increased.add(inc)
                decreased.add(dec)
            remaining.sub(increased).add(decreased)
            if remaining.is_empty():
                break

        # Publish the session's fairness table (ROADMAP item 3's
        # "fairness across tenants surfaced in /metrics and /debug"):
        # every number below already exists in the attrs the
        # water-filling just produced — this only formats and hands it
        # to metrics/tenants.py.  A queue is STARVED this session when
        # it still has pending demand while holding less than its
        # deserved share (share < 1 means under-deserved on every
        # dimension proportion tracks).
        from ..metrics.tenants import dominant_share, tenant_table
        now = time.time()
        rows: Dict[str, dict] = {}
        for attr in self.queue_attrs.values():
            pend = q_pending.get(attr.name, (0, now))
            starvation = max(0.0, now - pend[1]) if pend[0] else 0.0
            rows[attr.name] = {
                "weight": attr.weight,
                "share": round(attr.share, 4),
                "deserved_share": round(dominant_share(
                    attr.deserved, self.total_resource), 4),
                "allocated_share": round(dominant_share(
                    attr.allocated, self.total_resource), 4),
                "request_share": round(dominant_share(
                    attr.request, self.total_resource), 4),
                "pending_jobs": pend[0],
                "starvation_s": round(starvation, 3),
                "starved": bool(pend[0]) and attr.share < 1.0,
            }
        # Shard-scoped sessions (doc/TENANCY.md) publish a MERGE over
        # their own queue universe: shard A's table write must not zero
        # shard B's gauges the way a wholesale replace would.  The
        # universe is the shard map's MEMBERSHIP TEST, not the session's
        # queue set — a deleted queue is in no session's queues but its
        # stale row is still this shard's departure to zero.
        universe = (ssn.cache.owns_queue if getattr(ssn, "shard", None)
                    is not None else None)
        tenant_table.publish(rows, session_uid=ssn.uid, universe=universe)

        def queue_order_fn(l: QueueInfo, r: QueueInfo) -> int:
            ls = self.queue_attrs[l.uid].share
            rs = self.queue_attrs[r.uid].share
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_queue_order_fn(self.name(), queue_order_fn)

        def reclaimable_fn(reclaimer: TaskInfo,
                           reclaimees: List[TaskInfo]) -> List[TaskInfo]:
            """Victim ok if its queue stays at or above deserved
            (proportion.go:171-196)."""
            victims = []
            allocations: Dict[str, Resource] = {}
            for reclaimee in reclaimees:
                job = ssn.jobs[reclaimee.job]
                attr = self.queue_attrs[job.queue]
                if job.queue not in allocations:
                    allocations[job.queue] = attr.allocated.clone()
                allocated = allocations[job.queue]
                if allocated.less(reclaimee.resreq):
                    continue
                allocated.sub(reclaimee.resreq)
                if attr.deserved.less_equal(allocated):
                    victims.append(reclaimee)
            return victims

        ssn.add_reclaimable_fn(self.name(), reclaimable_fn)

        def overused_fn(queue: QueueInfo) -> bool:
            attr = self.queue_attrs.get(queue.uid)
            if attr is None:
                return False
            return attr.deserved.less_equal(attr.allocated)

        ssn.add_overused_fn(self.name(), overused_fn)

        def on_allocate(event):
            job = ssn.jobs[event.task.job]
            attr = self.queue_attrs[job.queue]
            attr.allocated.add(event.task.resreq)
            self._update_share(attr)

        def on_deallocate(event):
            job = ssn.jobs[event.task.job]
            attr = self.queue_attrs[job.queue]
            attr.allocated.sub(event.task.resreq)
            self._update_share(attr)

        def on_batch_allocate(batch):
            # Linear in tasks: one aggregate add + share update per queue.
            touched = set()
            if batch.job_sums is not None:
                for uid, res in batch.job_sums.items():
                    job = ssn.jobs.get(uid)
                    if job is None:
                        continue
                    attr = self.queue_attrs.get(job.queue)
                    if attr is not None:
                        attr.allocated.add(res)
                        touched.add(job.queue)
            else:
                for task in batch.tasks:
                    job = ssn.jobs[task.job]
                    attr = self.queue_attrs[job.queue]
                    attr.allocated.add(task.resreq)
                    touched.add(job.queue)
            for qid in touched:
                self._update_share(self.queue_attrs[qid])

        ssn.add_event_handler(EventHandler(allocate_func=on_allocate,
                                           deallocate_func=on_deallocate,
                                           batch_allocate_func=on_batch_allocate))

    def on_session_close(self, ssn) -> None:
        self.total_resource = Resource.empty()
        self.queue_attrs = {}


def new(arguments: Arguments) -> ProportionPlugin:
    return ProportionPlugin(arguments)
