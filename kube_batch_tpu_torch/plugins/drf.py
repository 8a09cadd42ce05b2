"""DRF plugin: dominant-resource fairness across jobs.

Mirrors kube-batch pkg/scheduler/plugins/drf/drf.go: per-job dominant
share = max over resources of allocated/total (:161-171); job order ascending
by share; preemption allowed only when it improves fairness; incremental
share maintenance through allocate/deallocate events (:135-154).

The same shares are computed on-device by ``ops.fairness.drf_shares``
(segment-max over a [jobs, resources] tensor); this host plugin is the
oracle and serves the sequential actions.
"""

from __future__ import annotations

import math
from typing import Dict, List

from ..api import JobInfo, Resource, TaskInfo, allocated_status, share
from ..framework import Arguments, EventHandler, Plugin

SHARE_DELTA = 0.000001


class _DrfAttr:
    """Per-job DRF state.  ``allocated`` materializes lazily on the fast
    path: the open-time vectorized share (models/incremental.
    drf_open_shares) needs only the float columns, so the per-job
    Resource clone — O(jobs) allocations per session — is deferred until
    something actually reads it (preemption path, allocate/deallocate
    event handlers).  The materialized value is the cached per-clone
    open walk cloned out, exactly what the control arm assigns
    eagerly."""

    __slots__ = ("share", "_alloc", "_job")

    def __init__(self):
        self.share = 0.0
        self._alloc = Resource.empty()
        self._job = None

    @property
    def allocated(self) -> Resource:
        res = self._alloc
        if res is None:
            from ..models.incremental import _drf_alloc_of
            res = self._alloc = _drf_alloc_of(self._job).clone()
        return res

    @allocated.setter
    def allocated(self, res: Resource) -> None:
        self._alloc = res


class DrfPlugin(Plugin):

    def __init__(self, arguments: Arguments):
        self.arguments = arguments
        self.total_resource = Resource.empty()
        self.job_attrs: Dict[str, _DrfAttr] = {}

    def name(self) -> str:
        return "drf"

    def _calculate_share(self, allocated: Resource) -> float:
        res = 0.0
        for rn in self.total_resource.resource_names():
            s = share(allocated.get(rn), self.total_resource.get(rn))
            if s > res:
                res = s
        return res

    def _update_share(self, attr: _DrfAttr) -> None:
        attr.share = self._calculate_share(attr.allocated)

    def on_session_open(self, ssn) -> None:
        from ..models.incremental import (cluster_total_allocatable,
                                          plugin_cache_enabled)
        reuse = plugin_cache_enabled(ssn.cache)

        # Total allocatable from the snapshot map's exact-int running
        # sum when available (doc/INCREMENTAL.md "floors"); the O(nodes)
        # walk stays for the control arm and fractional clusters.
        cached_total = cluster_total_allocatable(ssn)
        if cached_total is not None:
            self.total_resource = cached_total
        else:
            for node in ssn.nodes.values():
                self.total_resource.add(node.allocatable)

        # Incremental open (doc/INCREMENTAL.md): the per-job allocated
        # aggregate is cached on the job CLONE, so the O(all allocated
        # tasks) walk runs only for clones the informers (or a session)
        # touched — clone identity is the validity token (a mutated
        # clone is discarded from the snapshot pool and never served
        # again).  Exact by construction: the cached Resource was built
        # by this very walk and is cloned back out, so shares equal the
        # uncached path bit for bit.  KUBE_BATCH_TPU_INCREMENTAL=0
        # restores the unconditional walk (the parity control).
        # Per-tenant accounting rider (metrics/tenants.py): the largest
        # job share inside each queue, collected in the SAME walk (one
        # compare per job, both churn-A/B arms identical).
        #
        # Wire fast path (doc/INCREMENTAL.md "Wire fast path"): the
        # per-job ``_calculate_share`` recompute — a Python loop over
        # resource names per job, the drf half of the plugin floor —
        # collapses into ONE vectorized column op over the persistent
        # per-job allocation matrix, patched for dirty jobs only
        # (models/incremental.drf_open_shares documents the bit-parity
        # argument).  KUBE_BATCH_TPU_WIRE_FAST=0 restores this loop.
        from ..models.incremental import drf_open_shares
        agg = drf_open_shares(ssn, self.total_resource) if reuse else None
        q_max: dict = {}
        if agg is not None:
            shares = agg.shares
            index = agg.index
            for uid, job in ssn.jobs.items():
                attr = _DrfAttr()
                attr._alloc = None  # lazy: _drf_open_alloc.clone()
                attr._job = job
                attr.share = float(shares[index[uid]])
                self.job_attrs[uid] = attr
                q_cur = q_max.get(job.queue)
                if q_cur is None or attr.share > q_cur:
                    q_max[job.queue] = attr.share
        else:
            for job in ssn.jobs.values():
                attr = _DrfAttr()
                cached = getattr(job, "_drf_open_alloc", None) if reuse \
                    else None
                if cached is not None:
                    attr.allocated = cached.clone()
                else:
                    for status, tasks in job.task_status_index.items():
                        if allocated_status(status):
                            for t in tasks.values():
                                attr.allocated.add(t.resreq)
                    if reuse:
                        job._drf_open_alloc = attr.allocated.clone()
                self._update_share(attr)
                self.job_attrs[job.uid] = attr
                q_cur = q_max.get(job.queue)
                if q_cur is None or attr.share > q_cur:
                    q_max[job.queue] = attr.share
        from ..metrics.tenants import tenant_table
        # Shard-scoped sessions merge over their own queue universe —
        # the shard map's membership test, so deleted queues still
        # depart (doc/TENANCY.md): see the proportion open's publish.
        universe = (ssn.cache.owns_queue if getattr(ssn, "shard", None)
                    is not None else None)
        tenant_table.note_drf_job_shares(q_max, universe=universe)

        def preemptable_fn(preemptor: TaskInfo,
                           preemptees: List[TaskInfo]) -> List[TaskInfo]:
            """Victim ok iff preemptor's post-allocation share stays below
            victim's post-eviction share (drf.go:85-112)."""
            latt = self.job_attrs[preemptor.job]
            lalloc = latt.allocated.clone().add(preemptor.resreq)
            ls = self._calculate_share(lalloc)

            allocations: Dict[str, Resource] = {}
            victims = []
            for preemptee in preemptees:
                if preemptee.job not in allocations:
                    ratt = self.job_attrs[preemptee.job]
                    allocations[preemptee.job] = ratt.allocated.clone()
                ralloc = allocations[preemptee.job].sub(preemptee.resreq)
                rs = self._calculate_share(ralloc)
                if ls < rs or math.isclose(ls, rs, abs_tol=SHARE_DELTA):
                    victims.append(preemptee)
            return victims

        ssn.add_preemptable_fn(self.name(), preemptable_fn)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            ls = self.job_attrs[l.uid].share
            rs = self.job_attrs[r.uid].share
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_job_order_fn(self.name(), job_order_fn)

        def on_allocate(event):
            attr = self.job_attrs[event.task.job]
            attr.allocated.add(event.task.resreq)
            self._update_share(attr)

        def on_deallocate(event):
            attr = self.job_attrs[event.task.job]
            attr.allocated.sub(event.task.resreq)
            self._update_share(attr)

        def on_batch_allocate(batch):
            # Linear in tasks: one aggregate add + share update per job.
            if batch.job_sums is not None:
                for uid, res in batch.job_sums.items():
                    attr = self.job_attrs.get(uid)
                    if attr is not None:
                        attr.allocated.add(res)
                        self._update_share(attr)
                return
            touched = set()
            for task in batch.tasks:
                attr = self.job_attrs[task.job]
                attr.allocated.add(task.resreq)
                touched.add(task.job)
            for uid in touched:
                self._update_share(self.job_attrs[uid])

        ssn.add_event_handler(EventHandler(allocate_func=on_allocate,
                                           deallocate_func=on_deallocate,
                                           batch_allocate_func=on_batch_allocate))

    def on_session_close(self, ssn) -> None:
        self.total_resource = Resource.empty()
        self.job_attrs = {}


def new(arguments: Arguments) -> DrfPlugin:
    return DrfPlugin(arguments)
