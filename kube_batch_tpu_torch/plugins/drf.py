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
    """Per-job DRF state, built eagerly at session open (the
    reference's INCREMENTAL=0 arm; its lazy per-clone cache comes with
    incremental sessions, ROADMAP queue 1 item 1)."""

    __slots__ = ("share", "allocated")

    def __init__(self):
        self.share = 0.0
        self.allocated = Resource.empty()


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
        # The O(nodes) total and O(allocated tasks) per-job walks: the
        # reference's INCREMENTAL=0 arm (its cached aggregates and
        # vectorized shares come with incremental sessions, ROADMAP
        # queue 1 item 1).
        for node in ssn.nodes.values():
            self.total_resource.add(node.allocatable)

        # Per-tenant accounting rider (metrics/tenants.py): the largest
        # job share inside each queue, collected in the SAME walk.
        q_max: dict = {}
        for job in ssn.jobs.values():
            attr = _DrfAttr()
            for status, tasks in job.task_status_index.items():
                if allocated_status(status):
                    for t in tasks.values():
                        attr.allocated.add(t.resreq)
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
