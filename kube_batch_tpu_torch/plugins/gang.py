"""Gang plugin: all-or-nothing co-scheduling on minAvailable.

Mirrors kube-batch pkg/scheduler/plugins/gang/gang.go.
"""

from __future__ import annotations

import time
from typing import List

from ..api import JobInfo, TaskInfo, ValidateResult
from ..api.pod_group_info import PodGroupCondition, PodGroupUnschedulableType
from ..apis.scheduling.v1alpha1 import (NotEnoughPodsReason,
                                        NotEnoughResourcesReason)
from ..framework import Arguments, Plugin
from ..metrics import metrics


class GangPlugin(Plugin):

    def __init__(self, arguments: Arguments):
        self.arguments = arguments

    def name(self) -> str:
        return "gang"

    def on_session_open(self, ssn) -> None:
        def valid_job_fn(job: JobInfo):
            """JobValid: enough valid tasks to ever reach minAvailable
            (gang.go:48-69)."""
            vtn = job.valid_task_num()
            if vtn < job.min_available:
                return ValidateResult(
                    pass_=False, reason=NotEnoughPodsReason,
                    message=(f"Not enough valid tasks for gang-scheduling, "
                             f"valid: {vtn}, min: {job.min_available}"))
            return None

        ssn.add_job_valid_fn(self.name(), valid_job_fn)

        def preemptable_fn(preemptor: TaskInfo,
                           preemptees: List[TaskInfo]) -> List[TaskInfo]:
            """Veto victims whose job would drop below minAvailable
            (gang.go:71-94)."""
            victims = []
            for preemptee in preemptees:
                job = ssn.jobs[preemptee.job]
                occupied = job.ready_task_num()
                preemptable = (job.min_available <= occupied - 1
                               or job.min_available == 1)
                if preemptable:
                    victims.append(preemptee)
            return victims

        ssn.add_reclaimable_fn(self.name(), preemptable_fn)
        ssn.add_preemptable_fn(self.name(), preemptable_fn)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            """Not-ready jobs before ready jobs (gang.go:96-121)."""
            l_ready, r_ready = l.ready(), r.ready()
            if l_ready and r_ready:
                return 0
            if l_ready:
                return 1
            if r_ready:
                return -1
            return 0

        ssn.add_job_order_fn(self.name(), job_order_fn)
        ssn.add_job_ready_fn(self.name(), lambda job: job.ready())
        ssn.add_job_pipelined_fn(self.name(), lambda job: job.pipelined())

    def on_session_close(self, ssn) -> None:
        """Write Unschedulable conditions + metrics for not-ready jobs
        (gang.go:132-162).

        Wire fast path (doc/INCREMENTAL.md "Wire fast path"): the
        reference walks EVERY job to find the not-ready ones; the
        vectorized form reads the persistent per-job ready/minAvailable
        columns (models/incremental.gang_close_unready — open columns
        plus a re-read of this session's mutated jobs) so ready jobs
        cost no Python visit.  Unready jobs run the identical per-job
        body; KUBE_BATCH_TPU_WIRE_FAST=0 restores the full walk."""
        # The full walk: the reference's WIRE_FAST=0 arm (its per-job
        # columns come with incremental sessions, ROADMAP queue 1 item 1).
        unready_jobs = [job for job in ssn.jobs.values() if not job.ready()]
        unschedulable_jobs = 0
        for job in unready_jobs:
            unready = job.min_available - job.ready_task_num()
            unschedulable_jobs += 1
            metrics.update_unschedule_task_count(job.name, int(unready))
            metrics.register_job_retries(job.name)
            if job.pod_group is None:
                continue
            msg = (f"{unready}/{len(job.tasks)} tasks in gang unschedulable: "
                   f"{job.fit_error()}")
            cond = PodGroupCondition(
                type=PodGroupUnschedulableType, status="True",
                transition_id=ssn.uid, last_transition_time=time.time(),
                reason=NotEnoughResourcesReason, message=msg)
            try:
                ssn.update_job_condition(job, cond)
            except KeyError:
                pass
        metrics.update_unschedule_job_count(unschedulable_jobs)


def new(arguments: Arguments) -> GangPlugin:
    return GangPlugin(arguments)
