"""Priority plugin: task/job ordering and preemption by priority.

Mirrors kube-batch pkg/scheduler/plugins/priority/priority.go.
"""

from __future__ import annotations

from typing import List

from ..api import JobInfo, TaskInfo
from ..framework import Arguments, Plugin


class PriorityPlugin(Plugin):

    def __init__(self, arguments: Arguments):
        self.arguments = arguments

    def name(self) -> str:
        return "priority"

    def on_session_open(self, ssn) -> None:
        def task_order_fn(l: TaskInfo, r: TaskInfo) -> int:
            # Higher pod priority first (priority.go:39-58).
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        ssn.add_task_order_fn(self.name(), task_order_fn)
        # Static-key form of the same order (higher priority first, so
        # ascending key = negated priority); enables sorted-drain task
        # queues in the actions.
        ssn.add_task_order_key_fn(self.name(), lambda t: -t.priority)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            # Higher PriorityClass value first (priority.go:61-79).
            if l.priority > r.priority:
                return -1
            if l.priority < r.priority:
                return 1
            return 0

        ssn.add_job_order_fn(self.name(), job_order_fn)

        def preemptable_fn(preemptor: TaskInfo,
                           preemptees: List[TaskInfo]) -> List[TaskInfo]:
            # Only strictly-lower-priority jobs are victims (priority.go:81-100).
            preemptor_job = ssn.jobs[preemptor.job]
            victims = []
            for preemptee in preemptees:
                preemptee_job = ssn.jobs[preemptee.job]
                if preemptee_job.priority < preemptor_job.priority:
                    victims.append(preemptee)
            return victims

        ssn.add_preemptable_fn(self.name(), preemptable_fn)


def new(arguments: Arguments) -> PriorityPlugin:
    return PriorityPlugin(arguments)
