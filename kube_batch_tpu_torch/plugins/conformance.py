"""Conformance plugin: protect critical pods from preempt/reclaim.

Mirrors kube-batch pkg/scheduler/plugins/conformance/conformance.go:41-61.
"""

from __future__ import annotations

from typing import List

from ..api import TaskInfo
from ..framework import Arguments, Plugin

SYSTEM_CRITICAL_CLASSES = ("system-cluster-critical", "system-node-critical")
SYSTEM_NAMESPACE = "kube-system"


def _is_critical(task: TaskInfo) -> bool:
    return (task.pod.spec.priority_class_name in SYSTEM_CRITICAL_CLASSES
            or task.namespace == SYSTEM_NAMESPACE)


class ConformancePlugin(Plugin):

    def __init__(self, arguments: Arguments):
        self.arguments = arguments

    def name(self) -> str:
        return "conformance"

    def on_session_open(self, ssn) -> None:
        def evictable_fn(evictor: TaskInfo,
                         evictees: List[TaskInfo]) -> List[TaskInfo]:
            return [t for t in evictees if not _is_critical(t)]

        ssn.add_preemptable_fn(self.name(), evictable_fn)
        ssn.add_reclaimable_fn(self.name(), evictable_fn)

    def on_session_close(self, ssn) -> None:
        pass


def new(arguments: Arguments) -> ConformancePlugin:
    return ConformancePlugin(arguments)
