"""Task status machine and callback type contracts.

Mirrors kube-batch pkg/scheduler/api/types.go (TaskStatus bit-enum,
LessFn/CompareFn/ValidateFn/PredicateFn/EvictableFn/NodeOrderFn contracts) and
helpers.go (pod-phase -> TaskStatus mapping, AllocatedStatus set).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, List, Optional


class TaskStatus(enum.IntFlag):
    """Status of a task; bit-flag valued like the reference (types.go:23-52)."""
    Pending = 1 << 0     # pending in the cluster state store
    Allocated = 1 << 1   # scheduler assigned a host (session-local)
    Pipelined = 1 << 2   # assigned to a host, waiting for releasing resource
    Binding = 1 << 3     # bind request sent to the cluster
    Bound = 1 << 4       # bound to a host
    Running = 1 << 5     # running on the host
    Releasing = 1 << 6   # being deleted
    Succeeded = 1 << 7
    Failed = 1 << 8
    Unknown = 1 << 9


ALLOCATED_STATUSES = (TaskStatus.Bound | TaskStatus.Binding
                      | TaskStatus.Running | TaskStatus.Allocated)

_ALLOCATED_MASK = int(ALLOCATED_STATUSES)


def allocated_status(status: TaskStatus) -> bool:
    """Whether the status counts as holding resources (helpers.go:62-70).
    Plain-int bit test: IntFlag.__and__ constructs enum members and shows up
    hot in the bulk apply path."""
    return bool(int(status) & _ALLOCATED_MASK)


def get_task_status(pod) -> TaskStatus:
    """Map a pod's phase/fields to a TaskStatus (reference helpers.go:36-60)."""
    phase = pod.status.phase
    if phase == "Running":
        if pod.metadata.deletion_timestamp is not None:
            return TaskStatus.Releasing
        return TaskStatus.Running
    if phase == "Pending":
        if pod.metadata.deletion_timestamp is not None:
            return TaskStatus.Releasing
        if not pod.spec.node_name:
            return TaskStatus.Pending
        return TaskStatus.Bound
    if phase == "Unknown":
        return TaskStatus.Unknown
    if phase == "Succeeded":
        return TaskStatus.Succeeded
    if phase == "Failed":
        return TaskStatus.Failed
    return TaskStatus.Unknown


class NodePhase(enum.Enum):
    Ready = "Ready"
    NotReady = "NotReady"


@dataclass
class NodeState:
    phase: NodePhase = NodePhase.NotReady
    reason: str = ""


@dataclass
class ValidateResult:
    """Result of a JobValid check (types.go:115-120)."""
    pass_: bool
    reason: str = ""
    message: str = ""


class FitError(Exception):
    """A predicate rejected a (task, node) pair."""

    def __init__(self, task=None, node=None, reason: str = ""):
        self.task, self.node, self.reason = task, node, reason
        t = f"task <{task.namespace}/{task.name}>" if task is not None else "task"
        n = f"node <{node.name}>" if node is not None else "node"
        super().__init__(f"{t} on {n}: {reason}")


# Callback contracts (types.go:104-129).  CompareFn returns -1/0/1;
# LessFn returns bool; PredicateFn raises FitError on rejection;
# EvictableFn maps (preemptor, candidates) -> victims;
# NodeOrderFn maps (task, node) -> float score.
LessFn = Callable[[object, object], bool]
CompareFn = Callable[[object, object], int]
ValidateFn = Callable[[object], bool]
ValidateExFn = Callable[[object], Optional[ValidateResult]]
PredicateFn = Callable[[object, object], None]
EvictableFn = Callable[[object, List[object]], List[object]]
NodeOrderFn = Callable[[object, object], float]
