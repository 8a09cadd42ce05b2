"""QueueInfo: scheduler view of a Queue.

Mirrors kube-batch pkg/scheduler/api/queue_info.go (version-neutral
internal Queue wrapper with Weight/Capability).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

from ..apis.scheduling import v1alpha1, v1alpha2
from .objects import ObjectMeta


@dataclass
class Queue:
    """Internal version-neutral Queue (queue_info.go:39-74)."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    weight: int = 1
    capability: dict = field(default_factory=dict)
    version: str = v1alpha1.VERSION


class QueueInfo:
    """Session view of a queue (queue_info.go:77-103)."""

    def __init__(self, queue: Queue):
        self.uid: str = queue.metadata.name  # queues are cluster-scoped; name is the ID
        self.name: str = queue.metadata.name
        self.weight: int = queue.weight
        self.queue: Queue = queue

    def clone(self) -> "QueueInfo":
        return QueueInfo(copy.deepcopy(self.queue))

    def __repr__(self) -> str:
        return f"QueueInfo({self.name}, weight={self.weight})"


def queue_from_versioned(q) -> Queue:
    version = v1alpha2.VERSION if isinstance(q, v1alpha2.Queue) else v1alpha1.VERSION
    return Queue(
        metadata=copy.deepcopy(q.metadata),
        weight=q.spec.weight,
        capability=dict(q.spec.capability),
        version=version,
    )
