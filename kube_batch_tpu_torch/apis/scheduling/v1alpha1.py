"""scheduling/v1alpha1 API types: PodGroup and Queue.

Mirrors kube-batch pkg/apis/scheduling/v1alpha1/types.go (PodGroup spec/
status/phases/conditions, Queue spec/status) and labels.go (annotation keys).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from ...api.objects import ObjectMeta

GROUP = "scheduling.incubator.k8s.io"
VERSION = "v1alpha1"

# Annotation keys (labels.go:20-28).
GroupNameAnnotationKey = "scheduling.k8s.io/group-name"
GroupMinMemberAnnotationKey = "scheduling.k8s.io/group-min-member"

# PodGroup phases (types.go:28-47).
PodGroupPending = "Pending"
PodGroupRunning = "Running"
PodGroupUnknown = "Unknown"

# Condition types and reasons (types.go:49-83).
PodGroupUnschedulableType = "Unschedulable"
NotEnoughResourcesReason = "NotEnoughResources"
NotEnoughPodsReason = "NotEnoughTasks"


@dataclass
class PodGroupCondition:
    type: str = ""
    status: str = "True"
    transition_id: str = ""
    last_transition_time: float = 0.0
    reason: str = ""
    message: str = ""


@dataclass
class PodGroupSpec:
    min_member: int = 0
    queue: str = "default"
    priority_class_name: str = ""


@dataclass
class PodGroupStatus:
    phase: str = PodGroupPending
    conditions: List[PodGroupCondition] = field(default_factory=list)
    running: int = 0
    succeeded: int = 0
    failed: int = 0


@dataclass
class PodGroup:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)
    api_version: str = f"{GROUP}/{VERSION}"


@dataclass
class QueueSpec:
    weight: int = 1
    capability: Dict[str, object] = field(default_factory=dict)


@dataclass
class QueueStatus:
    pending: int = 0
    running: int = 0
    unknown: int = 0


@dataclass
class Queue:
    """Cluster-scoped queue (types.go:169-200)."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: QueueSpec = field(default_factory=QueueSpec)
    status: QueueStatus = field(default_factory=QueueStatus)
    api_version: str = f"{GROUP}/{VERSION}"
