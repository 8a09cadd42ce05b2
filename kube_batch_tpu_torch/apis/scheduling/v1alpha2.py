"""scheduling/v1alpha2 API types.

The reference ships v1alpha2 as a structurally-identical but distinct API
group version (kube-batch pkg/apis/scheduling/v1alpha2/types.go; the
diff vs v1alpha1 is the package identity only).  We model that by subclassing
with a different ``api_version`` so objects of the two versions stay
distinguishable through the cache's version-conversion path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import v1alpha1 as _v1

GROUP = "scheduling.sigs.dev"
VERSION = "v1alpha2"

GroupNameAnnotationKey = _v1.GroupNameAnnotationKey
GroupMinMemberAnnotationKey = _v1.GroupMinMemberAnnotationKey

PodGroupPending = _v1.PodGroupPending
PodGroupRunning = _v1.PodGroupRunning
PodGroupUnknown = _v1.PodGroupUnknown
PodGroupUnschedulableType = _v1.PodGroupUnschedulableType
NotEnoughResourcesReason = _v1.NotEnoughResourcesReason
NotEnoughPodsReason = _v1.NotEnoughPodsReason

PodGroupCondition = _v1.PodGroupCondition
PodGroupSpec = _v1.PodGroupSpec
PodGroupStatus = _v1.PodGroupStatus
QueueSpec = _v1.QueueSpec
QueueStatus = _v1.QueueStatus


@dataclass
class PodGroup(_v1.PodGroup):
    api_version: str = f"{GROUP}/{VERSION}"


@dataclass
class Queue(_v1.Queue):
    api_version: str = f"{GROUP}/{VERSION}"
