"""Shadow PodGroups for pods scheduled without one.

Mirrors kube-batch pkg/scheduler/cache/util.go:46-91: pods lacking a
group annotation get a synthetic PodGroup keyed by their owner reference
(falling back to the pod UID), with minMember from the
``scheduling.k8s.io/group-min-member`` annotation, default 1.
"""

from __future__ import annotations

from ..api.objects import ObjectMeta, Pod
from ..api.pod_group_info import PodGroup, PodGroupSpec
from ..apis.scheduling.v1alpha1 import GroupMinMemberAnnotationKey

SHADOW_PREFIX = "podgroup-"


def shadow_pod_group(pg: PodGroup) -> bool:
    return pg is not None and pg.metadata.name.startswith(SHADOW_PREFIX)


def shadow_group_key(pod: Pod) -> str:
    owner = pod.metadata.owner_uid or pod.metadata.uid
    return f"{pod.metadata.namespace}/{SHADOW_PREFIX}{owner}"


def create_shadow_pod_group(pod: Pod) -> PodGroup:
    min_member = 1
    raw = pod.metadata.annotations.get(GroupMinMemberAnnotationKey)
    if raw:
        try:
            min_member = int(raw)
        except ValueError:
            min_member = 1
    owner = pod.metadata.owner_uid or pod.metadata.uid
    return PodGroup(
        metadata=ObjectMeta(
            name=f"{SHADOW_PREFIX}{owner}",
            namespace=pod.metadata.namespace,
            uid=f"{SHADOW_PREFIX}{owner}",
            creation_timestamp=pod.metadata.creation_timestamp),
        spec=PodGroupSpec(min_member=min_member),
    )
