"""Version-neutral internal PodGroup.

The reference keeps a scheduler-internal PodGroup decoupled from the CRD
versions and converts v1alpha1/v1alpha2 objects into it at the cache boundary
(kube-batch pkg/scheduler/api/pod_group_info.go).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field, replace

from ..apis.scheduling import v1alpha1, v1alpha2
from .objects import ObjectMeta

# Re-exported condition/phase constants (version-neutral names).
PodGroupPending = v1alpha1.PodGroupPending
PodGroupRunning = v1alpha1.PodGroupRunning
PodGroupUnknown = v1alpha1.PodGroupUnknown
PodGroupUnschedulableType = v1alpha1.PodGroupUnschedulableType

PodGroupCondition = v1alpha1.PodGroupCondition
PodGroupSpec = v1alpha1.PodGroupSpec
PodGroupStatus = v1alpha1.PodGroupStatus


@dataclass
class PodGroup:
    """Internal PodGroup; ``version`` records the origin API version so the
    status writeback converts back losslessly (pod_group_info.go)."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)
    version: str = v1alpha1.VERSION

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def clone(self) -> "PodGroup":
        """Snapshot-isolation clone without generic deepcopy: the session
        mutates status (phase/conditions writeback) and reads spec/metadata,
        so those copy field-by-field (flat dataclasses) while dict fields
        get fresh dicts.  ~10x faster than deepcopy on the snapshot path."""
        md = self.metadata
        return PodGroup(
            metadata=ObjectMeta(
                name=md.name, namespace=md.namespace, uid=md.uid,
                annotations=dict(md.annotations), labels=dict(md.labels),
                creation_timestamp=md.creation_timestamp,
                deletion_timestamp=md.deletion_timestamp,
                owner_uid=md.owner_uid),
            spec=replace(self.spec),
            status=PodGroupStatus(
                phase=self.status.phase,
                conditions=[replace(c) for c in self.status.conditions],
                running=self.status.running,
                succeeded=self.status.succeeded,
                failed=self.status.failed),
            version=self.version)


def from_versioned(pg) -> PodGroup:
    """Convert a v1alpha1/v1alpha2 PodGroup to the internal form."""
    version = v1alpha2.VERSION if isinstance(pg, v1alpha2.PodGroup) else v1alpha1.VERSION
    return PodGroup(
        metadata=copy.deepcopy(pg.metadata),
        spec=copy.deepcopy(pg.spec),
        status=copy.deepcopy(pg.status),
        version=version,
    )


def to_versioned(pg: PodGroup):
    """Convert the internal form back to its origin API version."""
    cls = v1alpha2.PodGroup if pg.version == v1alpha2.VERSION else v1alpha1.PodGroup
    return cls(
        metadata=copy.deepcopy(pg.metadata),
        spec=copy.deepcopy(pg.spec),
        status=copy.deepcopy(pg.status),
    )
