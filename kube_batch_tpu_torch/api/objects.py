"""Lightweight cluster objects (Pod / Node and friends).

The reference scheduler consumes Kubernetes ``v1.Pod``/``v1.Node`` objects;
this framework is standalone, so it carries its own minimal object model with
just the fields the scheduling paths read (mirroring what
kube-batch pkg/scheduler/api/{job_info,node_info,pod_info}.go touch).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .resource import Resource

_uid_counter = itertools.count(1)


def _auto_uid(prefix: str) -> str:
    return f"{prefix}-{next(_uid_counter):08d}"


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    annotations: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    owner_uid: str = ""  # single owner reference (cache/util.go keys shadow groups by it)

    def __post_init__(self):
        if not self.uid:
            self.uid = _auto_uid(self.name or "obj")


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" tolerates all effects

    def tolerates(self, taint: "Taint") -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass
class ContainerPort:
    host_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class Container:
    name: str = "main"
    requests: Dict[str, object] = field(default_factory=dict)
    ports: List[ContainerPort] = field(default_factory=list)


@dataclass
class Affinity:
    """Subset of pod/node affinity the nodeorder & predicates paths evaluate."""
    # Hard node affinity: list of {label: value} alternatives (OR of ANDs).
    required_node_terms: List[Dict[str, str]] = field(default_factory=list)
    # Soft node affinity: (weight, {label: value}) preferences.
    preferred_node_terms: List = field(default_factory=list)
    # Pod (anti-)affinity on a topology label, matched against pod labels.
    required_pod_affinity: List[Dict[str, str]] = field(default_factory=list)
    required_pod_anti_affinity: List[Dict[str, str]] = field(default_factory=list)
    # Soft pod (anti-)affinity: (weight, {label: value}) preferences scored
    # by nodeorder's InterPodAffinity priority (nodeorder.go:107-131).
    preferred_pod_affinity: List = field(default_factory=list)
    preferred_pod_anti_affinity: List = field(default_factory=list)
    topology_key: str = "kubernetes.io/hostname"


@dataclass
class PodSpec:
    """Pod spec (the scheduling-relevant subset of core/v1 PodSpec).

    Treat as immutable once attached to a Pod: update paths must replace
    the Pod/spec object rather than mutate fields in place — derived
    per-pod caches (models/tensor_snapshot._pod_static) invalidate on
    spec identity, matching apiserver semantics (pod specs are immutable
    after creation apart from a few non-scheduling fields)."""
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    priority: Optional[int] = None
    priority_class_name: str = ""
    scheduler_name: str = "kube-batch"
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    tolerations: List[Toleration] = field(default_factory=list)
    affinity: Optional[Affinity] = None
    # Names of PersistentVolumeClaims the pod mounts (volume binding).
    volumes: List[str] = field(default_factory=list)


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    storage_class: str = "standard"
    phase: str = "Pending"  # Pending | Bound
    volume_name: str = ""


@dataclass
class PodCondition:
    """core/v1 PodCondition subset: what taskUnschedulable writes
    (reference cache.go:548-568: PodScheduled=False/Unschedulable)."""
    type: str = ""      # e.g. "PodScheduled"
    status: str = ""    # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""


@dataclass
class PodStatus:
    phase: str = "Pending"  # Pending|Running|Succeeded|Failed|Unknown
    conditions: List[PodCondition] = field(default_factory=list)


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class NodeStatus:
    allocatable: Dict[str, object] = field(default_factory=dict)
    capacity: Dict[str, object] = field(default_factory=dict)
    # Node conditions, e.g. {"MemoryPressure": "True"} (the pressure
    # predicates read these; upstream predicates.go:201-247).
    conditions: Dict[str, str] = field(default_factory=dict)


@dataclass
class NodeSpec:
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class PriorityClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False


@dataclass
class PodDisruptionBudget:
    """Legacy gang source (reference keeps PDB support for backward
    compatibility, job_info.go:196-208; PDB jobs always land in the default
    queue, event_handlers.go:676)."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    min_available: int = 0


@dataclass
class Event:
    """core/v1 Event subset: the reference broadcasts Scheduled / Evict /
    FailedScheduling / Unschedulable events to the cluster
    (cache.go:238-240, :474-481, :530, :557)."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_object: str = ""  # "namespace/name" (or job uid)
    reason: str = ""           # e.g. "FailedScheduling"
    message: str = ""
    type: str = "Normal"       # Normal | Warning
    timestamp: float = 0.0


def pod_key(pod: Pod) -> str:
    """namespace/name key, the task identity on nodes (api/helpers.go:28-34).
    Cached on the pod object: namespace/name are immutable for a given
    Pod, and the hot paths (binds, node accounting, event egress) compute
    this key several times per task per cycle."""
    # getattr-with-default, not try/except: materializing an
    # AttributeError per first-touch pod costs more than the key build.
    key = getattr(pod, "_pod_key", None)
    if key is None:
        key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        pod._pod_key = key
    return key


def get_pod_resource_without_init_containers(pod: Pod) -> Resource:
    """Sum of container requests (reference pod_info.go:64-72)."""
    result = Resource.empty()
    for c in pod.spec.containers:
        result.add(Resource.from_resource_list(c.requests))
    return result


def get_pod_resource_request(pod: Pod) -> Resource:
    """Container sum, then per-dimension max with each init container
    (reference pod_info.go:52-61): init containers run sequentially, so the
    launch requirement is max(init) folded over the running requirement."""
    result = get_pod_resource_without_init_containers(pod)
    for c in pod.spec.init_containers:
        result.set_max_resource(Resource.from_resource_list(c.requests))
    return result
