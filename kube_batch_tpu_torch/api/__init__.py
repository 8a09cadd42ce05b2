"""Scheduler data model (L1): resource algebra, task/job/node/queue views.

TPU-native counterpart of kube-batch pkg/scheduler/api/.
"""

from .resource import (Resource, parse_quantity, minimum, share,
                       MIN_MILLI_CPU, MIN_MEMORY, MIN_MILLI_SCALAR,
                       GPU_RESOURCE_NAME, TPU_RESOURCE_NAME)
from .types import (TaskStatus, allocated_status, get_task_status, NodePhase,
                    NodeState, ValidateResult, FitError)
from .objects import (ObjectMeta, Pod, PodSpec, PodStatus, PodCondition,
                      Event, Node, NodeSpec,
                      NodeStatus, Container, ContainerPort, Taint, Toleration,
                      Affinity, PriorityClass, pod_key,
                      get_pod_resource_request,
                      get_pod_resource_without_init_containers)
from .job_info import TaskInfo, JobInfo, get_job_id, job_terminated
from .node_info import NodeInfo
from .queue_info import Queue, QueueInfo, queue_from_versioned
from .pod_group_info import (PodGroup, PodGroupCondition, PodGroupSpec,
                             PodGroupStatus, PodGroupPending, PodGroupRunning,
                             PodGroupUnknown, PodGroupUnschedulableType,
                             from_versioned, to_versioned)
from .cluster_info import ClusterInfo

__all__ = [
    "Resource", "parse_quantity", "minimum", "share",
    "MIN_MILLI_CPU", "MIN_MEMORY", "MIN_MILLI_SCALAR",
    "GPU_RESOURCE_NAME", "TPU_RESOURCE_NAME",
    "TaskStatus", "allocated_status", "get_task_status", "NodePhase",
    "NodeState", "ValidateResult", "FitError",
    "ObjectMeta", "Pod", "PodSpec", "PodStatus", "PodCondition", "Event",
    "Node", "NodeSpec",
    "NodeStatus", "Container", "ContainerPort", "Taint", "Toleration",
    "Affinity", "PriorityClass", "pod_key", "get_pod_resource_request",
    "get_pod_resource_without_init_containers",
    "TaskInfo", "JobInfo", "get_job_id", "job_terminated",
    "NodeInfo",
    "Queue", "QueueInfo", "queue_from_versioned",
    "PodGroup", "PodGroupCondition", "PodGroupSpec", "PodGroupStatus",
    "PodGroupPending", "PodGroupRunning", "PodGroupUnknown",
    "PodGroupUnschedulableType", "from_versioned", "to_versioned",
    "ClusterInfo",
]
