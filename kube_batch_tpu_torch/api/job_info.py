"""TaskInfo and JobInfo: the scheduler's working units.

Mirrors kube-batch pkg/scheduler/api/job_info.go: TaskInfo construction
from a pod (:69-93), the JobInfo TaskStatusIndex invariants (:233-295), and
gang-readiness accounting (:383-434).
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import Dict, List, Optional

from ..apis.scheduling.v1alpha1 import GroupNameAnnotationKey
from .objects import Pod, pod_key, get_pod_resource_request, \
    get_pod_resource_without_init_containers
from .pod_group_info import PodGroup
from .resource import Resource
from .types import TaskStatus, allocated_status, get_task_status


def get_job_id(pod: Pod) -> str:
    """namespace/group-name from the pod's group annotation (job_info.go:56-66)."""
    group = pod.metadata.annotations.get(GroupNameAnnotationKey, "")
    if group:
        return f"{pod.metadata.namespace}/{group}"
    return ""


class TaskInfo:
    """Scheduler view of one pod (job_info.go:36-54)."""

    __slots__ = ("uid", "job", "name", "namespace", "resreq", "init_resreq",
                 "node_name", "status", "priority", "volume_ready", "pod")

    def __init__(self, pod: Pod):
        self.uid: str = pod.metadata.uid
        self.job: str = get_job_id(pod)
        self.name: str = pod.metadata.name
        self.namespace: str = pod.metadata.namespace
        # Resreq: steady-state request; InitResreq: launch requirement
        # including init containers (job_info.go:70-71).
        self.resreq: Resource = get_pod_resource_without_init_containers(pod)
        self.init_resreq: Resource = get_pod_resource_request(pod)
        self.node_name: str = pod.spec.node_name
        self.status: TaskStatus = get_task_status(pod)
        self.priority: int = pod.spec.priority if pod.spec.priority is not None else 1
        self.volume_ready: bool = False
        self.pod: Pod = pod

    def clone(self) -> "TaskInfo":
        ti = self.clone_lite()
        ti.resreq = self.resreq.clone()
        ti.init_resreq = self.init_resreq.clone()
        return ti

    def clone_lite(self) -> "TaskInfo":
        """Clone sharing the resreq/init_resreq vectors.  They are never
        mutated in place anywhere in the framework (pod updates replace
        them wholesale), so the snapshot and batch-apply hot paths — which
        clone every task every session — use this form; ``clone`` keeps the
        reference's deep-copy contract (job_info.go TaskInfo.Clone)."""
        ti = TaskInfo.__new__(TaskInfo)
        ti.uid = self.uid
        ti.job = self.job
        ti.name = self.name
        ti.namespace = self.namespace
        ti.resreq = self.resreq
        ti.init_resreq = self.init_resreq
        ti.node_name = self.node_name
        ti.status = self.status
        ti.priority = self.priority
        ti.volume_ready = self.volume_ready
        ti.pod = self.pod
        return ti

    def __repr__(self) -> str:
        return (f"Task({self.namespace}/{self.name}: job {self.job}, "
                f"status {self.status.name}, pri {self.priority})")


class JobInfo:
    """All tasks of one job plus gang/fairness accounting (job_info.go:127-154)."""

    def __init__(self, uid: str, *tasks: TaskInfo):
        self.uid: str = uid
        # Cache-mutation stamp (SchedulerCache.epoch at last informer
        # touch); drives snapshot-clone and tensor-block reuse.
        self.mod_epoch: int = 0
        self.name: str = ""
        self.namespace: str = ""
        self.queue: str = ""
        self.priority: int = 0
        self.min_available: int = 0
        self.node_selector: Dict[str, str] = {}
        # node name -> leftover-after-fit vector for fit-error reporting.
        self.nodes_fit_delta: Dict[str, Resource] = {}
        self.task_status_index: Dict[TaskStatus, Dict[str, TaskInfo]] = defaultdict(dict)
        # Memoized ready_task_num; every status-index mutation resets it
        # to None.  The gang job-order comparator reads readiness per
        # heap comparison (thousands of times per preemption storm), so
        # recounting the buckets per call dominated the comparators.
        self._ready_num = None
        self.tasks: Dict[str, TaskInfo] = {}
        self.allocated: Resource = Resource.empty()
        self.total_request: Resource = Resource.empty()
        self.creation_timestamp: float = 0.0
        self.pod_group: Optional[PodGroup] = None
        self.pdb = None  # legacy PodDisruptionBudget gang source
        for task in tasks:
            self.add_task_info(task)

    # -- podgroup wiring ----------------------------------------------------

    def set_pod_group(self, pg: PodGroup) -> None:
        self.name = pg.metadata.name
        self.namespace = pg.metadata.namespace
        self.min_available = pg.spec.min_member
        self.queue = pg.spec.queue
        self.creation_timestamp = pg.metadata.creation_timestamp
        self.pod_group = pg

    def unset_pod_group(self) -> None:
        self.pod_group = None

    def set_pdb(self, pdb) -> None:
        """Legacy gang source (job_info.go:196-204)."""
        self.name = pdb.metadata.name
        self.min_available = pdb.min_available
        self.namespace = pdb.metadata.namespace
        self.creation_timestamp = pdb.metadata.creation_timestamp
        self.pdb = pdb

    def unset_pdb(self) -> None:
        self.pdb = None

    # -- task bookkeeping (invariant-preserving) ----------------------------

    def add_task_info(self, ti: TaskInfo) -> None:
        self.tasks[ti.uid] = ti
        self.task_status_index[ti.status][ti.uid] = ti
        self._ready_num = None
        self.total_request.add(ti.resreq)
        if allocated_status(ti.status):
            self.allocated.add(ti.resreq)

    def delete_task_info(self, ti: TaskInfo) -> None:
        task = self.tasks.get(ti.uid)
        if task is None:
            raise KeyError(
                f"failed to find task {ti.namespace}/{ti.name} in job "
                f"{self.namespace}/{self.name}")
        self.total_request.sub(task.resreq)
        if allocated_status(task.status):
            self.allocated.sub(task.resreq)
        del self.tasks[task.uid]
        self._ready_num = None
        index = self.task_status_index.get(task.status)
        if index is not None:
            index.pop(task.uid, None)
            if not index:
                del self.task_status_index[task.status]

    def update_task_status(self, task: TaskInfo, status: TaskStatus) -> None:
        """Move a task between status buckets (job_info.go:252-271)."""
        if task.uid in self.tasks:
            self.delete_task_info(task)
        task.status = status
        self.add_task_info(task)

    def move_task_index(self, task: TaskInfo, status: TaskStatus) -> None:
        """Move only the status index (callers settle the allocated vector
        themselves — the batch-apply path adds one per-job aggregate
        instead of one vector op per task)."""
        self._ready_num = None
        index = self.task_status_index.get(task.status)
        if index is not None:
            index.pop(task.uid, None)
            if not index:
                del self.task_status_index[task.status]
        task.status = status
        self.task_status_index[status][task.uid] = task
        self.tasks[task.uid] = task

    def move_task_status(self, task: TaskInfo, status: TaskStatus) -> None:
        """update_task_status fast path for a task already tracked by this
        job: moves only the status index and the allocated vector
        (total_request is invariant), skipping the delete/re-add Resource
        churn.  Same end state as update_task_status."""
        was_alloc = allocated_status(task.status)
        self.move_task_index(task, status)
        now_alloc = allocated_status(status)
        if now_alloc and not was_alloc:
            self.allocated.add(task.resreq)
        elif was_alloc and not now_alloc:
            self.allocated.sub(task.resreq)

    def release_task(self, task: TaskInfo) -> None:
        """update_task_status(task, Releasing) fast path for a task this
        job already tracks — the SESSION-clone twin of the truth mirror's
        fused transition in ``SchedulerCache.evict_many`` (the eviction
        decision walk calls this once per victim, so the delete/re-add
        Resource churn was the walk's per-task floor).  End state
        identical, including the dict-order side effect: the task lands
        at the END of ``tasks`` exactly as delete_task_info/add_task_info
        leave it (snapshot and tensorize iteration order feed the
        solver's tie-breaks, so order is part of the bit-parity
        contract).  Falls back to the exact slow path when the passed
        object is not the tracked one with a matching status (the slow
        path's bucket removal keys on the TRACKED entry's status)."""
        tracked = self.tasks.get(task.uid)
        if tracked is None or tracked.status != task.status:
            self.update_task_status(task, TaskStatus.Releasing)
            return
        self.move_task_status(task, TaskStatus.Releasing)
        del self.tasks[task.uid]
        self.tasks[task.uid] = task

    def get_tasks(self, *statuses: TaskStatus) -> List[TaskInfo]:
        out: List[TaskInfo] = []
        for status in statuses:
            out.extend(t.clone() for t in self.task_status_index.get(status, {}).values())
        return out

    # -- gang accounting (job_info.go:383-434) ------------------------------

    def ready_task_num(self) -> int:
        n = self._ready_num
        if n is None:
            n = 0
            for status, tasks in self.task_status_index.items():
                if allocated_status(status) or status == TaskStatus.Succeeded:
                    n += len(tasks)
            self._ready_num = n
        return n

    def waiting_task_num(self) -> int:
        return len(self.task_status_index.get(TaskStatus.Pipelined, {}))

    def valid_task_num(self) -> int:
        n = 0
        for status, tasks in self.task_status_index.items():
            if (allocated_status(status) or status in
                    (TaskStatus.Succeeded, TaskStatus.Pipelined, TaskStatus.Pending)):
                n += len(tasks)
        return n

    def ready(self) -> bool:
        return self.ready_task_num() >= self.min_available

    def pipelined(self) -> bool:
        return self.waiting_task_num() + self.ready_task_num() >= self.min_available

    # -- diagnostics --------------------------------------------------------

    def fit_error(self) -> str:
        """Histogram of insufficient resources across nodes (job_info.go:348-380)."""
        if not self.nodes_fit_delta:
            return "0 nodes are available"
        reasons: Dict[str, int] = defaultdict(int)
        for delta in self.nodes_fit_delta.values():
            if delta.get("cpu") < 0:
                reasons["cpu"] += 1
            if delta.get("memory") < 0:
                reasons["memory"] += 1
            for name, q in delta.scalar_resources.items():
                if q < 0:
                    reasons[name] += 1
        parts = sorted(f"{count} insufficient {name}" for name, count in reasons.items())
        return (f"0/{len(self.nodes_fit_delta)} nodes are available, "
                f"{', '.join(parts)}.")

    def clone(self) -> "JobInfo":
        """Deep clone (job_info.go JobInfo.Clone contract)."""
        info = self.snapshot_clone()
        for task in info.tasks.values():
            task.resreq = task.resreq.clone()
            task.init_resreq = task.init_resreq.clone()
        return info

    def snapshot_clone(self) -> "JobInfo":
        """Session-snapshot clone: task resreq/init_resreq vectors are
        shared (framework code never mutates them in place), halving the
        allocation cost of cloning every job every cycle."""
        info = JobInfo(self.uid)
        info.name = self.name
        info.namespace = self.namespace
        info.queue = self.queue
        info.priority = self.priority
        info.min_available = self.min_available
        info.node_selector = dict(self.node_selector)
        info.creation_timestamp = self.creation_timestamp
        info.pod_group = (self.pod_group.clone()
                          if self.pod_group is not None else None)
        info.pdb = self.pdb
        # Copy the aggregates instead of re-deriving them per task through
        # add_task_info: they are invariants of the task set.
        info.total_request = self.total_request.clone()
        info.allocated = self.allocated.clone()
        from ..native import clone_task_map
        if clone_task_map is not None:
            tasks, index = clone_task_map(self.tasks)
            info.tasks = tasks
            info.task_status_index.update(index)
        else:
            tasks = info.tasks
            index = info.task_status_index
            for uid, task in self.tasks.items():
                t = task.clone_lite()
                tasks[uid] = t
                index[t.status][uid] = t
        return info

    def __repr__(self) -> str:
        return (f"Job({self.uid}: queue {self.queue}, minAvailable "
                f"{self.min_available}, tasks {len(self.tasks)})")


def job_terminated(job: JobInfo) -> bool:
    """Job has no group/PDB and no tasks left (helpers.go:115-119)."""
    return job.pod_group is None and job.pdb is None and not job.tasks
