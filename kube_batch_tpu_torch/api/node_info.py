"""NodeInfo: per-node resource accounting.

Mirrors kube-batch pkg/scheduler/api/node_info.go, in particular the
status-dependent accounting in AddTask/RemoveTask (:172-259): a Releasing task
still holds Idle but contributes to Releasing; a Pipelined task consumes from
Releasing; everything else consumes Idle.  OutOfSync detection (:107-131)
excludes nodes whose Used exceeds allocatable.
"""

from __future__ import annotations

from typing import Dict, Optional

from .. import knobs
from .objects import Node, pod_key
from .resource import Resource
from .types import NodePhase, NodeState, TaskStatus
from .job_info import TaskInfo

LAZY_TASKS_ENV = knobs.LAZY_TASKS.env


def lazy_tasks_enabled() -> bool:
    """Lazy node-task view (default on): session node clones defer the
    per-resident ``clone_lite`` until something actually reads task
    values.  ``KUBE_BATCH_TPU_LAZY_TASKS=0`` restores the eager clones
    (the bit-parity control)."""
    return knobs.LAZY_TASKS.enabled()


class LazyTaskDict(dict):
    """``node.tasks`` for session node clones: live TaskInfo references
    plus the status each had when it entered the dict, materialized into
    the eager path's ``clone_lite`` copies only when task VALUES are
    read.

    The eager contract this preserves bit-for-bit: a stored entry is a
    ``clone_lite`` whose ``status`` is frozen at insert time (batch
    apply inserts BEFORE the deferred status-index moves; the cache
    snapshot copies before later cache churn), while every other
    ``clone_lite`` field is immutable-in-place framework-wide (resreq
    vectors are replaced wholesale, pods are shared by the clone
    anyway).  So a (live task, captured status) pair is enough to
    reproduce the clone on demand — and the steady-state micro-session,
    which writes placements into its node clones and then discards them
    at close, never pays for a single clone.

    Key-only operations (``in``, ``len``, iteration, ``keys``) never
    materialize; anything that can leak a value does.  Deleting or
    overwriting a key drops its pending record.  The native batch-apply
    walk (native/fastpath.c) detects this type via its ``_lazy`` attr
    and performs the same live insert + status capture in C."""

    __slots__ = ("_lazy",)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._lazy: Dict[str, object] = {}  # key -> insert-time status

    # -- lazy writes --------------------------------------------------

    def lazy_set(self, key: str, task: TaskInfo) -> None:
        """Insert a live task, deferring its ``clone_lite``."""
        dict.__setitem__(self, key, task)
        self._lazy[key] = task.status

    @classmethod
    def lazy_copy(cls, src: Dict[str, TaskInfo]) -> "LazyTaskDict":
        """Lazy twin of ``{k: t.clone_lite() for k, t in src.items()}``:
        shares the source's (node-private, status-drift-only) clones and
        captures their statuses now."""
        d = cls(src)
        lz = d._lazy
        for key, task in src.items():
            lz[key] = task.status
        return d

    def materialize(self) -> None:
        """Replace every pending live entry with its ``clone_lite`` —
        in place, so dict order is untouched (``__setitem__`` of an
        existing key keeps its position)."""
        lz = self._lazy
        if not lz:
            return
        self._lazy = {}
        raw_get = dict.__getitem__
        raw_set = dict.__setitem__
        for key, status in lz.items():
            clone = raw_get(self, key).clone_lite()
            if clone.status is not status:
                clone.status = status
            raw_set(self, key, clone)

    # -- value-leaking reads materialize first ------------------------

    def __getitem__(self, key):
        self.materialize()
        return dict.__getitem__(self, key)

    def get(self, key, default=None):
        self.materialize()
        return dict.get(self, key, default)

    def values(self):
        self.materialize()
        return dict.values(self)

    def items(self):
        self.materialize()
        return dict.items(self)

    def pop(self, *args):
        self.materialize()
        return dict.pop(self, *args)

    def popitem(self):
        self.materialize()
        return dict.popitem(self)

    def setdefault(self, key, default=None):
        self.materialize()
        return dict.setdefault(self, key, default)

    def copy(self):
        self.materialize()
        return dict(self)

    # -- writes drop stale pending records -----------------------------

    def __setitem__(self, key, value):
        self._lazy.pop(key, None)
        dict.__setitem__(self, key, value)

    def __delitem__(self, key):
        self._lazy.pop(key, None)
        dict.__delitem__(self, key)

    def clear(self):
        self._lazy.clear()
        dict.clear(self)

    def update(self, *args, **kwargs):
        self.materialize()  # pending map now empty; plain update is safe
        dict.update(self, *args, **kwargs)


def lazy_insert(tasks: Dict[str, TaskInfo], key: str,
                task: TaskInfo) -> None:
    """Batch-apply insert: defer the clone when the node's task view is
    lazy, else the eager ``clone_lite`` (plain cache dicts, gate off)."""
    if type(tasks) is LazyTaskDict:
        tasks.lazy_set(key, task)
    else:
        tasks[key] = task.clone_lite()


class NodeInfo:

    def __init__(self, node: Optional[Node] = None):
        self.name: str = ""
        # Cache-mutation stamp (see JobInfo.mod_epoch).
        self.mod_epoch: int = 0
        self.node: Optional[Node] = None
        self.state: NodeState = NodeState()
        self.releasing: Resource = Resource.empty()
        self.idle: Resource = Resource.empty()
        self.used: Resource = Resource.empty()
        self.allocatable: Resource = Resource.empty()
        self.capability: Resource = Resource.empty()
        self.tasks: Dict[str, TaskInfo] = {}
        if node is not None:
            self.name = node.name
            self.node = node
            self.idle = Resource.from_resource_list(node.status.allocatable)
            self.allocatable = Resource.from_resource_list(node.status.allocatable)
            self.capability = Resource.from_resource_list(node.status.capacity)
        self._set_node_state(node)

    # -- state --------------------------------------------------------------

    def _set_node_state(self, node: Optional[Node]) -> None:
        if node is None:
            self.state = NodeState(NodePhase.NotReady, "UnInitialized")
            return
        if not self.used.less_equal(Resource.from_resource_list(node.status.allocatable)):
            self.state = NodeState(NodePhase.NotReady, "OutOfSync")
            return
        self.state = NodeState(NodePhase.Ready, "")

    def ready(self) -> bool:
        return self.state.phase == NodePhase.Ready

    def set_node(self, node: Node) -> None:
        """Refresh from the cluster object, rebuilding accounting from the
        resident tasks (node_info.go:134-158)."""
        self._set_node_state(node)
        if not self.ready():
            return
        self.name = node.name
        self.node = node
        self.allocatable = Resource.from_resource_list(node.status.allocatable)
        self.capability = Resource.from_resource_list(node.status.capacity)
        self.idle = Resource.from_resource_list(node.status.allocatable)
        self.used = Resource.empty()
        self.releasing = Resource.empty()
        for task in self.tasks.values():
            if task.status == TaskStatus.Releasing:
                self.releasing.add(task.resreq)
            self.idle.sub(task.resreq)
            self.used.add(task.resreq)

    # -- task accounting ----------------------------------------------------

    def _allocate_idle(self, ti: TaskInfo) -> None:
        if not ti.resreq.less_equal(self.idle):
            raise ValueError("Selected node NotReady")
        self.idle.sub(ti.resreq)

    def add_task(self, task: TaskInfo) -> None:
        """Account a task onto this node (node_info.go:172-220).  On error the
        task and node are left untouched."""
        if task.node_name and self.name and task.node_name != self.name:
            raise ValueError(
                f"task {task.namespace}/{task.name} already on different "
                f"node {task.node_name}")
        key = pod_key(task.pod)
        if key in self.tasks:
            raise ValueError(
                f"task {task.namespace}/{task.name} already on node {self.name}")
        # The node holds a clone so later task-status churn can't corrupt
        # node accounting.
        ti = task.clone()
        if self.node is not None:
            if ti.status == TaskStatus.Releasing:
                self._allocate_idle(ti)
                self.releasing.add(ti.resreq)
            elif ti.status == TaskStatus.Pipelined:
                self.releasing.sub(ti.resreq)
            else:
                self._allocate_idle(ti)
            self.used.add(ti.resreq)
        task.node_name = self.name
        ti.node_name = self.name
        self.tasks[key] = ti

    def remove_task(self, ti: TaskInfo) -> None:
        """Reverse of add_task (node_info.go:223-248)."""
        key = pod_key(ti.pod)
        task = self.tasks.get(key)
        if task is None:
            raise KeyError(
                f"failed to find task {ti.namespace}/{ti.name} on host {self.name}")
        if self.node is not None:
            if task.status == TaskStatus.Releasing:
                self.releasing.sub(task.resreq)
                self.idle.add(task.resreq)
            elif task.status == TaskStatus.Pipelined:
                self.releasing.add(task.resreq)
            else:
                self.idle.add(task.resreq)
            self.used.sub(task.resreq)
        del self.tasks[key]

    def update_task(self, ti: TaskInfo) -> None:
        self.remove_task(ti)
        self.add_task(ti)

    def release_resident(self, ti: TaskInfo) -> None:
        """update_task fast path for an idle-consuming resident moving
        to Releasing (the batched commit flush's truth mirror,
        cache.evict_many): end state identical to
        ``update_task(ti-with-status-Releasing)`` — releasing grows by
        the stored resreq, idle/used are net-unchanged, the stored
        entry moves to the END of the tasks dict exactly as the
        remove+add round trip leaves it (snapshot/occupancy walks
        iterate this dict; order is part of the bit-parity contract) —
        without the redundant already-resident validations, the idle
        add/sub round trip, or the fresh clone (the stored clone is
        node-private; only its status flips).  Falls back to the exact
        remove+add pair for Releasing/Pipelined residents, whose
        transition arithmetic is not a pure releasing add."""
        key = pod_key(ti.pod)
        task = self.tasks.get(key)
        if task is None:
            raise KeyError(
                f"failed to find task {ti.namespace}/{ti.name} on host "
                f"{self.name}")
        if task.status in (TaskStatus.Releasing, TaskStatus.Pipelined):
            self.update_task(ti)
            return
        if self.node is not None:
            self.releasing.add(task.resreq)
        task.status = TaskStatus.Releasing
        del self.tasks[key]
        self.tasks[key] = task

    def pods(self):
        tmap = self.tasks
        if type(tmap) is LazyTaskDict:
            # Pods are shared by clone_lite anyway — read the live
            # entries without forcing materialization.
            return [t.pod for t in dict.values(tmap)]
        return [t.pod for t in tmap.values()]

    def clone(self) -> "NodeInfo":
        """Deep clone (node_info.go NodeInfo.Clone contract)."""
        res = self.snapshot_clone()
        for task in res.tasks.values():
            task.resreq = task.resreq.clone()
            task.init_resreq = task.init_resreq.clone()
        return res

    def snapshot_clone(self) -> "NodeInfo":
        """Field-wise session-snapshot clone: copies the accounting vectors
        directly instead of re-parsing resource lists and replaying
        add_task per resident task, and shares the (never mutated in place)
        task resreq vectors — the snapshot path clones every node every
        session."""
        res = NodeInfo.__new__(NodeInfo)
        res.name = self.name
        res.node = self.node
        res.state = self.state
        res.releasing = self.releasing.clone()
        res.idle = self.idle.clone()
        res.used = self.used.clone()
        # Shared, not cloned: nothing mutates allocatable/capability in
        # place — node updates replace them wholesale via
        # from_resource_list (set_node), and plugins only read them.
        res.allocatable = self.allocatable
        res.capability = self.capability
        src = self.tasks
        if type(src) is LazyTaskDict:
            # Cloning a lazy view (session-node clone() calls, nested
            # snapshots): settle its pending entries first so the copy
            # below never chains live references through two layers.
            src.materialize()
        if lazy_tasks_enabled():
            res.tasks = LazyTaskDict.lazy_copy(src) if src \
                else LazyTaskDict()
            return res
        # The C fast path (native/) is not ported: the Python loop, the
        # reference's NO_NATIVE arm (ROADMAP queue 1 item 10).
        res.tasks = {key: task.clone_lite() for key, task in src.items()}
        return res

    def __repr__(self) -> str:
        return (f"NodeInfo({self.name}: idle <{self.idle}>, used <{self.used}>, "
                f"releasing <{self.releasing}>)")
