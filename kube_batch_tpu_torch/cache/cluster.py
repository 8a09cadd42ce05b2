"""Cluster: an in-memory cluster-state store with watch semantics.

Counterpart of kube_batch_tpu/cache/cluster.py, copied whole (host
Python).  The tenancy, federation and end-to-end tests drive the port's
Scheduler against it.

The reference's communication backend is the Kubernetes API server spoken via
client-go informers (watch in) and REST effectors (bind/evict/status out) —
SURVEY.md §2.2.  This framework is standalone: ``Cluster`` is the durable
cluster-state store, ``Informer`` fans change events to registered handlers
(the SchedulerCache), and ``ClusterBinder``/``ClusterEvictor``/
``ClusterStatusUpdater`` are the effectors that write decisions back.  The
kind/kubemark e2e harnesses of the reference map onto driving this simulator.
"""

from __future__ import annotations

import copy
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

from ..api.objects import (Event, Node, PersistentVolumeClaim, Pod,
                           PodCondition, PriorityClass)
from .interface import Binder, Evictor, StatusUpdater, VolumeBinder


class EventLog:
    """Bounded, listable event store (the apiserver's event retention
    analog).  Events are append-only and best-effort: overflow drops the
    oldest, exactly how a real cluster's TTL'd events age out."""

    def __init__(self, maxlen: int = 10000):
        from collections import deque
        self._items = deque(maxlen=maxlen)
        self._seq = itertools.count()

    def append(self, event: Event) -> Event:
        if not event.metadata.name:
            event.metadata.name = f"ev-{next(self._seq)}"
        if not event.timestamp:
            event.timestamp = time.time()
        self._items.append(event)
        return event

    def values(self):
        return list(self._items)

    def __len__(self) -> int:
        return len(self._items)


class Informer:
    """Fan-out of add/update/delete events for one resource kind."""

    def __init__(self):
        self.handlers: List[dict] = []

    def add_handlers(self, on_add=None, on_update=None, on_delete=None,
                     filter_fn=None) -> dict:
        handle = dict(add=on_add, update=on_update,
                      delete=on_delete, filter=filter_fn)
        self.handlers.append(handle)
        return handle

    def remove_handlers(self, handle: dict) -> None:
        """Unregister (watch connections come and go at the network edge)."""
        try:
            self.handlers.remove(handle)
        except ValueError:
            pass

    def _fire(self, kind: str, *args):
        # Snapshot: watch connections unregister concurrently (remove_handlers
        # from a dying stream thread must not shift live iteration indices).
        for h in list(self.handlers):
            if h["filter"] is not None and not h["filter"](args[-1]):
                continue
            fn = h[kind]
            if fn is not None:
                fn(*args)

    def fire_add(self, obj):
        self._fire("add", obj)

    def fire_update(self, old, new):
        self._fire("update", old, new)

    def fire_delete(self, obj):
        self._fire("delete", obj)


class _RvClock:
    """next()-compatible resource-version source: max(prev+1, now_µs)."""

    def __init__(self):
        self._last = 0

    def __next__(self) -> int:
        self._last = max(self._last + 1, int(time.time() * 1e6))
        return self._last

    def __iter__(self):
        return self


class Cluster:
    """In-memory object store + informers; the simulated API server."""

    def __init__(self, auto_run_bound_pods: bool = True):
        self.lock = threading.RLock()
        # Verb handlers run on arbitrary caller threads (edge server
        # workers, tests, the scheduler's effectors); the object stores
        # are lock-guarded and graftlint enforces it (doc/LINT.md).
        self.pods: Dict[str, Pod] = {}                 # guarded-by: lock
        self.nodes: Dict[str, Node] = {}               # guarded-by: lock
        self.pod_groups: Dict[str, object] = {}        # guarded-by: lock
        self.queues: Dict[str, object] = {}            # guarded-by: lock
        self.priority_classes: Dict[str, PriorityClass] = {}  # guarded-by: lock
        self.pdbs: Dict[str, object] = {}              # guarded-by: lock
        self.pvcs: Dict[str, PersistentVolumeClaim] = {}  # guarded-by: lock
        self.pod_informer = Informer()
        self.node_informer = Informer()
        self.pod_group_informer = Informer()
        self.queue_informer = Informer()
        self.priority_class_informer = Informer()
        self.pdb_informer = Informer()
        # Cluster event stream (list-only, like a real apiserver's
        # TTL-bounded events; reference recorder cache.go:238-240).
        self.events = EventLog()
        # Leader-election leases: key -> (resource_version, record dict).
        # (guarded-by: lock — annotated below on the assignment.)
        # The ConfigMap-lock analog (reference server.go:115-139): any
        # standby anywhere coordinates through the store via CAS on the
        # version, like resourceVersion-guarded ConfigMap updates.
        self.leases: Dict[str, tuple] = {}             # guarded-by: lock
        # Kubelet stand-in: a bound pod starts Running immediately.
        self.auto_run_bound_pods = auto_run_bound_pods
        # Resource-version clock (lease CAS versions, watch-resume rvs):
        # strictly increasing AND never behind the wall clock in µs, so
        # versions stay monotonic across a full process restart — a
        # client resuming against a REBUILT cluster falls below the new
        # watch watermark (410 -> relist), never silently "resumes"
        # (etcd revisions give real apiservers the same property; only a
        # sustained >1M events/s burst could outrun this clock).
        self._rv = _RvClock()

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _pod_key(pod: Pod) -> str:
        return f"{pod.metadata.namespace}/{pod.metadata.name}"

    def get_pod(self, namespace: str, name: str) -> Optional[Pod]:
        with self.lock:
            return self.pods.get(f"{namespace}/{name}")

    # -- pod verbs ----------------------------------------------------------

    def create_pod(self, pod: Pod) -> Pod:
        with self.lock:
            key = self._pod_key(pod)
            if key in self.pods:
                raise ValueError(f"pod {key} already exists")
            if not pod.metadata.creation_timestamp:
                pod.metadata.creation_timestamp = time.time()
            self.pods[key] = pod
            self.pod_informer.fire_add(pod)
            return pod

    def update_pod(self, pod: Pod) -> Pod:
        with self.lock:
            key = self._pod_key(pod)
            old = self.pods.get(key)
            if old is None:
                raise KeyError(f"pod {key} not found")
            self.pods[key] = pod
            self.pod_informer.fire_update(old, pod)
            return pod

    def update_pod_condition(self, namespace: str, name: str,
                             condition: PodCondition) -> Pod:
        """The pod ``status`` subresource write taskUnschedulable performs
        (cache.go:548-568): upsert the condition by type and fire
        MODIFIED so watchers see why the pod is stuck."""
        with self.lock:
            key = f"{namespace}/{name}"
            pod = self.pods.get(key)
            if pod is None:
                raise KeyError(f"pod {key} not found")
            old = copy.deepcopy(pod)
            for i, cond in enumerate(pod.status.conditions):
                if cond.type == condition.type:
                    if (cond.status == condition.status
                            and cond.reason == condition.reason
                            and cond.message == condition.message):
                        return pod  # no-op write, like UpdatePodCondition
                    pod.status.conditions[i] = condition
                    break
            else:
                pod.status.conditions.append(condition)
            self.pod_informer.fire_update(old, pod)
            return pod

    def put_pod_status(self, namespace: str, name: str, status) -> Pod:
        """Full status-subresource replace (a real apiserver
        UpdateStatus): phase AND conditions from the body take effect —
        not just conditions, which silently dropped phase writes
        (ADVICE r3 #4)."""
        with self.lock:
            key = f"{namespace}/{name}"
            pod = self.pods.get(key)
            if pod is None:
                raise KeyError(f"pod {key} not found")
            if (pod.status.phase == status.phase
                    and pod.status.conditions == status.conditions):
                return pod  # no-op write
            old = copy.deepcopy(pod)
            pod.status = status
            self.pod_informer.fire_update(old, pod)
            return pod

    def create_event(self, event: Event) -> Event:
        with self.lock:
            return self.events.append(event)

    # -- leader-election lease verbs ----------------------------------------

    def get_lease(self, namespace: str, name: str):
        """(resource_version, record) or (0, None) when absent."""
        with self.lock:
            entry = self.leases.get(f"{namespace}/{name}")
            return entry if entry is not None else (0, None)

    def cas_lease(self, namespace: str, name: str, record: dict,
                  expected_version: int) -> int:
        """Compare-and-swap the lease record; returns the new version or
        raises ValueError on a version conflict (the apiserver's
        resourceVersion-guarded update)."""
        with self.lock:
            key = f"{namespace}/{name}"
            current = self.leases.get(key, (0, None))[0]
            if current != expected_version:
                raise ValueError(
                    f"lease {key} version conflict "
                    f"(have {current}, expected {expected_version})")
            version = next(self._rv)
            self.leases[key] = (version, dict(record))
            return version

    def delete_pod(self, namespace: str, name: str) -> None:
        """Pod deletion; mirrors the two-phase delete the scheduler sees:
        a deletionTimestamp update (-> Releasing) then removal."""
        with self.lock:
            key = f"{namespace}/{name}"
            pod = self.pods.get(key)
            if pod is None:
                raise KeyError(f"pod {key} not found")
            old = copy.deepcopy(pod)
            pod.metadata.deletion_timestamp = time.time()
            self.pod_informer.fire_update(old, pod)
            del self.pods[key]
            self.pod_informer.fire_delete(pod)

    def bind_pod(self, namespace: str, name: str, hostname: str) -> None:
        """The /bind subresource (reference cache.go:119-131)."""
        with self.lock:
            key = f"{namespace}/{name}"
            pod = self.pods.get(key)
            if pod is None:
                raise KeyError(f"pod {key} not found")
            if pod.spec.node_name:
                # Real-apiserver semantics (409 Conflict at the edge):
                # nodeName is immutable once set.  A stale-mirror
                # scheduler re-POSTing a bind must be REJECTED, never
                # silently re-assigned — the truth store enforces the
                # no-double-bind invariant, resync heals the sender.
                raise ValueError(
                    f"pod {key} is already assigned to node "
                    f"{pod.spec.node_name}")
            if hostname not in self.nodes:
                raise KeyError(f"node {hostname} not found")
            old = copy.deepcopy(pod)
            pod.spec.node_name = hostname
            if self.auto_run_bound_pods:
                pod.status.phase = "Running"
            self.pod_informer.fire_update(old, pod)

    # -- node verbs ---------------------------------------------------------

    def create_node(self, node: Node) -> Node:
        with self.lock:
            self.nodes[node.name] = node
            self.node_informer.fire_add(node)
            return node

    def update_node(self, node: Node) -> Node:
        with self.lock:
            old = self.nodes.get(node.name)
            self.nodes[node.name] = node
            if old is None:
                self.node_informer.fire_add(node)
            else:
                self.node_informer.fire_update(old, node)
            return node

    def delete_node(self, name: str) -> None:
        with self.lock:
            node = self.nodes.pop(name, None)
            if node is not None:
                self.node_informer.fire_delete(node)

    # -- CRD verbs ----------------------------------------------------------

    def create_pod_group(self, pg) -> object:
        with self.lock:
            key = f"{pg.metadata.namespace}/{pg.metadata.name}"
            if not pg.metadata.creation_timestamp:
                pg.metadata.creation_timestamp = time.time()
            self.pod_groups[key] = pg
            self.pod_group_informer.fire_add(pg)
            return pg

    def update_pod_group(self, pg) -> object:
        with self.lock:
            key = f"{pg.metadata.namespace}/{pg.metadata.name}"
            old = self.pod_groups.get(key)
            self.pod_groups[key] = pg
            if old is None:
                self.pod_group_informer.fire_add(pg)
            else:
                self.pod_group_informer.fire_update(old, pg)
            return pg

    def delete_pod_group(self, namespace: str, name: str) -> None:
        with self.lock:
            pg = self.pod_groups.pop(f"{namespace}/{name}", None)
            if pg is not None:
                self.pod_group_informer.fire_delete(pg)

    def put_pod_group_status(self, pg) -> object:
        """Status-subresource write.  Fires MODIFIED like a real
        apiserver's UpdateStatus: other watchers (second schedulers,
        monitors) must see condition writes without waiting for a relist;
        the writer's own cache handling of the echo is idempotent."""
        with self.lock:
            key = f"{pg.metadata.namespace}/{pg.metadata.name}"
            old = self.pod_groups.get(key)
            if old is None:
                # A status write racing a delete must surface as 404 at
                # the edge, not a silent 200 (real apiserver semantics).
                raise KeyError(f"podgroups \"{key}\" not found")
            self.pod_groups[key] = pg
            self.pod_group_informer.fire_update(old, pg)
            return pg

    def create_queue(self, queue) -> object:
        with self.lock:
            self.queues[queue.metadata.name] = queue
            self.queue_informer.fire_add(queue)
            return queue

    def delete_queue(self, name: str) -> None:
        with self.lock:
            q = self.queues.pop(name, None)
            if q is not None:
                self.queue_informer.fire_delete(q)

    def create_priority_class(self, pc: PriorityClass) -> PriorityClass:
        with self.lock:
            self.priority_classes[pc.metadata.name] = pc
            self.priority_class_informer.fire_add(pc)
            return pc

    def create_pvc(self, pvc: PersistentVolumeClaim) -> PersistentVolumeClaim:
        with self.lock:
            key = f"{pvc.metadata.namespace}/{pvc.metadata.name}"
            self.pvcs[key] = pvc
            return pvc

    def bind_pvc(self, namespace: str, name: str, volume_name: str) -> None:
        with self.lock:
            pvc = self.pvcs.get(f"{namespace}/{name}")
            if pvc is None:
                raise KeyError(f"pvc {namespace}/{name} not found")
            pvc.phase = "Bound"
            pvc.volume_name = volume_name

    def create_pdb(self, pdb) -> object:
        with self.lock:
            key = f"{pdb.metadata.namespace}/{pdb.metadata.name}"
            self.pdbs[key] = pdb
            self.pdb_informer.fire_add(pdb)
            return pdb

    def delete_pdb(self, namespace: str, name: str) -> None:
        with self.lock:
            pdb = self.pdbs.pop(f"{namespace}/{name}", None)
            if pdb is not None:
                self.pdb_informer.fire_delete(pdb)


class ClusterBinder(Binder):
    """Real binder against the simulator (reference cache.go:113-131)."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def bind(self, pod, hostname: str) -> None:
        self.cluster.bind_pod(pod.metadata.namespace, pod.metadata.name, hostname)

    def bind_many(self, pairs) -> list:
        # A remote edge amortizes the wire: concurrent keep-alive
        # connections instead of one serial round trip per bind
        # (edge/client.py bind_pods_many — the goroutine-per-bind analog).
        many = getattr(self.cluster, "bind_pods_many", None)
        if many is not None:
            return many(pairs)
        return super().bind_many(pairs)


class ClusterEvictor(Evictor):
    """Evicts by deleting the pod (reference cache.go:138-146)."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def evict(self, pod) -> None:
        self.cluster.delete_pod(pod.metadata.namespace, pod.metadata.name)

    def evict_many(self, pods) -> list:
        # A remote edge amortizes the wire: concurrent keep-alive
        # connections instead of one serial round trip per evict
        # (edge/client.py evict_pods_many — the bind_pods_many twin).
        many = getattr(self.cluster, "evict_pods_many", None)
        if many is not None:
            return many(pods)
        return super().evict_many(pods)


class ClusterVolumeBinder(VolumeBinder):
    """Two-phase volume binding against the simulator's PVC store: the
    analog of the reference's VolumeBinder (cache.go:538-546 AllocateVolumes
    assumes claims for a host; BindVolumes commits them)."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self.assumed: Dict[str, str] = {}  # pvc key -> node

    def allocate_volumes(self, task, hostname: str) -> None:
        for claim in task.pod.spec.volumes:
            key = f"{task.namespace}/{claim}"
            with self.cluster.lock:
                pvc = self.cluster.pvcs.get(key)
            if pvc is None:
                raise KeyError(
                    f"pod {task.namespace}/{task.name} references missing "
                    f"PVC {claim}")
            self.assumed[key] = hostname

    def bind_volumes(self, task) -> None:
        for claim in task.pod.spec.volumes:
            key = f"{task.namespace}/{claim}"
            if key in self.assumed:
                self.cluster.bind_pvc(task.namespace, claim, f"pv-{claim}")
                del self.assumed[key]
        task.volume_ready = True


class ClusterStatusUpdater(StatusUpdater):
    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def update_pod_condition(self, pod, condition) -> None:
        """Write PodScheduled=False/Unschedulable back to the cluster
        (cache.go:548-568: how users see WHY a pod is stuck)."""
        ctype, status, reason, message = condition
        # Client-side pre-check (upstream UpdatePodCondition): the mirror
        # pod carries the informer-echoed conditions, so an unchanged
        # stuck pod costs zero round-trips per cycle instead of one
        # blocking PUT over the edge.
        for cond in pod.status.conditions:
            if (cond.type == ctype and cond.status == status
                    and cond.reason == reason and cond.message == message):
                return
        try:
            self.cluster.update_pod_condition(
                pod.metadata.namespace, pod.metadata.name,
                PodCondition(type=ctype, status=status, reason=reason,
                             message=message))
        except (KeyError, OSError):
            # Pod deleted meanwhile (404) or the edge is unreachable:
            # log-and-continue semantics — a failed condition write must
            # never abort the session close.
            pass

    def update_pod_group(self, pg) -> None:
        from ..api.pod_group_info import PodGroup, to_versioned
        obj = to_versioned(pg) if isinstance(pg, PodGroup) else pg
        self.cluster.put_pod_group_status(obj)


class ClusterEventRecorder:
    """Event egress: the reference's record.EventBroadcaster analog.
    Asynchronous and best-effort — a daemon thread drains a bounded queue
    into the cluster's events resource, so a slow or unreachable edge
    never stalls the scheduling loop (events are TTL'd diagnostics, not
    state)."""

    # Matching the reference's event types: Scheduled AND Evict are
    # Normal (cache.go:474,481); scheduling failures are Warning.
    _NORMAL_REASONS = frozenset({"Scheduled", "Evict"})

    def __init__(self, cluster, maxlen: int = 10000):
        from collections import deque
        self.cluster = cluster
        self._queue = deque(maxlen=maxlen)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock
        self._lock = threading.Lock()

    def record(self, reason: str, object_key: str, message: str) -> None:
        self._queue.append(Event(
            involved_object=object_key, reason=reason, message=message,
            type=("Normal" if reason in self._NORMAL_REASONS
                  else "Warning")))
        if self._thread is None:
            with self._lock:
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._drain, daemon=True,
                        name="event-recorder")
                    self._thread.start()
        self._wake.set()

    def _drain(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(1.0)
            self._wake.clear()
            while self._queue:
                event = self._queue.popleft()
                try:
                    self.cluster.create_event(event)
                except Exception:
                    # Best-effort; dropped like an expired event — but
                    # countable, so a dead egress edge is visible.
                    from ..metrics import metrics
                    metrics.note_swallowed("event_egress")

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()

    def flush(self, timeout: float = 5.0) -> None:
        """Testing aid: wait until the queue drains."""
        deadline = time.time() + timeout
        while self._queue and time.time() < deadline:
            self._wake.set()
            time.sleep(0.01)


def connect_cache_to_cluster(cache, cluster: Cluster) -> None:
    """Register the cache's event handlers on the cluster's informers,
    mirroring the 12 informer registrations in reference cache.go:255-352
    (pods filtered by scheduler name and phase)."""

    def pod_filter(pod) -> bool:
        # cache.go:286-304, exactly: (Pending AND ours) OR (any phase
        # other than Pending, regardless of scheduler).  A non-Pending
        # pod of another scheduler is mirrored for resource accounting;
        # another scheduler's Pending pod is not — even if it already
        # carries a nodeName.
        if (pod.spec.scheduler_name == cache.scheduler_name
                and pod.status.phase == "Pending"):
            return True
        return pod.status.phase != "Pending"

    cluster.pod_informer.add_handlers(
        on_add=cache.add_pod, on_update=cache.update_pod,
        on_delete=cache.delete_pod, filter_fn=pod_filter)
    cluster.node_informer.add_handlers(
        on_add=cache.add_node, on_update=cache.update_node,
        on_delete=cache.delete_node)
    cluster.pod_group_informer.add_handlers(
        on_add=cache.add_pod_group, on_update=cache.update_pod_group,
        on_delete=cache.delete_pod_group)
    cluster.queue_informer.add_handlers(
        on_add=cache.add_queue, on_update=cache.update_queue,
        on_delete=cache.delete_queue)
    cluster.priority_class_informer.add_handlers(
        on_add=cache.add_priority_class, on_delete=cache.delete_priority_class)
    cluster.pdb_informer.add_handlers(
        on_add=cache.add_pdb, on_update=cache.update_pdb,
        on_delete=cache.delete_pdb)

    # Replay current state (informer initial LIST).
    with cluster.lock:
        for node in cluster.nodes.values():
            cache.add_node(node)
        for queue in cluster.queues.values():
            cache.add_queue(queue)
        for pc in cluster.priority_classes.values():
            cache.add_priority_class(pc)
        for pdb in cluster.pdbs.values():
            cache.add_pdb(pdb)
        for pg in cluster.pod_groups.values():
            cache.add_pod_group(pg)
        for pod in cluster.pods.values():
            if pod_filter(pod):
                cache.add_pod(pod)


def new_scheduler_cache(cluster: Cluster, scheduler_name: str = "kube-batch",
                        default_queue: str = "default",
                        priority_class_enabled: bool = True):
    """Build a fully-wired SchedulerCache over a Cluster (cache.go:223-352)."""
    from .cache import SchedulerCache
    cache = SchedulerCache(
        scheduler_name=scheduler_name, default_queue=default_queue,
        binder=ClusterBinder(cluster), evictor=ClusterEvictor(cluster),
        status_updater=ClusterStatusUpdater(cluster),
        volume_binder=ClusterVolumeBinder(cluster),
        priority_class_enabled=priority_class_enabled,
        event_recorder=ClusterEventRecorder(cluster))
    connect_cache_to_cluster(cache, cluster)
    if hasattr(cluster, "flush_pending"):
        # Remote mirror (edge/client.RemoteCluster): lazy-deferred
        # MODIFIED frames must be drained at every snapshot, and their
        # deferral must still wake the scheduler loop — the frame IS
        # external churn even when the dataclass is built later.
        cache.mirror_flush = cluster.flush_pending
        cluster.pending_churn = cache._note_churn
    return cache
