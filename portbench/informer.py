"""The benchmark's informer and effectors.

The informer feeds generated clusters and waves into the program's
``SchedulerCache`` through its handlers, as the informers of a real API
server would.  The binder stamps every bind with the host clock; the
status updater keeps each pod group's last status.  Nothing here decides
anything: the scheduler under test does.
"""

from __future__ import annotations

import threading
import time

from kube_batch_tpu_torch.api import (Container, Node, NodeSpec, NodeStatus,
                                      ObjectMeta, Pod, PodSpec, PodStatus,
                                      pod_key)
from kube_batch_tpu_torch.api.queue_info import Queue
from kube_batch_tpu_torch.apis.scheduling import v1alpha1
from kube_batch_tpu_torch.cache.interface import (Binder, Evictor,
                                                  StatusUpdater, VolumeBinder)


class StampBinder(Binder):
    """Records pod key -> node and the host time of every bind."""

    def __init__(self):
        self.lock = threading.Lock()
        self.nodes = {}     # guarded-by: lock
        self.stamps = {}    # guarded-by: lock

    def bind(self, pod, hostname: str) -> None:
        self.bind_many([(pod, hostname)])

    def bind_many(self, pairs) -> list:
        now = time.perf_counter()
        with self.lock:
            for pod, hostname in pairs:
                key = pod_key(pod)
                self.nodes[key] = hostname
                self.stamps[key] = now
        return []

    def take(self):
        """(nodes, stamps) recorded since the last take."""
        with self.lock:
            out = (self.nodes, self.stamps)
            self.nodes, self.stamps = {}, {}
        return out


class RecordingEvictor(Evictor):
    def __init__(self):
        self.evicted = []

    def evict(self, pod) -> None:
        self.evicted.append(pod_key(pod))


class StatusRecorder(StatusUpdater):
    """Keeps each pod group's last pushed status."""

    def __init__(self):
        self.groups = {}

    def update_pod_condition(self, pod, condition) -> None:
        pass

    def update_pod_group(self, pg) -> None:
        self.groups[f"{pg.metadata.namespace}/{pg.metadata.name}"] = \
            pg.status

    def take(self) -> dict:
        out, self.groups = self.groups, {}
        return out


class NullVolumeBinder(VolumeBinder):
    def allocate_volumes(self, task, hostname: str) -> None:
        pass

    def bind_volumes(self, task) -> None:
        pass


def new_cache():
    """A SchedulerCache wired to the benchmark's effectors."""
    from kube_batch_tpu_torch.cache import SchedulerCache
    return SchedulerCache(binder=StampBinder(), evictor=RecordingEvictor(),
                          status_updater=StatusRecorder(),
                          volume_binder=NullVolumeBinder())


def feed_cluster(cache, cluster) -> None:
    """Queues, then nodes, through the cache's handlers."""
    for name, weight, ts in zip(cluster.queue_names, cluster.queue_weights,
                                cluster.queue_ts):
        cache.add_queue(Queue(metadata=ObjectMeta(
            name=name, creation_timestamp=float(ts)), weight=int(weight)))
    alloc = cluster.node_alloc_raw
    for name in cluster.node_names:
        cache.add_node(Node(
            metadata=ObjectMeta(name=name, uid=name), spec=NodeSpec(),
            status=NodeStatus(allocatable=dict(alloc),
                              capacity=dict(alloc))))


def wave_objects(wave, cluster, traffic):
    """The wave as API objects: (pod groups, pods), in submission order."""
    ns = wave.namespace
    cpus, mems = traffic["cpu"], traffic["memory"]
    groups = [v1alpha1.PodGroup(
        metadata=ObjectMeta(name=name, namespace=ns, uid=f"{ns}-{name}",
                            creation_timestamp=float(ts)),
        spec=v1alpha1.PodGroupSpec(
            min_member=int(m), queue=cluster.queue_names[int(q)]))
        for name, q, m, ts in zip(wave.group_names, wave.group_queue,
                                  wave.group_min, wave.group_ts)]
    annotation = v1alpha1.GroupNameAnnotationKey
    pods = [Pod(
        metadata=ObjectMeta(
            name=name, namespace=ns, uid=f"{ns}-{name}",
            annotations={annotation: wave.group_names[int(g)]},
            creation_timestamp=float(ts)),
        spec=PodSpec(containers=[Container(requests={
            "cpu": cpus[int(c)], "memory": mems[int(m)]})]),
        status=PodStatus(phase="Pending"))
        for name, g, c, m, ts in zip(wave.pod_names, wave.pod_group,
                                     wave.pod_cpu, wave.pod_mem, wave.pod_ts)]
    return groups, pods


def ingest(cache, groups, pods) -> None:
    for pg in groups:
        cache.add_pod_group(pg)
    for pod in pods:
        cache.add_pod(pod)


def delete(cache, groups, pods) -> None:
    for pod in pods:
        cache.delete_pod(pod)
    for pg in groups:
        cache.delete_pod_group(pg)


def node_state(cache, cluster):
    """[(milli-CPU used, MiB used, pods)] per node, in the cluster's order,
    from the cache's own accounting."""
    out = []
    with cache.mutex:
        for name in cluster.node_names:
            info = cache.nodes[name]
            out.append((info.used.milli_cpu, info.used.memory / (1 << 20),
                        len(info.tasks)))
    return out
