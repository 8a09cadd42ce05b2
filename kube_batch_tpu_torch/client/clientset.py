"""Typed clientsets for the scheduling API groups.

Counterpart of the reference's generated clients
(/root/reference/pkg/client/clientset): typed CRUD for PodGroup and Queue in
both API versions against a cluster-state store, plus fakes.  The store may
be the in-memory Cluster simulator OR an edge.client.RemoteCluster — both
expose the same verbs and mirror dicts, so the typed clients work over the
network edge unchanged (``new_for_cluster(RemoteCluster(url).start())``).
"""

from __future__ import annotations

import copy
from typing import List, Optional

from ..apis.scheduling import v1alpha1, v1alpha2
from ..cache.cluster import Cluster


class _PodGroupClient:
    """Typed PodGroup CRUD for one API version."""

    def __init__(self, cluster: Cluster, version_mod, namespace: str):
        self._cluster = cluster
        self._version = version_mod
        self._namespace = namespace

    def _check(self, pg) -> None:
        if not type(pg) is self._version.PodGroup:
            raise TypeError(
                f"expected {self._version.VERSION} PodGroup, got {type(pg)}")

    def create(self, pg):
        self._check(pg)
        pg.metadata.namespace = pg.metadata.namespace or self._namespace
        return self._cluster.create_pod_group(pg)

    def update(self, pg):
        self._check(pg)
        return self._cluster.update_pod_group(pg)

    def update_status(self, pg):
        return self.update(pg)

    def get(self, name: str):
        pg = self._cluster.pod_groups.get(f"{self._namespace}/{name}")
        if pg is None or not type(pg) is self._version.PodGroup:
            raise KeyError(f"podgroup {self._namespace}/{name} not found")
        return copy.deepcopy(pg)

    def list(self) -> List:
        return [copy.deepcopy(pg) for key, pg in
                self._cluster.pod_groups.items()
                if type(pg) is self._version.PodGroup
                and key.startswith(f"{self._namespace}/")]

    def delete(self, name: str) -> None:
        self._cluster.delete_pod_group(self._namespace, name)


class _QueueClient:
    """Typed Queue CRUD (cluster-scoped) for one API version."""

    def __init__(self, cluster: Cluster, version_mod):
        self._cluster = cluster
        self._version = version_mod

    def create(self, queue):
        if not type(queue) is self._version.Queue:
            raise TypeError(
                f"expected {self._version.VERSION} Queue, got {type(queue)}")
        return self._cluster.create_queue(queue)

    def get(self, name: str):
        q = self._cluster.queues.get(name)
        if q is None or not type(q) is self._version.Queue:
            raise KeyError(f"queue {name} not found")
        return copy.deepcopy(q)

    def list(self) -> List:
        return [copy.deepcopy(q) for q in self._cluster.queues.values()
                if type(q) is self._version.Queue]

    def delete(self, name: str) -> None:
        self._cluster.delete_queue(name)


class _VersionGroup:
    def __init__(self, cluster: Cluster, version_mod):
        self._cluster = cluster
        self._version = version_mod

    def pod_groups(self, namespace: str = "default") -> _PodGroupClient:
        return _PodGroupClient(self._cluster, self._version, namespace)

    def queues(self) -> _QueueClient:
        return _QueueClient(self._cluster, self._version)


class Clientset:
    """Typed access to both scheduling API versions (reference
    clientset/versioned.Clientset)."""

    def __init__(self, cluster: Cluster):
        self._cluster = cluster
        self.scheduling_v1alpha1 = _VersionGroup(cluster, v1alpha1)
        self.scheduling_v1alpha2 = _VersionGroup(cluster, v1alpha2)


def new_for_cluster(cluster: Cluster) -> Clientset:
    return Clientset(cluster)
