"""Shared informer factory and listers.

Counterpart of the reference's generated SharedInformerFactory
(/root/reference/pkg/client/informers/externalversions/factory.go) and
listers: handler registration fan-out over the cluster-state store's watch
streams, plus read-only listers backed by the current store state.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..apis.scheduling import v1alpha1, v1alpha2
from ..cache.cluster import Cluster


class _TypedInformer:
    """Filters a Cluster informer stream to one object type."""

    def __init__(self, informer, type_check: Callable[[object], bool]):
        self._informer = informer
        self._type_check = type_check

    def add_event_handler(self, on_add=None, on_update=None, on_delete=None):
        self._informer.add_handlers(
            on_add=on_add, on_update=on_update, on_delete=on_delete,
            filter_fn=self._type_check)


class _PodGroupLister:
    def __init__(self, cluster: Cluster, version_mod):
        self._cluster = cluster
        self._version = version_mod

    def list(self, namespace: Optional[str] = None) -> List:
        out = []
        for key, pg in self._cluster.pod_groups.items():
            if not type(pg) is self._version.PodGroup:
                continue
            if namespace and not key.startswith(f"{namespace}/"):
                continue
            out.append(pg)
        return out


class _QueueLister:
    def __init__(self, cluster: Cluster, version_mod):
        self._cluster = cluster
        self._version = version_mod

    def list(self) -> List:
        return [q for q in self._cluster.queues.values()
                if type(q) is self._version.Queue]


class SharedInformerFactory:
    def __init__(self, cluster: Cluster):
        self._cluster = cluster

    def pod_groups(self, version_mod=v1alpha1) -> _TypedInformer:
        return _TypedInformer(
            self._cluster.pod_group_informer,
            lambda pg: type(pg) is version_mod.PodGroup)

    def queues(self, version_mod=v1alpha1) -> _TypedInformer:
        return _TypedInformer(
            self._cluster.queue_informer,
            lambda q: type(q) is version_mod.Queue)

    def pods(self) -> _TypedInformer:
        return _TypedInformer(self._cluster.pod_informer, lambda p: True)

    def nodes(self) -> _TypedInformer:
        return _TypedInformer(self._cluster.node_informer, lambda n: True)

    def pod_group_lister(self, version_mod=v1alpha1) -> _PodGroupLister:
        return _PodGroupLister(self._cluster, version_mod)

    def queue_lister(self, version_mod=v1alpha1) -> _QueueLister:
        return _QueueLister(self._cluster, version_mod)
