"""Cluster-state cache (L2): mirror, informer wiring, effectors.

TPU-native counterpart of kube-batch pkg/scheduler/cache/.
"""

from .interface import Binder, Cache, Evictor, StatusUpdater, VolumeBinder
from .cache import SchedulerCache
from .fake import FakeBinder, FakeEvictor, FakeStatusUpdater, FakeVolumeBinder
from .cluster import (Cluster, ClusterBinder, ClusterEvictor,
                      ClusterStatusUpdater, connect_cache_to_cluster,
                      new_scheduler_cache)
from .shadow import create_shadow_pod_group, shadow_group_key, shadow_pod_group

__all__ = [
    "Binder", "Cache", "Evictor", "StatusUpdater", "VolumeBinder",
    "SchedulerCache",
    "FakeBinder", "FakeEvictor", "FakeStatusUpdater", "FakeVolumeBinder",
    "Cluster", "ClusterBinder", "ClusterEvictor", "ClusterStatusUpdater",
    "connect_cache_to_cluster", "new_scheduler_cache",
    "create_shadow_pod_group", "shadow_group_key", "shadow_pod_group",
]
