"""Cluster-state cache (L2): mirror, informer wiring, effectors.

TPU-native counterpart of kube-batch pkg/scheduler/cache/.
"""

from .interface import Binder, Cache, Evictor, StatusUpdater, VolumeBinder
from .cache import SchedulerCache
from .fake import FakeBinder, FakeEvictor, FakeStatusUpdater, FakeVolumeBinder
# The cluster simulator (cluster.py) and the informers come with the wire
# slice (ROADMAP queue 1 item 9).
from .shadow import create_shadow_pod_group, shadow_group_key, shadow_pod_group

__all__ = [
    "Binder", "Cache", "Evictor", "StatusUpdater", "VolumeBinder",
    "SchedulerCache",
    "FakeBinder", "FakeEvictor", "FakeStatusUpdater", "FakeVolumeBinder",
    "create_shadow_pod_group", "shadow_group_key", "shadow_pod_group",
]
