"""Fake effectors for action-level tests.

Mirrors kube-batch pkg/scheduler/util/test_utils.go:94-163 (FakeBinder/
FakeEvictor/FakeStatusUpdater/FakeVolumeBinder): the action tests run the real
OpenSession -> Execute pipeline and assert on the fake binder's recorded
decisions.
"""

from __future__ import annotations

import threading
from typing import Dict, List

from ..api import pod_key
from .interface import Binder, Evictor, StatusUpdater, VolumeBinder


class FakeBinder(Binder):
    def __init__(self):
        self.lock = threading.Lock()
        self.binds: Dict[str, str] = {}    # guarded-by: lock
        self.channel: List[str] = []       # guarded-by: lock

    def bind(self, pod, hostname: str) -> None:
        with self.lock:
            key = pod_key(pod)
            self.binds[key] = hostname
            self.channel.append(key)

    def bind_many(self, pairs) -> list:
        with self.lock:  # one lock round-trip for the whole batch
            for pod, hostname in pairs:
                key = pod_key(pod)
                self.binds[key] = hostname
                self.channel.append(key)
        return []


class FakeEvictor(Evictor):
    def __init__(self):
        self.lock = threading.Lock()
        self.evicts: List[str] = []        # guarded-by: lock
        self.channel: List[str] = []       # guarded-by: lock

    def evict(self, pod) -> None:
        with self.lock:
            key = pod_key(pod)
            self.evicts.append(key)
            self.channel.append(key)

    def evict_many(self, pods) -> list:
        with self.lock:  # one lock round-trip for the whole batch
            for pod in pods:
                key = pod_key(pod)
                self.evicts.append(key)
                self.channel.append(key)
        return []


class FakeStatusUpdater(StatusUpdater):
    def __init__(self):
        self.pod_conditions: List[tuple] = []
        self.pod_groups: List[object] = []

    def update_pod_condition(self, pod, condition) -> None:
        self.pod_conditions.append((pod_key(pod), condition))

    def update_pod_group(self, pg) -> None:
        self.pod_groups.append(pg)


class FakeVolumeBinder(VolumeBinder):
    def __init__(self):
        self.allocated: List[tuple] = []
        self.bound: List[str] = []

    def allocate_volumes(self, task, hostname: str) -> None:
        self.allocated.append((task.uid, hostname))

    def bind_volumes(self, task) -> None:
        self.bound.append(task.uid)
