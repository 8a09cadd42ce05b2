"""Cache and effector interfaces.

Mirrors kube-batch pkg/scheduler/cache/interface.go:26-77.
"""

from __future__ import annotations

import abc

from ..api import ClusterInfo, JobInfo, TaskInfo


class AmbiguousOutcomeError(RuntimeError):
    """A cluster write was DELIVERED but its outcome is unproven — the
    connection died between send and response, and the read-back probe
    could not confirm either way.  Non-idempotent verbs (bind) must never
    blind-retry on this: the caller routes the task through the resync
    machinery instead of guessing (cache.go:602-624; doc/CHAOS.md
    "Ambiguous outcomes")."""


class Cache(abc.ABC):
    """Cluster-state mirror consumed by the session (interface.go:26-55)."""

    @abc.abstractmethod
    def run(self) -> None: ...

    @abc.abstractmethod
    def wait_for_cache_sync(self) -> bool: ...

    @abc.abstractmethod
    def snapshot(self) -> ClusterInfo: ...

    @abc.abstractmethod
    def bind(self, task: TaskInfo, hostname: str) -> None: ...

    def bind_batch(self, tasks) -> None:
        """Bulk bind (tasks carry node_name); default loops bind() with the
        same per-task failure isolation the old dispatch loop had."""
        for t in tasks:
            try:
                self.bind(t, t.node_name)
            except Exception:  # lint: allow-swallow(bind() already queued the resync; the repair loop owns recovery)
                continue

    @abc.abstractmethod
    def evict(self, task: TaskInfo, reason: str) -> None: ...

    def evict_many(self, pairs) -> list:
        """Bulk evict [(task, reason)] in decision order; returns
        [(task, reason, exc)] failures.  Default loops evict() with the
        same per-task failure isolation the sequential commit loop had;
        SchedulerCache overrides with the fused single-mutex mirror +
        single bulk egress (the batched commit flush target,
        framework/commit.py)."""
        failures = []
        for task, reason in pairs:
            try:
                self.evict(task, reason)
            except Exception as exc:  # per-task failure isolation
                failures.append((task, reason, exc))
        return failures

    @abc.abstractmethod
    def update_job_status(self, job: JobInfo) -> JobInfo: ...

    def record_job_status_event(self, job: JobInfo) -> None: ...

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None: ...

    def bind_volumes(self, task: TaskInfo) -> None: ...


class Binder(abc.ABC):
    @abc.abstractmethod
    def bind(self, pod, hostname: str) -> None: ...

    def bind_many(self, pairs) -> list:
        """Bind [(pod, hostname)] in bulk; returns [(pod, hostname, exc)]
        failures.  Default loops bind(); implementations override to
        amortize locking/round-trips (the reference fires one goroutine per
        bind — this is the batched equivalent)."""
        failures = []
        for pod, hostname in pairs:
            try:
                self.bind(pod, hostname)
            except Exception as exc:  # per-task failure isolation
                failures.append((pod, hostname, exc))
        return failures


class Evictor(abc.ABC):
    @abc.abstractmethod
    def evict(self, pod) -> None: ...

    def evict_many(self, pods) -> list:
        """Evict pods in bulk; returns [(pod, exc)] failures.  Default
        loops evict(); implementations override to amortize locking or
        wire round-trips (edge/client.py evict_pods_many is the
        bind_pods_many twin)."""
        failures = []
        for pod in pods:
            try:
                self.evict(pod)
            except Exception as exc:  # per-pod failure isolation
                failures.append((pod, exc))
        return failures


class StatusUpdater(abc.ABC):
    @abc.abstractmethod
    def update_pod_condition(self, pod, condition) -> None: ...

    @abc.abstractmethod
    def update_pod_group(self, pg) -> None: ...


class VolumeBinder(abc.ABC):
    @abc.abstractmethod
    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None: ...

    @abc.abstractmethod
    def bind_volumes(self, task: TaskInfo) -> None: ...
