"""Statement: session-level transaction for speculative preemption.

Mirrors kube-batch pkg/scheduler/framework/statement.go: Evict/Pipeline
apply session-side effects immediately and log operations; Commit replays
evictions to the cluster; Discard rolls back in reverse order.
"""

from __future__ import annotations

from typing import List, Tuple

from ..api import TaskInfo, TaskStatus
from .events import Event


def unevict_session(ssn, reclaimee: TaskInfo) -> None:
    """Restore one evicted task's session state (the rollback side of a
    session eviction): status back to Running, node accounting, the
    deallocate event reversed, and the session-shared VictimIndex
    counted back in.  Shared by Statement rollback (discard and
    commit-failure) and the batched commit flush's degradation path
    (framework/commit.py) so every restore runs the same altitude."""
    job = ssn.jobs.get(reclaimee.job)
    if job is not None:
        ssn._dirty_job(reclaimee.job)
        job.update_task_status(reclaimee, TaskStatus.Running)
    node = ssn.nodes.get(reclaimee.node_name)
    if node is not None:
        ssn._dirty_node(reclaimee.node_name)
        node.update_task(reclaimee)
    ssn._fire_allocate(reclaimee)
    # Count the restored Running resident back into the session-shared
    # VictimIndex (the evicting action counted it out at evict time).
    # Living here covers every rollback path — discard, commit-failure,
    # and the batched flush's degradation — at one altitude; an
    # under-counted index would let later preemptors skip nodes holding
    # victims.
    idx = getattr(ssn, "_victim_index", None)
    if idx is not None and job is not None:
        idx.on_restore(reclaimee.node_name, job.queue, reclaimee.job)


class Statement:

    def __init__(self, ssn, action: str = ""):
        self.ssn = ssn
        self.action = action
        self.operations: List[Tuple[str, tuple]] = []

    def counts(self) -> dict:
        """The ``evicts`` and ``pipelines`` this statement holds."""
        evicts = sum(1 for name, _ in self.operations if name == "evict")
        return {"evicts": evicts,
                "pipelines": len(self.operations) - evicts}

    # -- forward ops --------------------------------------------------------

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """Session-side eviction, logged for commit/rollback (go:36-76).

        The mirror transition is the fused Releasing fast path
        (JobInfo.release_task + NodeInfo.release_resident, ROADMAP 5a):
        the eviction decision walk calls this once per victim, and the
        old update_task_status + node.update_task pair paid a
        delete/re-add Resource round trip and a fresh task clone per
        call.  End state — including both tasks dicts' iteration order —
        is identical to the slow pair (pinned by the evict/commit parity
        gates)."""
        job = self.ssn.jobs.get(reclaimee.job)
        if job is not None:
            self.ssn._dirty_job(reclaimee.job)
            job.release_task(reclaimee)
        node = self.ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            self.ssn._dirty_node(reclaimee.node_name)
            node.release_resident(reclaimee)
        self.ssn._fire_deallocate(reclaimee)
        self.operations.append(("evict", (reclaimee, reason)))

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        """Session-side pipeline, logged for rollback (go:113-155)."""
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            self.ssn._dirty_job(task.job)
            job.update_task_status(task, TaskStatus.Pipelined)
        node = self.ssn.nodes.get(hostname)
        if node is not None:
            self.ssn._dirty_node(hostname)
            node.add_task(task)
        self.ssn._fire_allocate(task)
        self.operations.append(("pipeline", (task, hostname)))

    # -- rollback helpers ---------------------------------------------------
    # (rollback targets were dirtied by the forward op; a rollback restores
    # scheduling state but not bit-identical dict order, so the clones stay
    # out of the snapshot pool for this cycle)

    def _unevict(self, reclaimee: TaskInfo) -> None:
        unevict_session(self.ssn, reclaimee)

    def _unpipeline(self, task: TaskInfo) -> None:
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            self.ssn._dirty_job(task.job)
            job.update_task_status(task, TaskStatus.Pending)
        node = self.ssn.nodes.get(task.node_name)
        if node is not None:
            self.ssn._dirty_node(task.node_name)
            node.remove_task(task)
        task.node_name = ""
        self.ssn._fire_deallocate(task)

    # -- transaction outcomes ----------------------------------------------

    def discard(self) -> None:
        """Roll back all logged operations in reverse (go:196-207)."""
        from ..metrics import metrics
        from ..trace import spans as trace
        with trace.span("statement.discard", **self.counts()):
            for name, args in reversed(self.operations):
                if name == "evict":
                    self._unevict(args[0])
                elif name == "pipeline":
                    self._unpipeline(args[0])
            self.operations.clear()
        metrics.note_statement(self.action, "discard")

    def commit(self) -> None:
        """Replay evictions against the cluster; pipelines stay session-only
        (go:210-220).

        Batched commit (framework/commit.py): with the action's
        CommitSink active, the committed evictions hand off to the
        per-action accumulator instead of egressing here — the sink's
        single flush replays them in this exact order, so the victim
        sequence and event stream equal the sequential loop below (the
        KUBE_BATCH_TPU_BATCH_COMMIT=0 control)."""
        from ..metrics import metrics
        from ..trace import spans as trace
        counts = self.counts()
        with trace.span("statement.commit", **counts):
            self._commit()
        metrics.note_statement(self.action, "commit")
        metrics.note_pipelined(self.action, counts["pipelines"])

    def _commit(self) -> None:
        import time

        from ..metrics import metrics
        from ..trace import spans as trace
        sink = getattr(self.ssn, "_commit_sink", None)
        if sink is not None:
            for name, args in self.operations:
                if name == "evict":
                    sink.add_evict(args[0], args[1])
            self.operations.clear()
            return
        start = time.perf_counter()
        for name, args in self.operations:
            if name == "evict":
                reclaimee, reason = args
                try:
                    self.ssn.cache.evict(reclaimee, reason)
                except Exception:  # lint: allow-swallow(commit continues past one failed evict; _unevict restores session state and cache.evict queued the resync)
                    self._unevict(reclaimee)  # also restores VictimIndex
                else:
                    # Per-action eviction attribution (the reason string
                    # IS the deciding action: "preempt" here).
                    metrics.note_eviction(reason)
                    trace.note_evict(reason)
        self.operations.clear()
        self.ssn._floor_commit += time.perf_counter() - start
