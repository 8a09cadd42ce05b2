"""Preempt action: within-queue preemption under a Statement transaction.
(kube_batch_tpu/actions/preempt.py)

Mirrors kube-batch pkg/scheduler/actions/preempt/preempt.go: inter-job
preemption within each queue (commit only if the preemptor job reaches
JobPipelined, else discard), then intra-job preemption.

The per-preemptor candidate-node walk (predicates + scores over every
node — the reference's 16-goroutine fan-out, preempt.go:180-189) runs as
one device call per preemptor on big clusters (models/scanner.py), with
checkpoint/restore mirroring the Statement transaction; victim selection
and commit semantics stay on the host.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..api import Resource, TaskInfo, TaskStatus
from ..device import check_float_dtype, resolve_device
from ..framework import Action
from ..metrics import metrics
from ..trace import spans as trace
from ..utils import (PriorityQueue, get_node_list, predicate_nodes,
                     prioritize_nodes, sort_nodes)


class PreemptAction(Action):

    def __init__(self, device=None, dtype: torch.dtype = torch.float32):
        # The eviction scanner's device (CUDA unless the caller asks for
        # the CPU; raises without CUDA) and the float key dtype of its
        # tensorize, as tpu-allocate takes them.
        self.device = resolve_device(device)
        self.dtype = check_float_dtype(dtype)

    def name(self) -> str:
        return "preempt"

    def execute(self, ssn) -> None:
        # Batched commit (framework/commit.py): every Statement.commit
        # of this walk hands its evictions to the per-action sink; ONE
        # bulk egress + fused cache update flushes them at exit, in the
        # exact commit order (doc/EVICTION.md "Batched commit").
        from ..framework.commit import action_commit
        with action_commit(ssn, self.name()):
            self._execute(ssn)

    def _execute(self, ssn) -> None:
        preemptors_map: Dict[str, PriorityQueue] = {}
        preemptor_tasks: Dict[str, PriorityQueue] = {}
        under_request: List = []
        queues: Dict[str, object] = {}

        for job in ssn.jobs.values():
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            queues.setdefault(queue.uid, queue)
            if job.task_status_index.get(TaskStatus.Pending):
                if job.queue not in preemptors_map:
                    preemptors_map[job.queue] = PriorityQueue(ssn.job_order_fn)
                preemptors_map[job.queue].push(job)
                under_request.append(job)
                preemptor_tasks[job.uid] = ssn.task_queue(
                    job.task_status_index[TaskStatus.Pending].values())

        if not preemptors_map:
            return
        # The expensive pre-work (tensorize + resident index) gets its
        # own span: on big clusters it is the phase that stalls.
        with trace.span("preempt.prepare",
                        preemptor_jobs=len(under_request)):
            # Tensorize only when there is work: the scanner costs a
            # session flatten, pure overhead on healthy clusters.
            # shared=True: under the batched eviction engine this reuses
            # (and dirty-refreshes) the session scanner reclaim already
            # built and batch-seeded — no second tensorize, no second
            # per-profile solve (doc/EVICTION.md).
            from ..models.scanner import maybe_scanner
            scanner = maybe_scanner(ssn, shared=True, device=self.device,
                                    dtype=self.dtype)
            # One pass over residents: lets the walk skip nodes (and
            # whole preemptors) that provably cannot yield a victim —
            # the starved queue's O(tasks x nodes) empty walk collapses
            # to O(tasks).  Session-shared: reclaim (which runs first in
            # the shipped pipeline) already built and live-updated it.
            from ..models.victim_index import VictimIndex
            vindex = VictimIndex.for_session(ssn)
            if scanner is not None:
                vindex.attach_nodes(scanner.snap.node_names)

        walk = {"tried": 0, "victims": 0, "pipelines": 0}
        with trace.span("preempt.walk") as sp:
            self._walk(ssn, queues, preemptors_map, preemptor_tasks,
                       under_request, scanner, vindex, walk)
            sp.annotate(**walk)

    def _walk(self, ssn, queues, preemptors_map, preemptor_tasks,
              under_request, scanner, vindex, walk) -> None:
        """The host walk; ``walk`` counts the preemptors tried and the
        victims and pipelines of the statements committed."""

        def close(stmt, commit: bool) -> None:
            if commit:
                counts = stmt.counts()
                walk["victims"] += counts["evicts"]
                walk["pipelines"] += counts["pipelines"]
                stmt.commit()
            else:
                stmt.discard()

        # Preemption between jobs within a queue (preempt.go:76-134).
        for queue in queues.values():
            while True:
                preemptors = preemptors_map.get(queue.uid)
                if preemptors is None or preemptors.empty():
                    break
                preemptor_job = preemptors.pop()

                stmt = ssn.statement(self.name())
                if scanner is not None:
                    scanner.checkpoint()
                assigned = False
                while True:
                    if preemptor_tasks[preemptor_job.uid].empty():
                        break
                    preemptor = preemptor_tasks[preemptor_job.uid].pop()

                    def job_filter(task: TaskInfo) -> bool:
                        if task.status != TaskStatus.Running:
                            return False
                        job = ssn.jobs.get(task.job)
                        if job is None:
                            return False
                        return (job.queue == preemptor_job.queue
                                and preemptor.job != task.job)

                    if not vindex.any_for_queue(preemptor_job.queue,
                                                preemptor.job):
                        continue  # no node anywhere holds a victim
                    node_ok = (lambda name, q=preemptor_job.queue,
                               ju=preemptor.job:
                               vindex.node_for_queue(name, q, ju))
                    mask_fn = (lambda q=preemptor_job.queue,
                               ju=preemptor.job:
                               vindex.queue_mask(q, ju))
                    walk["tried"] += 1
                    if _preempt(ssn, stmt, preemptor, ssn.nodes, job_filter,
                                scanner, node_ok, vindex, mask_fn):
                        assigned = True
                    # Pipelined checked at loop BOTTOM (preempt.go:
                    # 117-121): a re-popped already-pipelined job still
                    # preempts for one more task per pop.
                    if ssn.job_pipelined(preemptor_job):
                        break

                # Commit/discard decided once after the walk — every
                # checkpoint frame is balanced by exactly one commit or
                # restore, including the re-popped pipelined job whose
                # task queue is empty (an empty commit; the old
                # commit-inside-the-loop leaked that frame).
                if ssn.job_pipelined(preemptor_job):
                    close(stmt, True)
                    if scanner is not None:
                        scanner.commit()
                    if assigned:
                        preemptors.push(preemptor_job)
                else:
                    close(stmt, False)  # also counts victims back into vindex
                    if scanner is not None:
                        scanner.restore()

            # Preemption between tasks within a job (preempt.go:136-165).
            for job in under_request:
                while True:
                    tasks = preemptor_tasks.get(job.uid)
                    if tasks is None or tasks.empty():
                        break
                    preemptor = tasks.pop()
                    if not vindex.any_for_job(job.uid):
                        break  # the job has no Running task to sacrifice
                    stmt = ssn.statement(self.name())
                    walk["tried"] += 1
                    assigned = _preempt(
                        ssn, stmt, preemptor, ssn.nodes,
                        lambda task: (task.status == TaskStatus.Running
                                      and preemptor.job == task.job),
                        scanner,
                        lambda name, ju=job.uid:
                        vindex.node_for_job(name, ju),
                        vindex)
                    close(stmt, True)
                    if not assigned:
                        break


def _preempt(ssn, stmt, preemptor: TaskInfo, nodes, filter_fn,
             scanner=None, node_ok=None, vindex=None,
             mask_fn=None) -> bool:
    """Try to free room for preemptor on some node (preempt.go:171-254).

    ``node_ok(name)``: optional admissibility pre-filter (VictimIndex):
    nodes it rejects provably yield no candidates under ``filter_fn``,
    so they are skipped before materialization — the walk stops at the
    first workable node, so the lazy generator touches only the nodes
    actually visited."""
    scored = None
    mask = None
    if scanner is not None:
        if mask_fn is not None:
            mask = mask_fn()  # vectorized admissibility, may be None
        scored = scanner.candidate_nodes(preemptor, scored=True,
                                         admissible=mask)
    if scored is not None:
        if mask is not None:  # admissibility already applied in bulk
            selected_nodes = (ssn.nodes[name] for name, _ in scored
                              if name in ssn.nodes)
        else:
            selected_nodes = (ssn.nodes[name] for name, _ in scored
                              if (node_ok is None or node_ok(name))
                              and name in ssn.nodes)
    else:
        all_nodes = get_node_list(nodes)
        candidates = predicate_nodes(preemptor, all_nodes, ssn.predicate_fn)
        priority_list = prioritize_nodes(preemptor, candidates,
                                         ssn.node_prioritizers())
        selected_nodes = (node for node in
                          sort_nodes(priority_list, ssn.nodes)
                          if node_ok is None or node_ok(node.name))

    assigned = False
    for node in selected_nodes:
        preemptees = [task.clone() for task in node.tasks.values()
                      if filter_fn is None or filter_fn(task)]
        if not preemptees:
            continue  # no candidates -> no victims, provably
        victims = ssn.preemptable(preemptor, preemptees)
        metrics.update_preemption_victims_count(len(victims))

        if not _validate_victims(victims, preemptor.init_resreq):
            continue

        # Lowest-priority victims evicted first: reversed task order
        # (preempt.go:213-218).  The batched engine precomputed that
        # order for every Running resident (one ranking in the session's
        # single eviction dispatch); per-preemptor the sort collapses to
        # an index lookup — bit-identical because the key is total (uid
        # fallback) and immutable within the session.
        ordered_victims = _order_victims(ssn, victims, scanner)

        preempted = Resource.empty()
        resreq = preemptor.init_resreq.clone()
        for preemptee in ordered_victims:
            stmt.evict(preemptee, "preempt")
            if vindex is not None:
                vjob = ssn.jobs.get(preemptee.job)
                vindex.on_evict(node.name,
                                vjob.queue if vjob is not None else "",
                                preemptee.job)
            preempted.add(preemptee.resreq)
            if resreq.less_equal(preempted):
                break

        metrics.register_preemption_attempt()
        if preemptor.init_resreq.less_equal(preempted):
            stmt.pipeline(preemptor, node.name)
            if scanner is not None:
                scanner.apply_pipeline(preemptor, node.name)
            assigned = True
            break

    return assigned


def _order_victims(ssn, victims: List[TaskInfo], scanner) -> List[TaskInfo]:
    """Victims in eviction order (reversed task order, lowest priority
    first — Session.victims_queue semantics).  Prefers the batched
    engine's precomputed per-resident ranking; a victim outside it (or
    no ranking at all) falls back to the session queue, which is always
    exact."""
    rank = getattr(scanner, "victim_rank", None) if scanner is not None \
        else None
    if rank is not None:
        try:
            return sorted(victims, key=lambda t: rank[t.uid])
        except KeyError:
            pass  # a victim the ranking never saw: use the exact queue
    queue = ssn.victims_queue(victims)
    ordered: List[TaskInfo] = []
    while not queue.empty():
        ordered.append(queue.pop())
    return ordered


def _validate_victims(victims: List[TaskInfo], resreq: Resource) -> bool:
    """Victims exist and cover the requested resources (preempt.go:256-271)."""
    if not victims:
        return False
    total = Resource.empty()
    for v in victims:
        total.add(v.resreq)
    return resreq.less_equal(total)


def new(device=None, dtype: torch.dtype = torch.float32) -> PreemptAction:
    return PreemptAction(device, dtype)
