"""Reclaim action: cross-queue eviction for starved queues.
(kube_batch_tpu/actions/reclaim.py)

Mirrors kube-batch pkg/scheduler/actions/reclaim/reclaim.go: per pending
task of a non-overused queue, walk nodes, collect Running tasks of *other*
queues, ask Reclaimable, evict until the request is covered, then Pipeline.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..api import FitError, Resource, TaskStatus
from ..device import check_float_dtype, resolve_device
from ..framework import Action
from ..metrics import metrics
from ..trace import spans as trace
from ..utils import PriorityQueue, get_node_list


class ReclaimAction(Action):

    def __init__(self, device=None, dtype: torch.dtype = torch.float32):
        # The eviction scanner's device (CUDA unless the caller asks for
        # the CPU; raises without CUDA) and the float key dtype of its
        # tensorize, as tpu-allocate takes them.
        self.device = resolve_device(device)
        self.dtype = check_float_dtype(dtype)

    def name(self) -> str:
        return "reclaim"

    def execute(self, ssn) -> None:
        # Batched commit (framework/commit.py): the session-side evicts
        # of this walk accumulate in the per-action sink and flush as
        # ONE bulk egress + fused cache update at exit (including the
        # exception path — mirrored effects must reach the cluster).
        from ..framework.commit import action_commit
        with action_commit(ssn, self.name()):
            self._execute(ssn)

    def _execute(self, ssn) -> None:
        queues = PriorityQueue(ssn.queue_order_fn)
        queue_map: Dict[str, object] = {}
        preemptors_map: Dict[str, PriorityQueue] = {}
        preemptor_tasks: Dict[str, PriorityQueue] = {}

        for job in ssn.jobs.values():
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            if queue.uid not in queue_map:
                queue_map[queue.uid] = queue
                queues.push(queue)
            if job.task_status_index.get(TaskStatus.Pending):
                if job.queue not in preemptors_map:
                    preemptors_map[job.queue] = PriorityQueue(ssn.job_order_fn)
                preemptors_map[job.queue].push(job)
                preemptor_tasks[job.uid] = ssn.task_queue(
                    job.task_status_index[TaskStatus.Pending].values())

        walk = {"tried": 0, "victims": 0, "pipelines": 0}
        with trace.span("reclaim.walk") as sp:
            self._walk(ssn, queues, preemptors_map, preemptor_tasks, walk)
            sp.annotate(**walk)
        metrics.note_pipelined(self.name(), walk["pipelines"])

    def _walk(self, ssn, queues, preemptors_map, preemptor_tasks,
              walk) -> None:
        """The host walk; ``walk`` counts the tasks that walked the
        nodes, the victims evicted and the tasks pipelined.  Its
        ``reclaim.prepare`` span, at the first task that walks, nests in
        the walk's."""
        scanner = None
        scanner_built = False
        while not queues.empty():
            queue = queues.pop()
            if ssn.overused(queue):
                continue

            jobs = preemptors_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()

            tasks = preemptor_tasks.get(job.uid)
            if tasks is None or tasks.empty():
                continue
            task = tasks.pop()

            assigned = False
            if not scanner_built:
                # Tensorize lazily: only when a starving task actually
                # needs a node walk (span: the stallable phase).
                with trace.span("reclaim.prepare"):
                    # shared=True: the batched eviction engine tensorizes
                    # and batch-seeds ONCE here (reclaim runs first in
                    # the shipped pipeline); preempt and backfill then
                    # re-attach with a dirty-node refresh instead of
                    # re-tensorizing (doc/EVICTION.md).
                    from ..models.scanner import maybe_scanner
                    scanner = maybe_scanner(ssn, shared=True,
                                            device=self.device,
                                            dtype=self.dtype)
                    scanner_built = True
                    from ..models.victim_index import VictimIndex
                    vindex = VictimIndex.for_session(ssn)
                    if scanner is not None:
                        vindex.attach_nodes(scanner.snap.node_names)
            if not vindex.any_for_other_queues(job.queue):
                continue  # no node anywhere holds a reclaimable victim
            walk["tried"] += 1
            # Candidate walk in node order; the device scan answers the
            # predicate chain for all nodes at once (reclaim.go:115).
            # Nodes without a Running resident of another queue are
            # skipped lazily — they provably yield no reclaimees.
            if scanner is not None:
                mask = vindex.other_queues_mask(job.queue)
                names = scanner.candidate_nodes(task, scored=False,
                                                admissible=mask)
            else:
                mask, names = None, None
            if names is not None:
                if mask is not None:
                    node_walk = (ssn.nodes[n] for n, _ in names
                                 if n in ssn.nodes)
                else:
                    node_walk = (ssn.nodes[n] for n, _ in names
                                 if vindex.node_for_other_queues(
                                     n, job.queue)
                                 and n in ssn.nodes)
            else:
                def _host_walk(task=task, queue=job.queue):
                    for node in get_node_list(ssn.nodes):
                        if not vindex.node_for_other_queues(node.name,
                                                            queue):
                            continue
                        try:
                            ssn.predicate_fn(task, node)
                        except FitError:
                            continue
                        yield node
                node_walk = _host_walk()
            for node in node_walk:

                resreq = task.init_resreq.clone()
                reclaimed = Resource.empty()

                # Candidates: Running tasks of other queues (reclaim.go:126-138).
                reclaimees: List = []
                for t in node.tasks.values():
                    if t.status != TaskStatus.Running:
                        continue
                    j = ssn.jobs.get(t.job)
                    if j is None:
                        continue
                    if j.queue != job.queue:
                        reclaimees.append(t.clone())
                victims = ssn.reclaimable(task, reclaimees)
                if not victims:
                    continue

                total = Resource.empty()
                for v in victims:
                    total.add(v.resreq)
                if not resreq.less_equal(total):
                    continue

                for reclaimee in victims:
                    try:
                        ssn.evict(reclaimee, "reclaim")
                    except Exception:  # lint: allow-swallow(per-victim isolation: a failed evict skips the victim; cache.evict queued its resync)
                        continue
                    vjob = ssn.jobs.get(reclaimee.job)
                    vindex.on_evict(node.name,
                                    vjob.queue if vjob is not None else "",
                                    reclaimee.job)
                    walk["victims"] += 1
                    reclaimed.add(reclaimee.resreq)
                    if resreq.less_equal(reclaimed):
                        break

                if task.init_resreq.less_equal(reclaimed):
                    ssn.pipeline(task, node.name)
                    walk["pipelines"] += 1
                    if scanner is not None:
                        scanner.apply_pipeline(task, node.name)
                    assigned = True
                    break

            if assigned:
                queues.push(queue)


def new(device=None, dtype: torch.dtype = torch.float32) -> ReclaimAction:
    return ReclaimAction(device, dtype)
