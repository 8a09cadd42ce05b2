"""Allocate action: the primary placement loop (host path).

Mirrors kube-batch pkg/scheduler/actions/allocate/allocate.go: queue PQ
ordered by QueueOrderFn, per-queue job PQs, lazily-built per-job pending-task
PQs skipping BestEffort tasks; per task predicate -> prioritize -> select-best
-> Allocate on Idle or Pipeline onto Releasing; jobs/queues re-pushed for
fairness interleave.  This is the parity oracle for the ``tpu-allocate``
action, which executes the same semantics as a batched device program.
"""

from __future__ import annotations

from typing import Dict

from ..api import FitError, TaskStatus
from ..framework import Action
from ..trace import spans as trace
from ..utils import (PriorityQueue, get_node_list, predicate_nodes,
                     prioritize_nodes, select_best_node)


class AllocateAction(Action):

    def name(self) -> str:
        return "allocate"

    def execute(self, ssn) -> None:
        with trace.span("allocate.build_queues"):
            queues = PriorityQueue(ssn.queue_order_fn)
            jobs_map: Dict[str, PriorityQueue] = {}

            for job in ssn.jobs.values():
                queue = ssn.queues.get(job.queue)
                if queue is None:
                    continue
                queues.push(queue)
                if job.queue not in jobs_map:
                    jobs_map[job.queue] = PriorityQueue(ssn.job_order_fn)
                jobs_map[job.queue].push(job)

        pending_tasks: Dict[str, PriorityQueue] = {}
        all_nodes = get_node_list(ssn.nodes)

        def predicate_fn(task, node):
            # Resource fit against Idle or Releasing (allocate.go:73-87),
            # then the plugin predicate chain.
            if (not task.init_resreq.less_equal(node.idle)
                    and not task.init_resreq.less_equal(node.releasing)):
                raise FitError(task, node, "resource fit failed")
            ssn.predicate_fn(task, node)

        with trace.span("allocate.place_loop"):
            while not queues.empty():
                queue = queues.pop()
                if ssn.overused(queue):
                    continue
                jobs = jobs_map.get(queue.uid)
                if jobs is None or jobs.empty():
                    continue

                job = jobs.pop()
                if job.uid not in pending_tasks:
                    # BestEffort tasks wait for backfill
                    # (allocate.go:112-117).
                    pending_tasks[job.uid] = ssn.task_queue(
                        task for task in job.task_status_index.get(
                            TaskStatus.Pending, {}).values()
                        if not task.resreq.is_empty())
                tasks = pending_tasks[job.uid]

                while not tasks.empty():
                    task = tasks.pop()

                    # Stale fit deltas are for tasks that eventually fit
                    # (allocate.go:134-141).
                    if job.nodes_fit_delta:
                        ssn._dirty_job(job.uid)
                        job.nodes_fit_delta = {}

                    candidates = predicate_nodes(task, all_nodes,
                                                 predicate_fn)
                    if not candidates:
                        # Tasks are priority-ordered: if this one can't
                        # fit, don't try later tasks of the same job.
                        break

                    priority_list = prioritize_nodes(task, candidates,
                                                     ssn.node_prioritizers())
                    node_name = select_best_node(priority_list)
                    node = ssn.nodes[node_name]

                    if task.init_resreq.less_equal(node.idle):
                        try:
                            ssn.allocate(task, node.name)
                        except (KeyError, ValueError):
                            # Log-and-continue like the reference
                            # (allocate.go:162-166); failed volume
                            # allocation or stale state leaves the task
                            # pending for resync.
                            pass
                    else:
                        # Record why the best node did not fit idle.
                        delta = node.idle.clone()
                        delta.fit_delta(task.init_resreq)
                        ssn._dirty_job(job.uid)
                        job.nodes_fit_delta[node.name] = delta
                        # Speculate onto releasing resources
                        # (allocate.go:175-182).
                        if task.init_resreq.less_equal(node.releasing):
                            ssn.pipeline(task, node.name)

                    if ssn.job_ready(job) and not tasks.empty():
                        jobs.push(job)
                        break

                # Queue gets another round until it has no jobs left.
                queues.push(queue)


def new() -> AllocateAction:
    return AllocateAction()
