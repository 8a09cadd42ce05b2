"""Backfill action: place BestEffort tasks on any predicate-passing node.
(kube_batch_tpu/actions/backfill.py)

Mirrors kube-batch pkg/scheduler/actions/backfill/backfill.go:44-68
(sequential first-fit, no scoring — the upstream TODO at backfill.go:50).
The per-node Python predicate walk is answered by the DeviceNodeScanner
(one vectorized scan per task over all nodes) when the session
tensorizes; node order and outcomes are identical to the host walk
(get_node_list name order == the scanner's node_names order).
"""

from __future__ import annotations

import torch

from ..api import FitError, TaskStatus
from ..device import check_float_dtype, resolve_device
from ..framework import Action
from ..trace import spans as trace
from ..utils import get_node_list


class BackfillAction(Action):

    def __init__(self, device=None, dtype: torch.dtype = torch.float32):
        # The eviction scanner's device (CUDA unless the caller asks for
        # the CPU; raises without CUDA) and the float key dtype of its
        # tensorize, as tpu-allocate takes them.
        self.device = resolve_device(device)
        self.dtype = check_float_dtype(dtype)

    def name(self) -> str:
        return "backfill"

    def execute(self, ssn) -> None:
        from ..models.scanner import maybe_scanner
        # Don't tensorize a second time in the common no-BestEffort cycle:
        # the scanner only pays off when there is a sweep to answer.  The
        # pipelined tpu-allocate action already answered the discovery
        # question from the tensorizer's BestEffort rows during its
        # device-wait window (ssn.prescan); only sessions it didn't see
        # (host fallback, different pipeline) pay the O(pending) walk.
        with trace.span("backfill.discover") as sp:
            has_best_effort = ssn.prescan.get("has_best_effort")
            prescanned = has_best_effort is not None
            if not prescanned:
                has_best_effort = any(
                    t.init_resreq.is_empty()
                    for job in ssn.jobs.values()
                    for t in job.task_status_index.get(TaskStatus.Pending,
                                                       {}).values())
            sp.annotate(prescanned=prescanned,
                        has_best_effort=bool(has_best_effort))
            # shared=True: reuse the batched eviction engine's session
            # scanner (dirty-node refreshed) when reclaim already built
            # it, instead of paying a third tensorize this cycle.
            scanner = (maybe_scanner(ssn, shared=True, device=self.device,
                                     dtype=self.dtype)
                       if has_best_effort else None)
        with trace.span("backfill.place"):
            for job in list(ssn.jobs.values()):
                pending = list(job.task_status_index.get(TaskStatus.Pending,
                                                         {}).values())
                for task in pending:
                    if not task.init_resreq.is_empty():
                        continue  # only BestEffort tasks backfill
                    if scanner is not None:
                        candidates = scanner.candidate_nodes(task,
                                                             scored=False)
                        if candidates is not None:
                            for name, _score in candidates:
                                try:
                                    ssn.allocate(task, name)
                                except Exception:  # lint: allow-swallow(per-node probe: allocate failure means try the next scanned candidate)
                                    continue
                                # Membership occupancy (count/ports/
                                # selcnt) for subsequent scans; resource
                                # `used` rides the allocate event (empty
                                # here anyway).
                                scanner.apply_pipeline(task, name)
                                break
                            continue
                    for node in get_node_list(ssn.nodes):
                        try:
                            ssn.predicate_fn(task, node)
                        except FitError:
                            continue
                        try:
                            ssn.allocate(task, node.name)
                        except Exception:  # lint: allow-swallow(per-node probe on the host walk: failure means try the next node)
                            continue
                        break


def new(device=None, dtype: torch.dtype = torch.float32) -> BackfillAction:
    return BackfillAction(device, dtype)
