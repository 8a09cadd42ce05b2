"""topo-allocate: contiguous slice placement onto the torus.

Counterpart of kube_batch_tpu/actions/topo_allocate.py, carried over line
for line but for the device: the batched box scan runs as PyTorch tensor
code on the action's device (CUDA unless the caller asks for the CPU).
A failing device scan feeds the device breaker (chaos/breaker.py), which
the reference's does not, so no device failure degrades unseen.  On the
CPU it then degrades to the bit-identical numpy oracle, as in the
reference; on a CUDA device it raises ``DeviceFailure``.
Under the fused one-dispatch program
(ops/fused_solver.py, on by default) the session's first scan rides the
fused dispatch with the eviction and allocate legs.

Runs BEFORE the flat allocate family in the actions conf
(``actions: "topo-allocate, tpu-allocate, backfill"``): PodGroups
carrying a ``kube-batch.tpu/slice-shape`` annotation are placed as
axis-aligned contiguous boxes of the coordinate-labeled torus
(models/topology.py), and everything else falls through to the flat
actions untouched.  Placement decisions come from ONE batched device
dispatch per slice job (ops/topo_solver.box_scan over every candidate
origin); ``KUBE_BATCH_TPU_TOPO_BATCH=0`` routes the identical question
through the pure-numpy sequential oracle — placements, victims, and
victim order are bit-identical between the two engines
(tests/test_topology.py, tests/test_torch_topology.py).

Decision order per slice job (all keys exact integers, ties broken on
the lowest origin row — deterministic):

1. **Free box** — every member free (empty + fits + predicates): pick
   the box with the FEWEST free boundary neighbors (tightest packing —
   the placement that preserves the largest contiguous free blocks
   elsewhere), then lowest origin.
2. **Defrag eviction** (``KUBE_BATCH_TPU_TOPO_DEFRAG=1``, default) —
   no free box: pick the cheapest fully-clearable box (fewest victims,
   then lowest victim priority sum, then boundary, then origin), evict
   its residents in the session's victim order (lowest priority first,
   exactly ``Session.victims_queue``), and pipeline the slice onto the
   releasing nodes — evicting to CREATE a contiguous slice, not just
   capacity.
3. **Capacity eviction** (the ``=0`` A/B control): evict the same
   victim ordering cluster-wide until enough nodes are cleared by
   COUNT, ignoring contiguity — the arm `make bench-topo` contrasts:
   it frees capacity but no contiguous block, so the slice stays
   pending and the fragmentation gauges show the difference.

A slice job that cannot be placed this session records a PodGroup
Unschedulable condition (``NoContiguousSlice`` / ``SliceTooFewTasks``)
and leaves the session — its tasks must NOT be scattered by the flat
actions.  ``KUBE_BATCH_TPU_TOPOLOGY=0`` makes the whole action a no-op
(bit-parity with a conf that never listed it).
"""

from __future__ import annotations

import functools
import logging
import time
from typing import List, Optional

import numpy as np

import torch

from ..device import check_float_dtype, resolve_device
from ..framework import Action
from ..metrics import metrics
from ..trace import spans as trace

log = logging.getLogger(__name__)


def box_members(view, origin: int, shape) -> List[int]:
    """The box's node rows in (dx, dy, dz) offset order — the ONE
    member-enumeration order placement and the sequential oracle share
    (a different order would pair tasks with different hosts)."""
    sx, sy, sz = shape
    pod, _r, x, y, z, dx, dy, dz = (int(v) for v in view.coords[origin])
    rows: List[int] = []
    seen = set()
    for ox in range(sx):
        for oy in range(sy):
            for oz in range(sz):
                j = view._index.get(
                    (pod, (x + ox) % dx, (y + oy) % dy, (z + oz) % dz))
                if j is not None and j not in seen:
                    seen.add(j)
                    rows.append(j)
    return rows


class TopoAllocateAction(Action):

    def __init__(self, device=None, dtype: torch.dtype = torch.float32):
        # The box scan's device (CUDA unless the caller asks for the CPU;
        # raises without CUDA), and the float key dtype the other actions
        # take (the scan itself is all int32).  ``last_scan`` keeps the
        # host inputs, slice shape and real row count of the last batched
        # scan, for checks that replay it.
        self.device = resolve_device(device)
        self.dtype = check_float_dtype(dtype)
        self.last_scan = None

    def name(self) -> str:
        return "topo-allocate"

    # -- per-job node masks -------------------------------------------

    @staticmethod
    def _job_masks(ssn, view, job, task0):
        """(free, evictable, vic_cnt, vic_cost) over the view's rows.

        free: empty node, launch requirement fits idle, static predicate
        chain passes.  evictable: every resident is a Running task of
        strictly lower priority (and the empty node would fit the
        task).  Exact session-state reads only — both engines and both
        A/B arms see identical masks."""
        from ..api import TaskStatus

        n = len(view.node_names)
        free = np.zeros((n,), bool)
        evictable = np.zeros((n,), bool)
        vic_cnt = np.zeros((n,), np.int32)
        vic_cost = np.zeros((n,), np.int32)
        for i in range(n):
            if not view.valid[i]:
                continue
            node = ssn.nodes.get(view.node_names[i])
            if node is None or not node.ready():
                continue
            try:
                ssn.predicate_fn(task0, node)
            except Exception:  # lint: allow-swallow(predicate veto: any raise means infeasible, exactly like the host walk treats it)
                continue
            if not node.tasks:
                if task0.init_resreq.less_equal(node.idle):
                    free[i] = True
                continue
            if not task0.init_resreq.less_equal(node.allocatable):
                continue
            residents = list(node.tasks.values())
            if all(t.status == TaskStatus.Running
                   and t.priority < job.priority for t in residents):
                evictable[i] = True
                vic_cnt[i] = len(residents)
                # Clamp: a handful of system-range priorities (~2e9)
                # would overflow the int32 assignment into an
                # OverflowError that kills the cycle.  Both engines see
                # the same clamped value, so parity holds; ordering only
                # coarsens between astronomically-priced boxes.
                vic_cost[i] = min(sum(int(t.priority) for t in residents),
                                  np.iinfo(np.int32).max)
        return free, evictable, vic_cnt, vic_cost

    def _box_stats(self, view, free, evictable, vic_cnt, vic_cost, shape,
                   ssn=None):
        """Route the scan: the batched program on the action's device (one
        dispatch over the padded bucket, or the fused program's topo leg
        when ``ssn`` is given) or the sequential oracle under
        TOPO_BATCH=0.  A device failure degrades to the oracle on the
        CPU and raises on the card."""
        from ..models.topology import topo_batch_enabled
        from ..ops import topo_solver as ts
        from ..ops.compile_cache import bucket

        if not topo_batch_enabled():
            return ts.box_scan_seq(view, free, evictable, vic_cnt,
                                   vic_cost, shape)
        n = len(view.node_names)
        n_pad = bucket(max(n, 1))
        coords = np.full((n_pad, 8), -1, np.int32)
        coords[:n] = view.coords[:n]

        def pad(a):
            out = np.zeros((n_pad,), a.dtype)
            out[:n] = a
            return out

        inp = ts.BoxInputs(coords, pad(free), pad(evictable),
                           pad(vic_cnt), pad(vic_cost))
        self.last_scan = (inp, tuple(shape), n)
        if ssn is not None:
            # One-dispatch sessions (ops/fused_solver.py): the first
            # scan of the session stages here and rides the fused
            # program with the eviction/allocate legs; a served leg IS
            # this dispatch's [N, 6] rows (same code, same inputs).
            from ..ops import fused_solver
            stats = fused_solver.take_topo(ssn, inp, shape, n, self.device,
                                           self.dtype)
            if stats is not None:
                return stats
        try:
            with trace.span("topo.box_scan", shape="x".join(
                    str(s) for s in shape)):
                return ts.dispatch_box_scan(inp, shape, self.device)[:n]
        except Exception as exc:  # lint: allow-swallow(device scan failure degrades to the bit-identical numpy oracle on the CPU and raises on the card; counted, fed to the breaker, degraded note)
            from ..chaos.breaker import feed_failure
            feed_failure("topo",
                         f"topo box scan degraded to the host oracle "
                         f"({type(exc).__name__}: {exc})", exc,
                         owner=None if ssn is None else ssn.cache,
                         what="topo-allocate", device=self.device)
            metrics.note_swallowed("topo_box_scan")
            return ts.box_scan_seq(view, free, evictable, vic_cnt,
                                   vic_cost, shape)

    # -- decision keys -------------------------------------------------

    @staticmethod
    def _pick_free(stats, vol: int) -> Optional[int]:
        from ..ops import topo_solver as ts
        ok = (stats[:, ts.COL_COMPLETE] == 1) & (stats[:, ts.COL_FREE]
                                                 == vol)
        if not ok.any():
            return None
        rows = np.nonzero(ok)[0]
        boundary = stats[rows, ts.COL_BOUNDARY]
        return int(rows[np.lexsort((rows, boundary))][0])

    @staticmethod
    def _pick_defrag(stats, vol: int) -> Optional[int]:
        from ..ops import topo_solver as ts
        ok = ((stats[:, ts.COL_COMPLETE] == 1)
              & (stats[:, ts.COL_BLOCKED] == 0)
              & (stats[:, ts.COL_FREE] < vol))
        if not ok.any():
            return None
        rows = np.nonzero(ok)[0]
        order = np.lexsort((rows, stats[rows, ts.COL_BOUNDARY],
                            stats[rows, ts.COL_VCOST],
                            stats[rows, ts.COL_VCNT]))
        return int(rows[order][0])

    # -- eviction ------------------------------------------------------

    @staticmethod
    def _evict_ordered(ssn, victims, reason: str) -> int:
        """Evict ``victims`` in the session's victim order (lowest
        priority first — Session.victims_queue, the same order the
        preempt action commits)."""
        q = ssn.victims_queue(victims)
        count = 0
        while not q.empty():
            v = q.pop()
            try:
                ssn.evict(v, reason)
            except (KeyError, ValueError):
                # Log-and-continue, the reference's commit discipline.
                log.warning("topo defrag evict of %s/%s failed",
                            v.namespace, v.name)
                continue
            count += 1
        return count

    def _capacity_evict(self, ssn, view, evictable, vol: int,
                        n_free: int) -> int:
        """The capacity-only control arm: clear whole nodes by COUNT
        (cheapest victims first) until enough nodes are free, with no
        contiguity requirement — the A/B baseline the defrag-aware
        evictor is measured against (tools/check_topo_ab.py)."""
        needed = vol - n_free
        if needed <= 0:
            return 0
        victims = []
        for i in np.nonzero(evictable)[0]:
            node = ssn.nodes.get(view.node_names[int(i)])
            if node is not None:
                # Clones, the preempt action's discipline: eviction
                # mutates job/node state via uid lookups, never through
                # the node's resident clone itself.
                victims.extend(t.clone() for t in node.tasks.values())
        if not victims:
            return 0
        q = ssn.victims_queue(victims)
        remaining = {}
        for v in victims:
            remaining[v.node_name] = remaining.get(v.node_name, 0) + 1
        cleared = 0
        evicted = 0
        while not q.empty() and cleared < needed:
            v = q.pop()
            try:
                ssn.evict(v, "topo-capacity")
            except (KeyError, ValueError):
                continue
            evicted += 1
            remaining[v.node_name] -= 1
            if remaining[v.node_name] == 0:
                cleared += 1
        return evicted

    # -- placement -----------------------------------------------------

    @staticmethod
    def _place_box(ssn, view, origin: int, shape, tasks, free) -> int:
        """Assign ``tasks`` onto the box's nodes in offset order:
        originally-free members allocate, freshly-evicted members
        pipeline onto their releasing resources (the preempt
        discipline).  Returns placed count."""
        rows = box_members(view, origin, shape)
        placed = 0
        for task, row in zip(tasks, rows):
            hostname = view.node_names[row]
            try:
                if free[row]:
                    ssn.allocate(task, hostname)
                else:
                    ssn.pipeline(task, hostname)
            except (KeyError, ValueError) as exc:
                log.warning("topo slice placement of %s/%s onto %s "
                            "failed: %s", task.namespace, task.name,
                            hostname, exc)
                continue
            placed += 1
        return placed

    @staticmethod
    def _mark_unschedulable(ssn, job, reason: str, message: str) -> None:
        """Record the verdict and remove the job from the session — a
        slice job must wait for its slice, not be scattered by the flat
        actions (the open_session job_valid discipline)."""
        from ..api.pod_group_info import (PodGroupCondition,
                                          PodGroupUnschedulableType)
        if job.pod_group is not None:
            cond = PodGroupCondition(
                type=PodGroupUnschedulableType, status="True",
                transition_id=ssn.uid, last_transition_time=time.time(),
                reason=reason, message=message)
            ssn.update_job_condition(job, cond)
            try:
                ssn.cache.update_job_status(job)
            except Exception:  # lint: allow-swallow(status-write failure must not abort the action; counted like open_session's gate)
                metrics.note_swallowed("job_status_update")
        ssn.jobs.pop(job.uid, None)

    # -- the action ----------------------------------------------------

    def execute(self, ssn) -> None:
        from ..models.topology import topology_enabled
        if not topology_enabled():
            return
        # Batched commit (framework/commit.py): the defrag/capacity
        # evictions of this walk accumulate in the per-action sink and
        # flush as ONE bulk egress + fused cache update at exit, like
        # preempt/reclaim (doc/EVICTION.md "Batched commit").
        from ..framework.commit import action_commit
        with action_commit(ssn, self.name()):
            self._execute(ssn)

    def _execute(self, ssn) -> None:
        from ..api import TaskStatus
        from ..models.topology import (build_view, job_slice_shape,
                                       topo_defrag_enabled, topo_max_nodes,
                                       topo_table, topology_enabled)
        slice_jobs = []
        for job in ssn.jobs.values():
            shape = job_slice_shape(job)
            if shape is not None and job.queue in ssn.queues:
                slice_jobs.append((job, shape))
        view = ssn.prescan.get("topo_view")
        if view is None:
            # Cheap probe first: an unlabeled cluster must not pay an
            # O(N) view build per cycle just because the action is in
            # the conf.
            from ..models.topology import POD_LABEL
            if not any(
                    n.node is not None
                    and POD_LABEL in n.node.metadata.labels
                    for n in ssn.nodes.values()):
                return
            view = build_view(ssn.nodes)
            ssn.prescan["topo_view"] = view
        if not view.n_valid:
            # Every coordinate degraded (or none parsed): there is no
            # torus this session, so slice jobs schedule flat — the
            # same semantics as KUBE_BATCH_TPU_TOPOLOGY=0 / an
            # unlabeled cluster, NOT a pending verdict.
            return

        placed_slices = 0
        if view.n_valid > topo_max_nodes() and slice_jobs:
            # The cap degrades slice placement, never slice SEMANTICS:
            # each slice job stays pending (removed from the session so
            # the flat actions cannot scatter its tasks), exactly like
            # a no-feasible-box verdict.
            trace.note_degraded(
                f"topology: {view.n_valid} coordinate nodes exceed "
                f"KUBE_BATCH_TPU_TOPO_MAX_NODES; slice placement skipped")
            for job, shape in slice_jobs:
                metrics.note_topo_slice("degraded")
                self._mark_unschedulable(
                    ssn, job, "SliceDegraded",
                    f"{view.n_valid} coordinate nodes exceed the "
                    f"KUBE_BATCH_TPU_TOPO_MAX_NODES box-scan cap; the "
                    f"slice waits rather than scattering flat")
            slice_jobs = []

        if slice_jobs:
            def cmp(a, b):
                if ssn.job_order_fn(a[0], b[0]):
                    return -1
                if ssn.job_order_fn(b[0], a[0]):
                    return 1
                return 0

            slice_jobs.sort(key=functools.cmp_to_key(cmp))
        for job, shape in slice_jobs:
            if job.uid not in ssn.jobs:
                continue
            vol = shape[0] * shape[1] * shape[2]
            tasks = ssn.task_queue(
                t for t in job.task_status_index.get(
                    TaskStatus.Pending, {}).values()
                if not t.resreq.is_empty())
            ordered_tasks = []
            while not tasks.empty():
                ordered_tasks.append(tasks.pop())
            if len(ordered_tasks) < vol:
                metrics.note_topo_slice("too_few_tasks")
                self._mark_unschedulable(
                    ssn, job, "SliceTooFewTasks",
                    f"slice {shape[0]}x{shape[1]}x{shape[2]} needs "
                    f"{vol} pending tasks, job has {len(ordered_tasks)}")
                continue
            task0 = ordered_tasks[0]
            free, evictable, vic_cnt, vic_cost = self._job_masks(
                ssn, view, job, task0)
            stats = self._box_stats(view, free, evictable, vic_cnt,
                                    vic_cost, shape, ssn=ssn)
            origin = self._pick_free(stats, vol)
            if origin is not None:
                placed = self._place_box(ssn, view, origin, shape,
                                         ordered_tasks[:vol], free)
                metrics.note_topo_slice("placed")
                placed_slices += 1
                trace.annotate(topo_slice=f"{job.namespace}/{job.name}",
                               origin=view.node_names[origin],
                               placed=placed)
                continue
            if topo_defrag_enabled():
                origin = self._pick_defrag(stats, vol)
                if origin is not None:
                    rows = box_members(view, origin, shape)
                    victims = []
                    for row in rows:
                        if free[row]:
                            continue
                        node = ssn.nodes.get(view.node_names[row])
                        if node is not None:
                            victims.extend(t.clone()
                                           for t in node.tasks.values())
                    self._evict_ordered(ssn, victims, "topo-defrag")
                    placed = self._place_box(ssn, view, origin, shape,
                                             ordered_tasks[:vol], free)
                    metrics.note_topo_slice("defrag_placed")
                    placed_slices += 1
                    trace.annotate(
                        topo_slice=f"{job.namespace}/{job.name}",
                        origin=view.node_names[origin],
                        victims=len(victims), placed=placed)
                    continue
            else:
                n_free = int(free.sum())
                evicted = self._capacity_evict(ssn, view, evictable, vol,
                                               n_free)
                if evicted:
                    trace.annotate(topo_capacity_evicted=evicted)
            metrics.note_topo_slice("pending")
            self._mark_unschedulable(
                ssn, job, "NoContiguousSlice",
                f"no feasible {shape[0]}x{shape[1]}x{shape[2]} "
                "contiguous block (free or clearable) in any pool")

        # Fragmentation SLO (doc/TOPOLOGY.md): free = no resident holding
        # resources (empty node, or every resident Releasing after a
        # defrag evict) — computed in this action's occupancy walk and
        # published per pool.
        free_now = np.zeros((len(view.node_names),), bool)
        for i, name in enumerate(view.node_names):
            if not view.valid[i]:
                continue
            node = ssn.nodes.get(name)
            if node is None:
                continue
            free_now[i] = (not node.tasks) or all(
                t.status == TaskStatus.Releasing
                for t in node.tasks.values())
        pools = view.frag_stats(free_now)
        metrics.publish_topo_frag(pools)
        topo_table.publish(pools, extra={
            "coord_nodes": view.n_valid,
            "slices_placed_this_session": placed_slices,
        })
        trace.set_meta(topo_pools=len(pools),
                       topo_slices_placed=placed_slices)


def new(device=None, dtype: torch.dtype = torch.float32) -> TopoAllocateAction:
    return TopoAllocateAction(device, dtype)
