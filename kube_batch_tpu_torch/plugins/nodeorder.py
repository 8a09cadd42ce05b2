"""Nodeorder plugin: node scoring on the integer grid.

The reference wraps upstream kube-scheduler priorities with YAML-tunable
weights (kube-batch pkg/scheduler/plugins/nodeorder/nodeorder.go:27-38,
107-168): LeastRequested (w=1), MostRequested (w=0), BalancedResource (w=1),
NodeAffinity (w=1), InterPodAffinity (w=1).  These are standalone
reimplementations of those scoring formulas.

Scores are **exact integers** on the shared SCORE_GRID_K fraction grid
(ops/resources.py): utilization is tracked in quantized int quanta —
initialized from the snapshot, updated per placement through session event
handlers (the same incremental pattern drf/proportion use) — so this host
path and the vectorized device path (ops/scoring.py) produce identical
score integers on every platform.  Affinity term scores scale by the same
grid constant, preserving the reference's relative weighting.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..api import NodeInfo, TaskInfo
from ..framework import Arguments, Plugin
from ..framework.events import EventHandler
import numpy as np

from ..ops.resources import (SCORE_GRID_K, grid_fraction_int,
                             quantize_columns, quantize_value,
                             score_shift_for)

# Argument keys (nodeorder.go:41-66).
NODE_AFFINITY_WEIGHT = "nodeaffinity.weight"
POD_AFFINITY_WEIGHT = "podaffinity.weight"
LEAST_REQUESTED_WEIGHT = "leastrequested.weight"
BALANCED_RESOURCE_WEIGHT = "balancedresource.weight"
MOST_REQUESTED_WEIGHT = "mostrequested.weight"

MAX_PRIORITY = 10


class GridUsage:
    """Quantized per-node (cpu, mem) usage mirror for grid scoring.

    Must accumulate the same int quanta the device adds (q(a)+q(b), not
    q(a+b)) or sub-quantum requests would round differently on the two
    paths."""

    def __init__(self, ssn):
        self.cap: Dict[str, Tuple[int, int]] = {}
        self.used: Dict[str, Tuple[int, int]] = {}
        # Snapshot-map fast path (doc/INCREMENTAL.md "floors"): the
        # quantized per-node entries and the shift are maintained from
        # map-entry changes — same ints as the column pass below (the
        # per-value/column quantization identity this class documents).
        # The accessor hands private copies, so the live ``used``
        # mutation by the event handlers touches nothing shared.
        from ..models.incremental import node_open_aggregates
        agg = node_open_aggregates(ssn)
        if agg is not None:
            _total, cap, used, shift = agg
            self.cap = cap
            self.used = used
            self.shift = shift
            return
        names = list(ssn.nodes)
        if names:
            # Column-wise quantization (identical ints to per-value
            # quantize_value: same exact power-of-two scale + rint);
            # 4 numpy passes beat 4 Python calls per node.
            nodes = [ssn.nodes[n] for n in names]
            arr = np.empty((len(names), 2), np.float64)
            arr[:, 0] = [nd.allocatable.milli_cpu for nd in nodes]
            arr[:, 1] = [nd.allocatable.memory for nd in nodes]
            caps = quantize_columns(arr)
            arr[:, 0] = [nd.used.milli_cpu for nd in nodes]
            arr[:, 1] = [nd.used.memory for nd in nodes]
            useds = quantize_columns(arr)
            self.cap = {n: (int(c), int(m)) for n, (c, m)
                        in zip(names, caps.tolist())}
            self.used = {n: (int(c), int(m)) for n, (c, m)
                         in zip(names, useds.tolist())}
            max_cpu = int(caps[:, 0].max())
            max_mem = int(caps[:, 1].max())
        else:
            max_cpu = max_mem = 0
        self.shift = (score_shift_for(max_cpu), score_shift_for(max_mem))

    def task_quanta(self, task: TaskInfo) -> Tuple[int, int]:
        return (quantize_value(task.resreq.milli_cpu, 0),
                quantize_value(task.resreq.memory, 1))

    def add(self, task: TaskInfo) -> None:
        if task.node_name in self.used:
            uc, um = self.used[task.node_name]
            dc, dm = self.task_quanta(task)
            self.used[task.node_name] = (uc + dc, um + dm)

    def batch_add(self, batch) -> None:
        if batch.node_quanta is not None:
            # Exact: int sums of the same per-task quanta the device adds.
            for name, (dc, dm) in batch.node_quanta.items():
                if name in self.used:
                    uc, um = self.used[name]
                    self.used[name] = (uc + dc, um + dm)
            return
        for task in batch.tasks:
            self.add(task)

    def sub(self, task: TaskInfo) -> None:
        if task.node_name in self.used:
            uc, um = self.used[task.node_name]
            dc, dm = self.task_quanta(task)
            self.used[task.node_name] = (uc - dc, um - dm)

    def fractions(self, task: TaskInfo, node: NodeInfo) -> Tuple[int, int]:
        """Projected cpu/mem grid fractions if task lands on node."""
        cap = self.cap.get(node.name)
        if cap is None:  # node unknown to the session snapshot
            cap = (quantize_value(node.allocatable.milli_cpu, 0),
                   quantize_value(node.allocatable.memory, 1))
            self.cap[node.name] = cap
            self.used[node.name] = (quantize_value(node.used.milli_cpu, 0),
                                    quantize_value(node.used.memory, 1))
        uc, um = self.used[node.name]
        dc, dm = self.task_quanta(task)
        return (grid_fraction_int(uc + dc, cap[0], self.shift[0]),
                grid_fraction_int(um + dm, cap[1], self.shift[1]))


def least_requested_score(grid: GridUsage, task: TaskInfo,
                          node: NodeInfo) -> int:
    """Mean over cpu/mem of (free after placement) * 10 / allocatable,
    scaled by the grid (upstream least_requested.go semantics)."""
    gc, gm = grid.fractions(task, node)
    return 5 * (2 * SCORE_GRID_K - gc - gm)


def most_requested_score(grid: GridUsage, task: TaskInfo,
                         node: NodeInfo) -> int:
    gc, gm = grid.fractions(task, node)
    return 5 * (gc + gm)


def balanced_resource_score(grid: GridUsage, task: TaskInfo,
                            node: NodeInfo) -> int:
    """10 - |cpuFraction - memFraction| * 10, grid-scaled (upstream
    balanced_resource_allocation.go)."""
    gc, gm = grid.fractions(task, node)
    return 10 * SCORE_GRID_K - 10 * abs(gc - gm)


def interpod_affinity_score(task: TaskInfo, node: NodeInfo) -> int:
    """InterPodAffinity priority (the reference registers upstream
    CalculateInterPodAffinityPriority, nodeorder.go:107-131): sum of
    preferred pod-affinity term weights times matching-pod counts on the
    node (hostname topology), minus the anti-affinity terms.  Like the
    node-affinity scorer we skip upstream's max-normalizing reduce so the
    score stays a pure per-(task, node) integer, grid-scaled to combine
    with the fraction scores.  The session view of ``node.tasks`` includes
    in-flight placements, mirroring the reference's session PodLister."""
    affinity = task.pod.spec.affinity
    if affinity is None or not (affinity.preferred_pod_affinity
                                or affinity.preferred_pod_anti_affinity):
        return 0
    score = 0
    for weight, sel in affinity.preferred_pod_affinity:
        score += weight * sum(
            1 for o in node.tasks.values()
            if all(o.pod.metadata.labels.get(k) == v for k, v in sel.items()))
    for weight, sel in affinity.preferred_pod_anti_affinity:
        score -= weight * sum(
            1 for o in node.tasks.values()
            if all(o.pod.metadata.labels.get(k) == v for k, v in sel.items()))
    return score * SCORE_GRID_K


def node_affinity_score(task: TaskInfo, node: NodeInfo) -> int:
    """Sum of matching preferred-node-affinity term weights (upstream
    node_affinity.go map phase; we skip the max-normalizing reduce so the
    score stays a pure per-(task,node) function — weights act directly),
    grid-scaled to combine with the fraction scores."""
    affinity = task.pod.spec.affinity
    if affinity is None or not affinity.preferred_node_terms:
        return 0
    labels = node.node.metadata.labels if node.node else {}
    score = 0
    for weight, term in affinity.preferred_node_terms:
        if all(labels.get(k) == v for k, v in term.items()):
            score += weight
    return score * SCORE_GRID_K


class NodeOrderPlugin(Plugin):

    def __init__(self, arguments: Arguments):
        self.arguments = arguments

    def name(self) -> str:
        return "nodeorder"

    def weights(self):
        a = self.arguments
        return {
            "leastrequested": a.get_float(LEAST_REQUESTED_WEIGHT, 1.0),
            "mostrequested": a.get_float(MOST_REQUESTED_WEIGHT, 0.0),
            "balancedresource": a.get_float(BALANCED_RESOURCE_WEIGHT, 1.0),
            "nodeaffinity": a.get_float(NODE_AFFINITY_WEIGHT, 1.0),
            "podaffinity": a.get_float(POD_AFFINITY_WEIGHT, 1.0),
        }

    def on_session_open(self, ssn) -> None:
        w = self.weights()
        grid = GridUsage(ssn)
        ssn.add_event_handler(EventHandler(allocate_func=lambda e: grid.add(e.task),
                                           deallocate_func=lambda e: grid.sub(e.task),
                                           batch_allocate_func=grid.batch_add))
        prioritizers = []
        if w["leastrequested"]:
            prioritizers.append((w["leastrequested"],
                                 lambda t, n: least_requested_score(grid, t, n)))
        if w["mostrequested"]:
            prioritizers.append((w["mostrequested"],
                                 lambda t, n: most_requested_score(grid, t, n)))
        if w["balancedresource"]:
            prioritizers.append((w["balancedresource"],
                                 lambda t, n: balanced_resource_score(grid, t, n)))
        if w["nodeaffinity"]:
            prioritizers.append((w["nodeaffinity"], node_affinity_score))
        if w["podaffinity"]:
            prioritizers.append((w["podaffinity"], interpod_affinity_score))
        ssn.add_node_order_fns(self.name(), prioritizers)

    def on_session_close(self, ssn) -> None:
        pass


def new(arguments: Arguments) -> NodeOrderPlugin:
    return NodeOrderPlugin(arguments)
