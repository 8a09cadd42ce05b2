"""Predicates plugin: node feasibility checks.

The reference wraps the upstream kube-scheduler predicate library
(kube-batch pkg/scheduler/plugins/predicates/predicates.go:123-265):
pod-count cap, unschedulable node, node selector + required node affinity,
host ports, taints/tolerations, and inter-pod (anti-)affinity evaluated
against the session's in-flight assignments (plugins/util/util.go PodLister).
This is a standalone reimplementation of those checks over our object model.

Each check is also expressible as a static [tasks x nodes] boolean mask on
TPU (ops/feasibility.py); inter-pod affinity is the one dynamic mask that
must refresh as the assignment loop progresses, which both paths honor (the
host path by scanning ``node.tasks``, the device path by re-masking inside
the solver loop).
"""

from __future__ import annotations

from ..api import FitError, NodeInfo, TaskInfo
from ..framework import Arguments, Plugin

# Argument keys (predicates.go:33-40).
MEMORY_PRESSURE_PREDICATE = "predicate.MemoryPressureEnable"
DISK_PRESSURE_PREDICATE = "predicate.DiskPressureEnable"
PID_PRESSURE_PREDICATE = "predicate.PIDPressureEnable"


def pod_matches_node_selector(task: TaskInfo, node: NodeInfo) -> bool:
    labels = node.node.metadata.labels if node.node else {}
    for key, value in task.pod.spec.node_selector.items():
        if labels.get(key) != value:
            return False
    affinity = task.pod.spec.affinity
    if affinity is not None and affinity.required_node_terms:
        # OR of ANDs over label terms.
        for term in affinity.required_node_terms:
            if all(labels.get(k) == v for k, v in term.items()):
                break
        else:
            return False
    return True


def tolerates_node_taints(task: TaskInfo, node: NodeInfo) -> bool:
    taints = node.node.spec.taints if node.node else []
    for taint in taints:
        if taint.effect == "PreferNoSchedule":
            continue
        if not any(t.tolerates(taint) for t in task.pod.spec.tolerations):
            return False
    return True


def host_ports_conflict(task: TaskInfo, node: NodeInfo) -> bool:
    wanted = {(p.host_port, p.protocol)
              for c in task.pod.spec.containers for p in c.ports
              if p.host_port > 0}
    if not wanted:
        return False
    for other in node.tasks.values():
        for c in other.pod.spec.containers:
            for p in c.ports:
                if p.host_port > 0 and (p.host_port, p.protocol) in wanted:
                    return True
    return False


def _labels_match(selector: dict, labels: dict) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


def pod_affinity_ok(task: TaskInfo, node: NodeInfo) -> bool:
    """Required pod affinity / anti-affinity against the node's current
    session-view tasks (topology key = hostname).  Reads ``node.tasks``,
    which includes in-session assignments — the moral equivalent of the
    reference's session-backed PodLister (plugins/util/util.go:33-114)."""
    affinity = task.pod.spec.affinity
    if affinity is None:
        return True
    if affinity.required_pod_affinity:
        for selector in affinity.required_pod_affinity:
            if not any(_labels_match(selector, other.pod.metadata.labels)
                       for other in node.tasks.values()):
                return False
    if affinity.required_pod_anti_affinity:
        for selector in affinity.required_pod_anti_affinity:
            for other in node.tasks.values():
                if other.uid == task.uid:
                    continue
                if _labels_match(selector, other.pod.metadata.labels):
                    return False
    return True


class PredicatesPlugin(Plugin):

    def __init__(self, arguments: Arguments):
        self.arguments = arguments
        # Pressure checks are opt-in via Arguments (predicates.go:71-110,
        # defaults false).
        self.check_memory = arguments.get_bool(MEMORY_PRESSURE_PREDICATE)
        self.check_disk = arguments.get_bool(DISK_PRESSURE_PREDICATE)
        self.check_pid = arguments.get_bool(PID_PRESSURE_PREDICATE)

    def name(self) -> str:
        return "predicates"

    def on_session_open(self, ssn) -> None:
        # NODE READ-SET CONTRACT: the static checks below read, per node,
        # exactly {the five named conditions, allocatable.max_task_num vs
        # len(node.tasks), spec.unschedulable, spec.taints (non-
        # PreferNoSchedule), labels at keys the task references} — plus
        # the dynamic ports/pod-affinity occupancy re-evaluated in-loop.
        # models/tensor_snapshot.py collapses nodes into static profiles
        # keyed on THIS read-set before evaluating the chain; if a new
        # node-dependent check is added here, the profile key there MUST
        # gain the field or nodes differing only in it will silently share
        # a verdict (tests/test_tensorize_hetero.py pins exactness only
        # over fields the key already covers).
        def predicate_fn(task: TaskInfo, node: NodeInfo) -> None:
            if node.node is None:
                raise FitError(task, node, "node not initialized")
            conditions = node.node.status.conditions
            # NodeCondition predicate (predicates.go:132-146; upstream
            # CheckNodeConditionPredicate, vendored predicates.go:1675-1698):
            # schedulable only when a REPORTED Ready condition is "True" and
            # a reported NetworkUnavailable is "False" (absent conditions
            # pass — upstream iterates only present ones).  The snapshot
            # usually excludes such nodes already; this is the
            # per-predicate form with its distinct messages.
            ready = conditions.get("Ready")
            if ready is not None and ready != "True":
                raise FitError(task, node, "node(s) were not ready")
            net = conditions.get("NetworkUnavailable")
            if net is not None and net != "False":
                raise FitError(task, node,
                               "node(s) had unavailable network")
            # Node pressure conditions (predicates.go:201-247).
            if self.check_memory and conditions.get("MemoryPressure") == "True":
                raise FitError(task, node, "node has memory pressure")
            if self.check_disk and conditions.get("DiskPressure") == "True":
                raise FitError(task, node, "node has disk pressure")
            if self.check_pid and conditions.get("PIDPressure") == "True":
                raise FitError(task, node, "node has pid pressure")
            # Pod-count cap (predicates.go:127).
            if node.allocatable.max_task_num <= len(node.tasks):
                raise FitError(task, node, "node has too many pods")
            # Unschedulable node (predicates.go:146).
            if node.node.spec.unschedulable:
                raise FitError(task, node, "node unschedulable")
            # Node selector + required node affinity (predicates.go:160).
            if not pod_matches_node_selector(task, node):
                raise FitError(task, node, "node didn't match node selector")
            # Host ports (predicates.go:174).
            if host_ports_conflict(task, node):
                raise FitError(task, node, "node didn't have free ports")
            # Taints/tolerations (predicates.go:188).
            if not tolerates_node_taints(task, node):
                raise FitError(task, node, "taints not tolerated")
            # Inter-pod (anti-)affinity (predicates.go:249-262).
            if not pod_affinity_ok(task, node):
                raise FitError(task, node, "pod affinity/anti-affinity mismatch")

        ssn.add_predicate_fn(self.name(), predicate_fn)

    def on_session_close(self, ssn) -> None:
        pass


def new(arguments: Arguments) -> PredicatesPlugin:
    return PredicatesPlugin(arguments)
