"""Session-view helpers for affinity-style plugins.

Counterpart of kube-batch pkg/scheduler/plugins/util/util.go: a
PodLister whose pods reflect *in-session* placements (NodeName overridden to
the session's assignment) and a cached node-info adapter, used by
data-dependent predicates like inter-pod affinity.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from ..api import NodeInfo, TaskInfo, TaskStatus, allocated_status


class PodLister:
    """Lists session pods with node names reflecting current assignments
    (util.go:33-85)."""

    def __init__(self, ssn):
        self.ssn = ssn

    def list(self, selector: Optional[Dict[str, str]] = None) -> List:
        pods = []
        for job in self.ssn.jobs.values():
            for task in job.tasks.values():
                pod = task.pod
                if selector and not all(
                        pod.metadata.labels.get(k) == v
                        for k, v in selector.items()):
                    continue
                # Present the session's placement, not the cluster's.
                if task.node_name and task.node_name != pod.spec.node_name:
                    clone = type(pod)(metadata=pod.metadata,
                                      spec=type(pod.spec)(**vars(pod.spec)),
                                      status=pod.status)
                    clone.spec.node_name = task.node_name
                    pod = clone
                pods.append(pod)
        return pods


class CachedNodeInfo:
    """Node lookup for predicate adapters (util.go:87-114)."""

    def __init__(self, ssn):
        self.ssn = ssn

    def get_node_info(self, name: str) -> NodeInfo:
        node = self.ssn.nodes.get(name)
        if node is None:
            raise KeyError(f"failed to find node {name}")
        return node
