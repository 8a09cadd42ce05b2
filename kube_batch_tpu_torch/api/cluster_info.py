"""ClusterInfo: the immutable per-session snapshot root.

Mirrors kube-batch pkg/scheduler/api/cluster_info.go:22-26.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from .job_info import JobInfo
from .node_info import NodeInfo
from .queue_info import QueueInfo


@dataclass
class ClusterInfo:
    jobs: Dict[str, JobInfo] = field(default_factory=dict)
    nodes: Dict[str, NodeInfo] = field(default_factory=dict)
    queues: Dict[str, QueueInfo] = field(default_factory=dict)

    def __repr__(self) -> str:
        return (f"ClusterInfo(jobs={len(self.jobs)}, nodes={len(self.nodes)}, "
                f"queues={len(self.queues)})")
