"""Host-path predicate fan-out, scoring, and best-node selection.

Mirrors kube-batch pkg/scheduler/util/scheduler_helper.go.  The
reference fans predicates/scores over 16 goroutines; the host path here is
the *parity oracle* for the TPU path (ops/), so it stays simple and
deterministic.  The heavy [tasks x nodes] work belongs on the TPU.

Determinism note: the reference's SelectBestNode picks randomly among
max-score nodes (scheduler_helper.go:188-208).  Random tie-breaking makes
CPU/TPU placement parity unverifiable, so both of our paths deterministically
pick the max-score node that comes first in node order (name order of the
sorted snapshot); parity tests rely on this.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ..api import FitError, NodeInfo, TaskInfo


def predicate_nodes(task: TaskInfo, nodes: Sequence[NodeInfo],
                    fn) -> List[NodeInfo]:
    """Nodes passing the predicate chain (scheduler_helper.go:63-86).

    The reference fans this out over 16 goroutines; here the [tasks x
    nodes] predicate work is vectorized on device (ops/solver,
    models/scanner) and this host fallback stays sequential — Python
    threads add GIL overhead, not parallelism, to a pure-Python chain."""
    out = []
    for node in nodes:
        try:
            fn(task, node)
            out.append(node)
        except FitError:
            continue
    return out


def prioritize_nodes(task: TaskInfo, nodes: Sequence[NodeInfo],
                     prioritizers) -> List[Tuple[str, float]]:
    """Weighted-sum node scores (scheduler_helper.go:89-171).

    ``prioritizers`` is a list of (weight, NodeOrderFn); the score of a node
    is sum(weight * fn(task, node)).
    """
    result: List[Tuple[str, float]] = []
    for node in nodes:
        score = 0.0
        for weight, fn in prioritizers:
            score += weight * fn(task, node)
        result.append((node.name, score))
    return result


def select_best_node(priority_list: List[Tuple[str, float]]) -> str:
    """Highest score; deterministic first-in-order tie-break (see module
    docstring; reference picks randomly among max)."""
    best_name, best_score = priority_list[0]
    for name, score in priority_list[1:]:
        if score > best_score:
            best_name, best_score = name, score
    return best_name


def sort_nodes(priority_list: List[Tuple[str, float]],
               nodes_info: Dict[str, NodeInfo]) -> List[NodeInfo]:
    """Nodes by descending score (scheduler_helper.go:174-185); name ascending
    as deterministic tie-break."""
    ordered = sorted(priority_list, key=lambda kv: (-kv[1], kv[0]))
    return [nodes_info[name] for name, _ in ordered if name in nodes_info]


def get_node_list(nodes: Dict[str, NodeInfo]) -> List[NodeInfo]:
    """Deterministic node list: sorted by name (reference iterates map order;
    see determinism note)."""
    return [nodes[name] for name in sorted(nodes)]
