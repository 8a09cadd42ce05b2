"""The yardstick for the session-solve kernel (K1): the work one session's
solve needs, counted from the session's real sizes and the reference's own
arithmetic, never from the program's padded buffers, and the card's
published peaks.

Operations: every placement scans every real node once, and each
(pod, node) pair costs the reference's fit-and-score arithmetic
(reference/allocate.py ``_score``), counted in OPS_PER_PAIR.

Bytes: the logical snapshot read once and the result written once, in
32-bit words:
- per node: allocatable (2), used (2), pod count, pod cap;
- per pending pod: request (2), its job;
- per job: queue, minMember, creation time;
- per queue: deserved (2), creation time, weight;
- per pod out: node, kind, order.
"""

from __future__ import annotations

from typing import Optional

# Per dimension (2): fit = <, -, abs, <, |; score = +, >>, min, *, //.
# Then: all over the dims, the pod cap <, &; least-requested -, -, *, *w;
# balanced-resource -, abs, *, -, *w; their sum; the feasibility select;
# the max over nodes.
OPS_PER_PAIR = 2 * 5 + 2 * 5 + 3 + 4 + 5 + 1 + 1 + 1

WORD = 4
NODE_WORDS = 6
POD_WORDS = 3
JOB_WORDS = 3
QUEUE_WORDS = 4
OUT_WORDS = 3

# Published peaks, dense, without sparsity: the rate outside the tensor
# cores (the solve does no matrix products) and the memory bandwidth.
# NVIDIA H100 SXM5 data sheet: 67 TFLOP/s FP32, 3.35 TB/s HBM3, at 700 W.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"ops_per_s": 67e12, "bytes_per_s": 3.35e12},
}


def k1_ops(placements: int, nodes: int) -> float:
    return float(placements) * nodes * OPS_PER_PAIR


def k1_bytes(nodes: int, pods: int, jobs: int, queues: int) -> float:
    return float(WORD * (NODE_WORDS * nodes + (POD_WORDS + OUT_WORDS) * pods
                         + JOB_WORDS * jobs + QUEUE_WORDS * queues))


def least_seconds(device: str, placements: int, nodes: int, pods: int,
                  jobs: int, queues: int) -> Optional[float]:
    """The least time the card could take for one solve: the larger of
    operations over the peak rate and bytes over the bandwidth; None for
    a card without published peaks here."""
    peak = PEAKS.get(device)
    if peak is None:
        return None
    return max(k1_ops(placements, nodes) / peak["ops_per_s"],
               k1_bytes(nodes, pods, jobs, queues) / peak["bytes_per_s"])
