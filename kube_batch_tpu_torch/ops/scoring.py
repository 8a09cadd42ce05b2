"""Node scoring on the integer grid (kube_batch_tpu/ops/scoring.py).

Least-requested, most-requested and balanced-resource priorities for one
task against all N nodes.  Utilization fractions are computed on the
shared SCORE_GRID_K grid and combined with integer weights, so the score
integers equal the reference's on every device:

  least    = 5*(2K - gc - gm)
  most     = 5*(gc + gm)
  balanced = 10*K - 10*|gc - gm|
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .resources import SCORE_GRID_K

# Sentinel for infeasible nodes in integer score argmaxes: far below any
# real score (scores are >= 0, <= ~2**27 for sane weights).
SCORE_NEG_INF = -(2 ** 31) + 1


class ScoreWeights(NamedTuple):
    """Integer plugin weights (nodeorder.go:107-131)."""
    least_requested: int = 1
    most_requested: int = 0
    balanced_resource: int = 1


def shifted_caps(allocatable: torch.Tensor, shift: torch.Tensor):
    """(cs, cs_den) per cpu/mem dim for grid_score.
    allocatable: [N, R] i32; shift: [2] i32."""
    cs = [torch.bitwise_right_shift(allocatable[:, d], shift[d])
          for d in range(2)]
    den = [torch.clamp(c, min=1).to(torch.float32) for c in cs]
    return cs, den


def grid_score(task_res: torch.Tensor, used: torch.Tensor,
               shift: torch.Tensor, cs, cs_den,
               weights: ScoreWeights) -> torch.Tensor:
    """Weighted-sum integer score [N] for one task over all nodes; int32
    arithmetic wraps as in XLA, and the grid division is float32."""
    g = []
    for d in range(2):
        xs = torch.minimum(
            torch.bitwise_right_shift(used[:, d] + task_res[d], shift[d]),
            cs[d])
        num = (xs * SCORE_GRID_K).to(torch.float32)
        q = (num / cs_den[d]).to(torch.int32)  # trunc == floor (>= 0)
        g.append(torch.where(cs[d] == 0, SCORE_GRID_K, q))
    gc, gm = g
    score = torch.zeros(used.shape[0], dtype=torch.int32, device=used.device)
    w_least = int(weights.least_requested)
    w_most = int(weights.most_requested)
    w_bal = int(weights.balanced_resource)
    if w_least:
        score = score + w_least * 5 * (2 * SCORE_GRID_K - gc - gm)
    if w_most:
        score = score + w_most * 5 * (gc + gm)
    if w_bal:
        score = score + w_bal * (10 * SCORE_GRID_K
                                 - 10 * torch.abs(gc - gm))
    return score


def score_nodes(task_res: torch.Tensor, used: torch.Tensor,
                allocatable: torch.Tensor, shift: torch.Tensor,
                weights: ScoreWeights) -> torch.Tensor:
    """grid_score with the capacities shifted on the fly."""
    cs, den = shifted_caps(allocatable, shift)
    return grid_score(task_res, used, shift, cs, den, weights)
