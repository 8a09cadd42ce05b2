"""Batched eviction solve: every preemptor's node walk in ONE dispatch
(kube_batch_tpu/ops/evict_solver.py).

``evict_batch_solve`` broadcasts the exact scan body (ops/scan.py) over
a ``[K, L]`` request tensor (K distinct preemptor profiles, L the packed
trow layout ops/scan.py documents), so the whole session's eviction
feasibility + scoring lands in one ``[K, N]`` tensor from one device
dispatch, and fuses the victim-candidate ranking
(per-node Running residents ordered by the host's victim-order key,
shipped as exact int32 rank columns) into the same dispatch.

Eviction itself stays sequential — each commit changes state for the
next preemptor — so the host actions consume these rows optimistically
and recompute only dirty rows (models/scanner.py's edit-log patch path).
Bit-parity contract: ``_scan_body`` is the SAME function the
per-preemptor scan runs, and the numpy mirror
(``DeviceNodeScanner._scores_numpy``) computes the same integers, so a
batched row equals the sequential engines exactly.

PyTorch tensor code on the statics' device (the reference runs it as a
``jax.jit`` XLA program); its plain version is the same code on CPU
tensors, and chip_smoke.py holds the card's answer against it.
"""

from __future__ import annotations

import torch

from .scan import ScanStatics, _scan_body


def victim_order(vic_node: torch.Tensor,
                 vic_rank: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((vic_rank, vic_node))``: residents sorted by node,
    then by victim rank, ties in index order.  One stable argsort of the
    exact int64 key ``node * (mb + 1) + rank`` (rank <= mb), so the
    padding rows (node = N, rank = mb, all equal) keep lexsort's index
    order."""
    mb = vic_rank.shape[0]
    key = vic_node.to(torch.int64) * (mb + 1) + vic_rank.to(torch.int64)
    return torch.argsort(key, stable=True).to(torch.int32)


def evict_batch_solve(cfg, r: int, np_pad: int, ns_pad: int,
                      statics: ScanStatics, dyn: torch.Tensor,
                      trows: torch.Tensor, vic_node: torch.Tensor,
                      vic_rank: torch.Tensor):
    """The session's whole eviction pre-solve as ONE device program:

    * ``[K, N]`` feasibility+score rows for all K preemptor profiles, and
    * the victim-candidate permutation: ``vic_node`` ([M] i32 node row
      of each Running resident) and ``vic_rank`` ([M] i32, the resident's
      position in the host's victim-order key — reversed task order:
      priority ascending, creation-time descending, uid descending —
      staged as exact integer ranks so float precision never reorders a
      tie) sorted to (node ascending, victim order).

    Padding contract: trow padding rows are all-zero (their output rows
    are ignored); victim padding carries node = N (sorts after every
    real node) and rank = M (after every real resident).
    """
    # The scan math is per-node elementwise, so the leading K axis
    # broadcasts (the reference vmaps) and row k equals
    # scan_nodes(.., trows[k]) bit for bit.
    scores = _scan_body(cfg, r, np_pad, ns_pad, statics, dyn, trows)
    perm = victim_order(vic_node, vic_rank)
    return scores, perm


def dispatch_evict_batch_solve(cfg, r: int, np_pad: int, ns_pad: int,
                               statics: ScanStatics, dyn: torch.Tensor,
                               trows: torch.Tensor, vic_node: torch.Tensor,
                               vic_rank: torch.Tensor):
    """Host-side dispatch chokepoint of the batched eviction solve — the
    seam the chaos engine injects device faults into (doc/CHAOS.md site
    ``evict_solve.device_error``).  A no-op single branch when the chaos
    engine is off.  The port has one route, PyTorch on the statics'
    device: the reference's mesh gate, which follows the resident
    buffer's sharding, comes with the node-sharded layout (ROADMAP queue
    1 item 5).  A failure here degrades the scanner to per-profile host
    scoring and feeds the breaker (models/scanner.py batch_seed)."""
    from ..chaos import plan as chaos_plan
    from ..metrics import metrics
    plan = chaos_plan.PLAN
    if plan is not None and plan.fire("evict_solve.device_error"):
        raise RuntimeError(
            "chaos: batched eviction solve failed (injected)")
    metrics.note_route("evict", "torch")
    metrics.note_session_dispatch("evict")
    from ..trace import spans as trace
    trace.annotate(route="torch", mesh_devices=1)
    return evict_batch_solve(cfg, r, np_pad, ns_pad, statics, dyn, trows,
                             vic_node, vic_rank)
