"""Batched node scan for preempt/reclaim: predicates + scores over all
nodes in one device call (kube_batch_tpu/ops/scan.py).

The reference's preempt/reclaim walk every node per pending preemptor with
per-node predicate and prioritizer calls (preempt.go:171-254 via
util.PredicateNodes/PrioritizeNodes 16-goroutine fan-out;
reclaim.go:115-170).  This program vectorizes one preemptor's walk: the
session-static tensors (signature mask, score bonus, capacities) live on
the device for the whole action, the dynamic node state (used/count/
ports/selcnt) ships as ONE packed int32 buffer per call, and the result
is a single [N] int32 score vector — SCORE_NEG_INF marks nodes that fail
the predicate chain, so feasibility and ordering come back in one
transfer.

PyTorch tensor code on the statics' device, not a hand-written kernel:
the reference runs it as a ``jax.jit`` XLA program.  Every term is int32
as there (the grid division is float32, exact by construction), so the
integers equal the reference's; ``torch.sum`` of int32 promotes to int64,
so the one reduction casts back to int32, wrapping as XLA's int32 sum
does.

NOTE: unlike the allocate solver, the scan deliberately has NO resource-fit
check — preempt/reclaim predicate candidate nodes before any eviction frees
room (allocate.go's fit closure is allocate-only; preempt.go:180 uses the
plugin chain alone).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .resources import SCORE_GRID_K
from .scoring import SCORE_NEG_INF, grid_score, shifted_caps


class ScanStatics(NamedTuple):
    """Device-resident per-session constants for the scan."""
    sig_mask: torch.Tensor     # [S, N] bool
    sig_bonus: torch.Tensor    # [S, N] i32
    node_alloc: torch.Tensor   # [N, R] i32
    node_max_tasks: torch.Tensor  # [N] i32
    node_exists: torch.Tensor  # [N] bool
    score_shift: torch.Tensor  # [2] i32


def _scan_body(cfg, r: int, np_pad: int, ns_pad: int, statics: ScanStatics,
               dyn: torch.Tensor, trow: torch.Tensor) -> torch.Tensor:
    """The scan math over the packed ``dyn`` buffer.  ``trow`` is one
    packed preemptor ([L]) or a batch of them ([K, L]): every term is
    per-node elementwise, so a leading profile axis broadcasts and row k
    of the [K, N] result equals the [N] scan of ``trow[k]`` exactly."""
    used = dyn[:, :r]
    count = dyn[:, r]
    ports = dyn[:, r + 1:r + 1 + np_pad]
    selcnt = dyn[:, r + 1 + np_pad:r + 1 + np_pad + ns_pad]
    return _scan_body_cols(cfg, statics, used, count, ports, selcnt, trow,
                           r=r, np_pad=np_pad, ns_pad=ns_pad)


def _scan_body_cols(cfg, statics: ScanStatics, used, count, ports, selcnt,
                    trow: torch.Tensor, *, r: int, np_pad: int,
                    ns_pad: int) -> torch.Tensor:
    """The scan math over UNPACKED node columns ([N] or [N, *] each).
    ``trow``: [L] or [K, L] int32; the result is [N] or [K, N] int32."""
    sig = trow[..., 0]
    res = trow[..., 1:1 + r]
    off = 1 + r
    t_ports = trow[..., off:off + np_pad]
    off += np_pad
    t_aff = trow[..., off:off + ns_pad]
    off += ns_pad
    t_anti = trow[..., off:off + ns_pad]
    off += ns_pad
    t_paffw = trow[..., off:off + ns_pad]
    off += ns_pad
    t_pantiw = trow[..., off:off + ns_pad]

    feasible = (statics.sig_mask[sig] & statics.node_exists
                & (count < statics.node_max_tasks))
    if cfg.has_ports:
        conflict = ((t_ports[..., None, :] > 0) & (ports > 0)).any(dim=-1)
        feasible = feasible & ~conflict
    if cfg.has_pod_affinity:
        have = selcnt > 0
        aff_ok = torch.all((t_aff[..., None, :] == 0) | have, dim=-1)
        anti_ok = torch.all((t_anti[..., None, :] == 0) | ~have, dim=-1)
        feasible = feasible & aff_ok & anti_ok

    cs, den = shifted_caps(statics.node_alloc, statics.score_shift)
    # grid_score indexes the task's resources by dimension: hand it the
    # per-dimension columns with a trailing node axis, so a [K] profile
    # column broadcasts against the [N] node columns.
    score = grid_score(res.movedim(-1, 0).unsqueeze(-1), used,
                       statics.score_shift, cs, den, cfg.weights)
    if cfg.has_pod_affinity_score:
        wdiff = (t_paffw - t_pantiw)[..., None, :]
        acc = torch.sum(wdiff * selcnt, dim=-1).to(torch.int32)
        score = score + SCORE_GRID_K * acc
    score = score + statics.sig_bonus[sig]
    return torch.where(feasible, score, SCORE_NEG_INF)


def scan_nodes(cfg, r: int, np_pad: int, ns_pad: int, statics: ScanStatics,
               dyn: torch.Tensor, trow: torch.Tensor) -> torch.Tensor:
    """[N] i32 scores; SCORE_NEG_INF where the predicate chain rejects.

    ``dyn`` packs the mutable node state column-wise:
        [0:r] used | [r] count | [r+1 : r+1+np_pad] ports |
        [r+1+np_pad : r+1+np_pad+ns_pad] selcnt
    (idle/releasing are irrelevant here — no fit check, and scoring reads
    used only).  ``trow`` packs the preemptor:
        [0] sig | [1:1+r] res | ports | aff | anti | match(paffw) | pantiw
    Both are int32 tensors on the statics' device."""
    return _scan_body(cfg, r, np_pad, ns_pad, statics, dyn, trow)


def choose_scan_mesh(n_nodes: int):
    """('sharded'|'torch', mesh): the eviction scan's mesh gate, the
    allocate gate's node count and its pinned knobs (ops/solver.
    shard_knobs; the bytes gate needs whole SolverInputs and is
    allocate-only), so preempt and reclaim shard when allocate does."""
    from ..parallel.mesh import default_mesh
    from .solver import shard_knobs
    mesh = default_mesh()
    if mesh is not None and n_nodes % mesh.size == 0:
        gate = shard_knobs()
        if gate.force or n_nodes >= gate.nodes:
            return "sharded", mesh
    return "torch", None


def best_scan_nodes(cfg, r: int, np_pad: int, ns_pad: int,
                    statics: ScanStatics, dyn, trow) -> torch.Tensor:
    """Route one preemptor's node walk: the node-sharded scan when the
    mesh gate says so (parallel/sharded_scan.py), else PyTorch on the
    statics' device.  ``dyn`` and ``trow`` may be host numpy arrays: they
    move to the device here.  Statics in the mesh layout that the gate
    does not shard (the bytes gate sharded the resident image) are
    gathered onto one device."""
    from ..metrics import metrics
    choice, mesh = choose_scan_mesh(statics.node_exists.shape[0])
    metrics.note_route("scan", choice)
    if choice == "sharded":
        from ..parallel.sharded_scan import scan_nodes_sharded
        return scan_nodes_sharded(cfg, r, np_pad, ns_pad, statics, dyn,
                                  trow, mesh)
    statics = ScanStatics(*(leaf.full() if hasattr(leaf, "full") else leaf
                            for leaf in statics))
    dev = statics.node_exists.device
    return scan_nodes(cfg, r, np_pad, ns_pad, statics,
                      torch.as_tensor(dyn, dtype=torch.int32, device=dev),
                      torch.as_tensor(trow, dtype=torch.int32, device=dev))
