"""The node-sharded preempt/reclaim scan over a mesh
(kube_batch_tpu/parallel/sharded_scan.py).

The scan is per-node elementwise (ops/scan.py), so each shard scores its
own node slice with the single-device body and the shards' rows are
concatenated in node order: no exchange at all.  The victim-candidate
permutation is computed once, as the reference's replicas each compute
the same one.  PyTorch tensor code: it runs the same on CPU shards and
on CUDA shards.
"""

from __future__ import annotations

import torch

from ..ops.evict_solver import victim_order
from ..ops.scan import ScanStatics, _scan_body, _scan_body_cols
from .mesh import Mesh, ShardedTensor

# ScanStatics leaves split on the node axis, and that axis; score_shift
# is replicated (the reference's scan_statics_specs).
_STATIC_AXES = {"sig_mask": 1, "sig_bonus": 1, "node_alloc": 0,
                "node_max_tasks": 0, "node_exists": 0}


def _block(x, s: int, mesh: Mesh, axis: int) -> torch.Tensor:
    """Shard ``s``'s block of ``x`` along ``axis`` on its device: the
    ShardedTensor's own block, or a slice of a whole tensor (host numpy
    included)."""
    if isinstance(x, ShardedTensor):
        return x.parts[s]
    t = torch.as_tensor(x)
    step = t.shape[axis] // mesh.size
    return t.narrow(axis, s * step, step).to(mesh.devices[s])


def _statics_block(statics: ScanStatics, s: int, mesh: Mesh) -> ScanStatics:
    return ScanStatics(**{
        name: (_block(leaf, s, mesh, _STATIC_AXES[name])
               if name in _STATIC_AXES
               else torch.as_tensor(leaf).to(mesh.devices[s]))
        for name, leaf in zip(ScanStatics._fields, statics)})


def _check(n: int, mesh: Mesh) -> None:
    if n % mesh.size:
        raise ValueError(f"{n} nodes do not divide into {mesh.size} shards")


def scan_nodes_sharded(cfg, r: int, np_pad: int, ns_pad: int,
                       statics: ScanStatics, dyn, trow,
                       mesh: Mesh) -> torch.Tensor:
    """[N] i32 scores equal to ops.scan.scan_nodes, each shard scoring its
    own node rows (the node bucket must divide into the mesh); on the
    mesh's first device."""
    _check(statics.node_exists.shape[0], mesh)
    outs = []
    for s, dev in enumerate(mesh.devices):
        d = _block(dyn, s, mesh, 0).to(dev, torch.int32)
        t = torch.as_tensor(trow).to(dev, torch.int32)
        outs.append(_scan_body(cfg, r, np_pad, ns_pad,
                               _statics_block(statics, s, mesh), d, t))
    first = mesh.devices[0]
    return torch.cat([o.to(first) for o in outs])


def evict_batch_solve_sharded(cfg, r: int, np_pad: int, ns_pad: int,
                              statics: ScanStatics, used, count, ports,
                              selcnt, trows, vic_node, vic_rank,
                              mesh: Mesh):
    """The batched eviction pre-solve (ops/evict_solver.evict_batch_solve)
    with the node axis sharded over ``mesh``: the node state arrives as
    the resident shipper's sharded leaves (node_used, node_count,
    node_ports, node_selcnt), so no node-state byte moves; each shard
    scores every profile row over its own slice, and the [K, N] rows are
    its slices concatenated on the mesh's first device.  The victim
    metadata is O(residents) and replicated: the permutation is computed
    once.  Returns (scores, perm)."""
    _check(statics.node_exists.shape[0], mesh)
    outs = []
    for s, dev in enumerate(mesh.devices):
        rows = torch.as_tensor(trows).to(dev, torch.int32)
        outs.append(_scan_body_cols(
            cfg, _statics_block(statics, s, mesh),
            _block(used, s, mesh, 0), _block(count, s, mesh, 0),
            _block(ports, s, mesh, 0), _block(selcnt, s, mesh, 0), rows,
            r=r, np_pad=np_pad, ns_pad=ns_pad))
    first = mesh.devices[0]
    scores = torch.cat([o.to(first) for o in outs], dim=-1)
    perm = victim_order(torch.as_tensor(vic_node).to(first),
                        torch.as_tensor(vic_rank).to(first))
    return scores, perm
