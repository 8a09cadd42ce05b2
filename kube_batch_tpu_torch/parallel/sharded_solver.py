"""The node-sharded allocate solve over a mesh
(kube_batch_tpu/parallel/sharded_solver.py).

Every shard owns a contiguous node slice (parallel/mesh.py); task, job
and queue state is replicated, so every shard runs the same queue and job
pops.  Per placement each shard finds its local first max (the best
score, then the first index), and the shards reduce them as the
reference's two collectives do: the max of the scores (``pmax``), then
the min of the word ``(global index << 2) | (fit_idle << 1) | fit_rel``
among the shards at that max (``pmin``).  Shards are contiguous, so ties
break on the global first node index and the placements equal the
single-device solve's.  Only the owning shard updates its node.

On CUDA shards the solve is K1's shard mode
(``ops/cuda_solver.solve_allocate_cuda_sharded``): one launch per shard,
the reduction through an exchange buffer, the whole session on the
device.  On CPU shards it is that mode's plain version,
``solve_allocate_sharded_plain``: the plain session solve with the
reduction written out in Python.  A loop driven from Python, one step per
placement, is no route for the card (minutes at the north-star size).
"""

from __future__ import annotations

import torch

from ..ops.solver import SolveResult, SolverConfig, SolverInputs
from .mesh import (Mesh, ShardedTensor, shard_mesh, shard_solver_inputs,
                   shard_view)


def _in_layout(inp: SolverInputs, mesh: Mesh) -> SolverInputs:
    """``inp`` in ``mesh``'s layout (sharded by the caller already, or
    split here)."""
    have = shard_mesh(inp)
    if have is not None:
        if have != mesh:
            raise ValueError(f"inputs sharded over {have}, not {mesh}")
        return inp
    return shard_solver_inputs(inp, mesh)


def gather_candidate_sharded(inp: SolverInputs, local_idx, valid,
                             mesh: Mesh) -> SolverInputs:
    """The per-shard candidate-row gather (ops/prefilter.py): shard s
    takes ITS OWN candidate rows (``local_idx[s]``, [n_dev, L]
    device-local indices) out of its resident node slice, so no node row
    leaves its shard, and the gathered leaves keep the mesh layout at the
    smaller n_dev * L bucket.  Padding rows repeat a real local row and
    are masked out through ``node_exists & valid`` (the single-device
    gather's discipline).  ``index_select`` allocates: the gathered
    leaves never alias the resident buffer."""
    inp = _in_layout(inp, mesh)
    idx = torch.as_tensor(local_idx)
    ok = torch.as_tensor(valid)
    parts = {name: [] for name in (
        "node_idle", "node_releasing", "node_used", "node_alloc",
        "node_count", "node_max_tasks", "node_exists", "node_ports",
        "node_selcnt", "sig_mask", "sig_bonus")}
    for s, dev in enumerate(mesh.devices):
        ix = idx[s].to(dev, torch.long)
        for name in parts:
            leaf = getattr(inp, name).parts[s]
            axis = 1 if name.startswith("sig_") else 0
            got = torch.index_select(leaf, axis, ix)
            if name == "node_exists":
                got = got & ok[s].to(dev)
            parts[name].append(got)
    return inp._replace(**{
        name: ShardedTensor(p, 1 if name.startswith("sig_") else 0, mesh)
        for name, p in parts.items()})


def solve_allocate_sharded_plain(inp: SolverInputs, cfg: SolverConfig,
                                 mesh: Mesh = None):
    """The shard mode's plain version: the plain session solve
    (ops/cuda_solver.py) with one node block per shard, each on its
    shard's device, and the per-placement reduction of the reference's
    pmax and pmin.  Returns (SolveResult, FinalState), the FinalState's
    node rows every shard's, concatenated in node order."""
    from ..ops.cuda_solver import _operands, _solve_blocks
    inp = _in_layout(inp, mesh or shard_mesh(inp))
    k = shard_mesh(inp).size
    return _solve_blocks([_operands(shard_view(inp, s)) for s in range(k)],
                         cfg)


def solve_allocate_sharded(inp: SolverInputs, cfg: SolverConfig,
                           mesh: Mesh) -> SolveResult:
    """The session solve with the node state sharded over ``mesh``: K1's
    shard mode on CUDA shards, its plain version on CPU shards."""
    inp = _in_layout(inp, mesh)
    if all(d.type == "cuda" for d in mesh.devices):
        from ..ops.cuda_solver import solve_allocate_cuda_sharded
        return solve_allocate_cuda_sharded(inp, cfg)[0]
    if any(d.type == "cuda" for d in mesh.devices):
        raise ValueError(f"a mesh mixes CUDA and CPU shards: {mesh}")
    return solve_allocate_sharded_plain(inp, cfg, mesh)[0]
