"""Batched slice-shape feasibility: every candidate origin's contiguous-
block question answered in ONE device dispatch
(kube_batch_tpu/ops/topo_solver.py).

A PodGroup requesting a slice shape ``(sx, sy, sz)`` needs an
axis-aligned sub-box of the torus — ``prod(shape)`` nodes at coordinates
``origin + [0..sx) x [0..sy) x [0..sz)`` (mod the pod's torus dims) —
that are all placeable.  The host formulation walks N origins x vol box
offsets; this module vectorizes the whole question as a pairwise
membership scan over the int32 coordinate rows (models/topology.py's
``node_coords`` leaf layout): one program returns, per origin,

  * ``complete``       — the box has all prod(shape) member nodes
                         (wrapped self-overlap can never fake this: a
                         torus axis shorter than the request covers
                         fewer distinct positions, so the count falls
                         short — doc/TOPOLOGY.md),
  * ``free_cnt``       — members currently free,
  * ``blocked``        — members neither free nor evictable (a box with
                         blocked > 0 can never become this slice),
  * ``vic_cnt`` / ``vic_cost`` — the defrag evictor's cost row: how many
                         victims (and their priority sum) clearing the
                         box would evict,
  * ``boundary_free``  — free nodes OUTSIDE the box torus-adjacent to
                         it: the fragmentation-aware placement key
                         (fewer free neighbors = tighter packing =
                         larger contiguous blocks preserved elsewhere).

``box_scan_seq`` is the pure-numpy per-origin sequential oracle — a
structurally different implementation computing the same exact integers
(pinned by tests/test_torch_topology.py); ``KUBE_BATCH_TPU_TOPO_BATCH=0``
routes every live scan through it.  ``dispatch_box_scan`` is the routing
chokepoint, counted in ``kube_batch_solver_route_total{family="topo"}``.

PyTorch tensor code on the inputs' device (the reference runs it as a
``jax.jit`` XLA program; no hand-written kernel).  The port has one
route, ``torch``, on one device: the origin-sharded mesh route
(``box_scan_sharded``) comes with the multi-device mesh (ROADMAP queue 1
item 5), and the compile-cache key accounting (``note_solve_key``) with
warmup (item 8).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

TOPO_SOLVE_CHOICE = "topo_box"

# Stats column layout (shared by the batched program and the oracle).
COL_COMPLETE = 0
COL_FREE = 1
COL_BLOCKED = 2
COL_VCNT = 3
COL_VCOST = 4
COL_BOUNDARY = 5
N_COLS = 6


class BoxInputs(NamedTuple):
    """One scan's staged arrays ([N] over the padded node bucket)."""
    coords: torch.Tensor     # [N, 8] i32 (models/topology.COORD_WIDTH)
    free: torch.Tensor       # [N] bool: placeable now (empty + fits + preds)
    evictable: torch.Tensor  # [N] bool: clearable for this preemptor
    vic_cnt: torch.Tensor    # [N] i32 victims resident on the node
    vic_cost: torch.Tensor   # [N] i32 victim priority sum on the node


def _box_body(coords, free, evictable, vic_cnt, vic_cost, origins,
              sx: int, sy: int, sz: int) -> torch.Tensor:
    """The box scan over an ``origins`` row block ([L, 8]; the whole
    bucket on one device).  int32 elementwise math and one exact float32
    product of 0/1 matrices; every term is exact.  The [L, N, 3] and
    [N, N, 3] intermediates are int32 (201 MB each at N = 4,096) and are
    dropped before the next one is made."""
    i32 = torch.int32
    valid = coords[:, 0] >= 0
    o_valid = origins[:, 0] >= 0
    pod = coords[:, 0]
    xyz = coords[:, 2:5]
    dims = torch.clamp(coords[:, 5:8], min=1)

    o_pod = origins[:, 0]
    o_xyz = origins[:, 2:5]
    o_dims = torch.clamp(origins[:, 5:8], min=1)

    # Pairwise torus offsets of every node j relative to every origin o,
    # modulo the ORIGIN's pod dims (same pod => same dims).  Floored
    # modulo, as jnp.mod: the differences are negative for half the
    # pairs, and torch.fmod would keep their sign.
    d = torch.remainder(xyz[None, :, :] - o_xyz[:, None, :],
                        o_dims[:, None, :])
    member = (o_valid[:, None] & valid[None, :]
              & (pod[None, :] == o_pod[:, None])
              & (d[:, :, 0] < sx) & (d[:, :, 1] < sy) & (d[:, :, 2] < sz))
    del d
    m32 = member.to(i32)

    vol = sx * sy * sz
    cnt = m32.sum(dim=1, dtype=i32)
    complete = (o_valid & (cnt == vol)).to(i32)
    free_cnt = (m32 * free.to(i32)[None, :]).sum(dim=1, dtype=i32)
    blocked = (m32 * (~free & ~evictable & valid).to(i32)[None, :]) \
        .sum(dim=1, dtype=i32)
    vcnt = (m32 * vic_cnt[None, :]).sum(dim=1, dtype=i32)
    vcost = (m32 * vic_cost[None, :]).sum(dim=1, dtype=i32)
    del m32

    # Torus adjacency of every (j, k) node pair: same pod, exactly one
    # axis one step apart (mod dims), the rest equal.
    dd = torch.remainder(xyz[None, :, :] - xyz[:, None, :],
                         dims[:, None, :])
    step = ((dd == 1) | (dd == (dims[:, None, :] - 1))) \
        & (dims[:, None, :] > 1)
    same = dd == 0
    del dd
    one_step = ((step[:, :, 0] & same[:, :, 1] & same[:, :, 2])
                | (same[:, :, 0] & step[:, :, 1] & same[:, :, 2])
                | (same[:, :, 0] & same[:, :, 1] & step[:, :, 2]))
    adj = (valid[:, None] & valid[None, :]
           & (pod[:, None] == pod[None, :]) & one_step
           & ~(same[:, :, 0] & same[:, :, 1] & same[:, :, 2]))
    del step, same, one_step
    # The reference's ``m32 @ adj`` is an int32 matmul, which PyTorch
    # lacks on CUDA.  Only ``> 0`` is read, and every partial sum of the
    # 0/1 product is at most N < 2**24, so a float32 product is exact
    # (TF32 too: its inputs are 0 and 1).
    touch = (member.to(torch.float32) @ adj.to(torch.float32)) > 0
    del adj
    boundary_free = (touch & ~member & free[None, :]).sum(dim=1, dtype=i32)

    return torch.stack([complete, free_cnt, blocked, vcnt, vcost,
                        boundary_free], dim=1)


def box_scan(inp: BoxInputs, sx: int, sy: int, sz: int) -> torch.Tensor:
    """[N, 6] i32 per-origin stats on the inputs' device; every node row
    is a candidate origin."""
    return _box_body(inp.coords, inp.free, inp.evictable, inp.vic_cnt,
                     inp.vic_cost, inp.coords, sx, sy, sz)


def box_scan_sharded(inp: BoxInputs, sx: int, sy: int, sz: int, mesh):
    """The origin-axis sharded scan of the reference; it comes with the
    multi-device mesh (ROADMAP queue 1 item 5)."""
    raise NotImplementedError(
        "the origin-sharded box scan comes with the multi-device mesh; "
        "one device scans on the torch route")


def box_scan_seq(view, free, evictable, vic_cnt, vic_cost,
                 shape) -> np.ndarray:
    """The sequential oracle: per-origin Python walk over box offsets
    through the view's coordinate index — the reference formulation the
    batched program must match bit-for-bit.  [N, 6] i32 over the view's
    (unpadded) node rows."""
    sx, sy, sz = shape
    vol = sx * sy * sz
    n = len(view.node_names)
    out = np.zeros((n, N_COLS), np.int32)
    nbrs = view.neighbors()
    for o in range(n):
        if not view.valid[o]:
            continue
        pod, _r, x, y, z, dx, dy, dz = (int(v) for v in view.coords[o])
        members = []
        for ox in range(sx):
            for oy in range(sy):
                for oz in range(sz):
                    j = view._index.get(
                        (pod, (x + ox) % dx, (y + oy) % dy, (z + oz) % dz))
                    if j is not None:
                        members.append(j)
        members = set(members)
        cnt = len(members)
        out[o, COL_COMPLETE] = 1 if cnt == vol else 0
        boundary = set()
        for j in members:
            if free[j]:
                out[o, COL_FREE] += 1
            elif not evictable[j]:
                out[o, COL_BLOCKED] += 1
            out[o, COL_VCNT] += int(vic_cnt[j])
            out[o, COL_VCOST] += int(vic_cost[j])
            for k in nbrs[j]:
                if k not in members and free[k]:
                    boundary.add(k)
        out[o, COL_BOUNDARY] = len(boundary)
    return out


def choose_topo_route(n_pad: int):
    """('torch', None): one device scans every origin.  The reference's
    mesh gate (the allocate/evict engines' node-count gate) and its
    ``sharded`` route come with the multi-device mesh (ROADMAP queue 1
    item 5)."""
    return "torch", None


def topo_solve_key(route: str, n_pad: int, shape) -> tuple:
    """Compile-cache identity of one box-scan program (the
    evict_solve_key discipline): route + padded node bucket + the static
    slice shape."""
    return (TOPO_SOLVE_CHOICE, route, n_pad, tuple(shape))


def stage_box_inputs(inp: BoxInputs, device) -> BoxInputs:
    """``inp`` (numpy arrays or tensors) as tensors on ``device``."""
    return BoxInputs(*(torch.as_tensor(a, device=device) for a in inp))


def dispatch_box_scan(inp: BoxInputs, shape, device) -> np.ndarray:
    """Route and run one batched box scan on ``device``, returning host
    [N, 6] i32.  The one production chokepoint: the route counter and
    the dispatch counter live here.  A failure raises to the caller,
    which degrades to the numpy oracle (actions/topo_allocate.py)."""
    from ..metrics import metrics
    from ..trace import spans as trace

    sx, sy, sz = (int(v) for v in shape)
    n_pad = int(inp.coords.shape[0])
    route, mesh = choose_topo_route(n_pad)
    metrics.note_route("topo", route)
    metrics.note_session_dispatch("topo")
    trace.annotate(route=route, mesh_devices=mesh.size if mesh else 1)
    return box_scan(stage_box_inputs(inp, device), sx, sy, sz).cpu().numpy()
