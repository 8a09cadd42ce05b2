"""The whole-session allocate solve as one CUDA kernel launch.

Counterpart of kube_batch_tpu/ops/pallas_solver.py: ``build_buffers`` is
``_build_buffers``, ``solve_allocate_cuda`` launches
``csrc/solve_session.cu`` (the port of ``_solve_kernel``), and
``solve_allocate_plain`` is a plain PyTorch transcription of that kernel
over the same buffers.  The plain version is what the CPU route runs and
what the tests and chip_smoke.py hold the kernel against; nothing on the
main path calls it for CUDA tensors.  ``solve_allocate_cuda_sharded``
launches the same kernel in its shard mode, one launch per shard of a
node-sharded mesh (parallel/); its plain version is
``parallel.sharded_solver.solve_allocate_sharded_plain``, the plain
solve over one node block per shard (``_solve_blocks``).

Buffer layout (rows padded to multiples of 8, as in the reference):

  node_int [pad8(3R+3), N] i32: idle, releasing, used rows, count, pod
      cap, exists flag; all resource state is int32 quanta, so every
      update and epsilon compare is exact integer math.
  node_cs  [8, N] i32: shift-normalized cpu/mem capacities (grid score).
  jsta     [8, J] float: start, count, queue, minavail, priority, ts,
      uid rank (the ints stay below 2**24, exact in float32).
  jdyn     [pad8(R+3), J] i32: drf alloc rows, ptr, ready count, active.
  qdes     [pad8(R), Q] i32: proportion deserved (overused compare).
  qsta     [pad8(3+R), Q] float: ts, uid rank, exists, then the unrounded
      deserved rows (share denominators).
  qdyn     [pad8(R+1), Q] i32: alloc rows, active.

Every row offset comes from ``layout()``, the one table that
``build_buffers``, the plain version and the kernel's launch arguments
share.  ``cluster_plan()`` decides how one launch spreads the session over
a thread-block cluster: the cluster size, each CTA's node slice, which
rows live in shared memory and the bytes that takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .fairness import safe_share
from .resources import EPS_QUANTA, SCORE_GRID_K
from .scoring import SCORE_NEG_INF
from .solver import SolveResult, SolverConfig, SolverInputs

log = logging.getLogger(__name__)

# Threads of one CTA (kThreads in the kernel), the shared memory one CTA
# may hold on an H100, and the cluster sizes the kernel launches with (16
# is Hopper's non-portable size).  The card's own bound on the cluster
# size, asked once per plan at launch (``hostable_plan``), caps the plan.
THREADS = 512
SMEM_PER_CTA = 232_448
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# A CTA's slice is at most this many nodes (2 a thread) where a cluster
# of CLUSTER_SIZES allows: the scan shrinks with the slice faster than the
# exchange grows with the cluster (north-star shape: 16 CTAs of 640 nodes
# beat 8 of 1,280 and 4 of 2,560; kernel_ab.py, PERF.md).
SLICE_NODES = 2 * THREADS

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "solve_session.cu"
# Inside the checkout and listed in .gitignore; built at first use.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared",
              "-Xcompiler", "-fPIC")
# The build's units, compiled at once and linked into one library: each
# defines the three kR instantiations of one (float type, phase stamps,
# on-chip, shard mode) combination (csrc/solve_session.cu
# ``launch_instance``); the entry unit, with none of these macros,
# dispatches and carries the C interface.  Shard mode's units are a
# library of their own (SHARD_UNITS, its entry built with
# -DKBT_ENTRY_SHARD), built at the first sharded solve: the daemon's
# boot on a host that never shards compiles only UNITS.
UNITS = tuple((t, s, c, "false") for t in ("float", "double")
              for s in ("false", "true") for c in ("true", "false"))
SHARD_UNITS = tuple(u[:3] + ("true",) for u in UNITS)


def _pad8(x: int) -> int:
    return ((x + 7) // 8) * 8


class Layout(NamedTuple):
    """Row (and task-column) offsets of the packed buffers.  The field
    order is also the order of the layout fields in the C struct
    ``SolveArgs`` of csrc/solve_session.cu (tests compare the two)."""
    # node_int rows
    idle: int
    rel: int
    used: int
    cnt: int
    cap: int
    exists: int
    ni_rows: int
    # task_data columns: [req][res][ports][aff][anti][match][paffw][pantiw]
    req: int
    res: int
    ports: int
    aff: int
    anti: int
    match: int
    paffw: int
    pantiw: int
    task_width: int
    # jsta rows
    jstart: int
    jcount: int
    jqueue: int
    jmin: int
    jprio: int
    jts: int
    juid: int
    jsta_rows: int
    # jdyn rows
    jalloc: int
    jptr: int
    jready: int
    jact: int
    jdyn_rows: int
    # qsta rows
    qts: int
    quid: int
    qexists: int
    qdesf: int
    qsta_rows: int
    # qdes rows (deserved dims start at row 0)
    qdes_rows: int
    # qdyn rows
    qalloc: int
    qact: int
    qdyn_rows: int


def layout(r: int, np_pad: int, ns_pad: int) -> Layout:
    """The one table of buffer offsets for R resource dims and NP/NS
    port and selector columns."""
    ports = 2 * r
    aff = ports + np_pad
    anti = aff + ns_pad
    match = anti + ns_pad
    paffw = match + ns_pad
    pantiw = paffw + ns_pad
    return Layout(
        idle=0, rel=r, used=2 * r, cnt=3 * r, cap=3 * r + 1,
        exists=3 * r + 2, ni_rows=_pad8(3 * r + 3),
        req=0, res=r, ports=ports, aff=aff, anti=anti, match=match,
        paffw=paffw, pantiw=pantiw, task_width=pantiw + ns_pad,
        jstart=0, jcount=1, jqueue=2, jmin=3, jprio=4, jts=5, juid=6,
        jsta_rows=8,
        jalloc=0, jptr=r, jready=r + 1, jact=r + 2, jdyn_rows=_pad8(r + 3),
        qts=0, quid=1, qexists=2, qdesf=3, qsta_rows=_pad8(3 + r),
        qdes_rows=_pad8(r),
        qalloc=0, qact=r, qdyn_rows=_pad8(r + 1))


class ClusterPlan(NamedTuple):
    """How one launch spreads a session over a thread-block cluster.  The
    fields from ``cluster`` to ``smem_bytes`` are launch arguments, in the
    order of the C struct ``SolveArgs``."""
    cluster: int      # CTAs in the cluster
    slice: int        # nodes per CTA; CTA k owns [k*slice, (k+1)*slice)
    rows: int         # node rows the kernel keeps per node
    smem_rows: int    # how many of them (the first) are in shared memory
    jsta_smem: bool   # the static job rows the pops read, in shared memory
    jwork_smem: bool  # the CTA's copy of the job dynamic rows
    queue_smem: bool  # the queue piece (static rows and the CTA's copy)
    smem_bytes: int   # dynamic shared memory per CTA
    scratch_ints: int  # global int32 scratch for what is not on chip

    def slices(self, n: int):
        """Each CTA's node range [lo, hi)."""
        return [(min(n, k * self.slice), min(n, (k + 1) * self.slice))
                for k in range(self.cluster)]


def node_rows(r: int, np_use: int, ns_use: int) -> int:
    """Node rows the kernel keeps for each node: idle, releasing and used
    per dim, count, cap, two grid-score capacities, the current
    signature's feasibility bit and bonus, then the port and selector rows
    the conf uses."""
    return 3 * r + 6 + np_use + ns_use


def cluster_plan(n: int, r: int, np_use: int, ns_use: int,
                 dtype: torch.dtype, jdim: int, qdim: int,
                 max_cluster: int = CLUSTER_SIZES[-1]) -> ClusterPlan:
    """The smallest cluster in CLUSTER_SIZES, at most ``max_cluster``,
    whose slice is at most SLICE_NODES (or the largest such cluster) and
    whose CTAs hold all the session's state in shared memory: the queue
    piece, their node slice's rows, their job copy and the static job
    rows.  Where none does, the largest cluster, with as much on chip as
    fits in this order: the queue piece, node rows (a prefix), job copy,
    static job rows; the rest lives in the global scratch and solves
    through the same code.  ``np_use``/``ns_use`` are the port and
    selector rows the conf reads (0 when it switches them off);
    ``max_cluster`` is the largest cluster the card hosts."""
    sizes = [c for c in CLUSTER_SIZES if c <= max_cluster]
    if not sizes:
        raise ValueError(f"no cluster size in {CLUSTER_SIZES} is at most "
                         f"{max_cluster}")
    lay = layout(r, np_use, ns_use)
    rows = node_rows(r, np_use, ns_use)
    fbytes = 4 if dtype == torch.float32 else 8
    warps = THREADS // 32
    js = (lay.juid + 1) * jdim * fbytes
    # job piece: dynamic copy and DRF shares (4 bytes each)
    jpiece = (lay.jact + 2) * jdim
    jw = jpiece * 4
    # the queue piece: static queue rows (float key type), dynamic copy,
    # job cache [Q, warps], queue shares and deserved quanta (4 bytes
    # each); off chip, the CTA's dynamic copy, job cache and shares live
    # in the scratch and the static rows are read where they are
    queue = ((lay.qdesf + r) * qdim * fbytes
             + (lay.qact + 2 + warps + r) * qdim * 4)
    qpiece = (lay.qact + 2 + warps) * qdim

    def fixed(c):
        # exchange slots and mbarriers (two parities), task buffer and
        # pop result
        return c * 2 * warps * 8 + 2 * 8 + 72 * 4

    def plan(c, slice_, smem_rows, js_in, jw_in, q_in, used):
        return ClusterPlan(c, slice_, rows, smem_rows, js_in, jw_in, q_in,
                           used, rows * n + c * jpiece
                           + (0 if q_in else c * qpiece))

    for c in sizes:
        slice_ = -(-n // c)
        need = fixed(c) + queue + js + rows * slice_ * 4 + jw
        if need <= SMEM_PER_CTA and (slice_ <= SLICE_NODES
                                     or c == sizes[-1]):
            return plan(c, slice_, rows, True, True, True, need)
    c = sizes[-1]
    slice_ = -(-n // c)
    used = fixed(c)
    q_in = used + queue <= SMEM_PER_CTA
    used += queue if q_in else 0
    smem_rows = min(rows, (SMEM_PER_CTA - used) // (slice_ * 4))
    used += smem_rows * slice_ * 4
    jw_in = used + jw <= SMEM_PER_CTA
    used += jw if jw_in else 0
    js_in = used + js <= SMEM_PER_CTA
    used += js if js_in else 0
    return plan(c, slice_, smem_rows, js_in, jw_in, q_in, used)


def plan_of(inp: SolverInputs, cfg: SolverConfig,
            max_cluster: int = CLUSTER_SIZES[-1]) -> ClusterPlan:
    """The cluster plan for ``inp`` under ``cfg`` with clusters of at most
    ``max_cluster`` CTAs."""
    lay = _layout_of(inp)
    uses_sel = cfg.has_pod_affinity or cfg.has_pod_affinity_score
    return cluster_plan(
        inp.node_idle.shape[0], inp.task_req.shape[1],
        lay.aff - lay.ports if cfg.has_ports else 0,
        lay.anti - lay.aff if uses_sel else 0, inp.job_ts.dtype,
        inp.job_start.shape[0], inp.queue_deserved.shape[0],
        max_cluster)


class Buffers(NamedTuple):
    """The reference's ``_build_buffers`` outputs, in its order."""
    node_int: torch.Tensor
    node_cs: torch.Tensor
    jsta: torch.Tensor
    jdyn: torch.Tensor
    qdes: torch.Tensor
    qsta: torch.Tensor
    qdyn: torch.Tensor


class FinalState(NamedTuple):
    """The buffers a solve updates, as they stand when it ends."""
    node_int: torch.Tensor
    jdyn: torch.Tensor
    qdyn: torch.Tensor
    nport: torch.Tensor
    nsel: torch.Tensor


def _layout_of(inp: SolverInputs) -> Layout:
    return layout(inp.task_req.shape[1], inp.task_ports.shape[1],
                  inp.task_aff_req.shape[1])


def build_buffers(inp: SolverInputs) -> Buffers:
    """Fresh node, job and queue buffers for one solve.  Every tensor is
    newly allocated: the solve writes into them, never into the
    shipper's resident leaves (the delta baseline)."""
    lay = _layout_of(inp)
    r = inp.task_req.shape[1]
    n = inp.node_idle.shape[0]
    jdim = inp.job_start.shape[0]
    qdim = inp.queue_deserved.shape[0]
    fdt = inp.job_ts.dtype
    dev = inp.node_idle.device
    i32 = torch.int32

    node_int = torch.zeros((lay.ni_rows, n), dtype=i32, device=dev)
    node_int[lay.idle:lay.idle + r] = inp.node_idle.T
    node_int[lay.rel:lay.rel + r] = inp.node_releasing.T
    node_int[lay.used:lay.used + r] = inp.node_used.T
    node_int[lay.cnt] = inp.node_count
    node_int[lay.cap] = inp.node_max_tasks
    node_int[lay.exists] = inp.node_exists.to(i32)

    alloc = inp.node_alloc.to(i32)
    node_cs = torch.zeros((8, n), dtype=i32, device=dev)
    for d in range(2):
        node_cs[d] = torch.bitwise_right_shift(alloc[:, d],
                                               inp.score_shift[d].to(i32))

    jsta = torch.zeros((lay.jsta_rows, jdim), dtype=fdt, device=dev)
    for row, leaf in ((lay.jstart, inp.job_start),
                      (lay.jcount, inp.job_count),
                      (lay.jqueue, inp.job_queue),
                      (lay.jmin, inp.job_minavail),
                      (lay.jprio, inp.job_prio), (lay.jts, inp.job_ts),
                      (lay.juid, inp.job_uid_rank)):
        jsta[row] = leaf.to(fdt)

    job_queue = inp.job_queue.long()
    jdyn = torch.zeros((lay.jdyn_rows, jdim), dtype=i32, device=dev)
    jdyn[lay.jalloc:lay.jalloc + r] = inp.job_init_alloc.T
    jdyn[lay.jready] = inp.job_init_ready
    jdyn[lay.jact] = (inp.queue_exists[job_queue]
                      & (inp.job_minavail >= 0)).to(i32)

    qdes = torch.zeros((lay.qdes_rows, qdim), dtype=i32, device=dev)
    qdes[:r] = inp.queue_deserved.T
    qsta = torch.zeros((lay.qsta_rows, qdim), dtype=fdt, device=dev)
    qsta[lay.qts] = inp.queue_ts.to(fdt)
    qsta[lay.quid] = inp.queue_uid_rank.to(fdt)
    qsta[lay.qexists] = inp.queue_exists.to(fdt)
    qsta[lay.qdesf:lay.qdesf + r] = inp.queue_deserved_f.T.to(fdt)

    queue_active = torch.zeros(qdim, dtype=torch.bool, device=dev)
    queue_active[job_queue] = True
    qdyn = torch.zeros((lay.qdyn_rows, qdim), dtype=i32, device=dev)
    qdyn[lay.qalloc:lay.qalloc + r] = inp.queue_init_alloc.T
    qdyn[lay.qact] = (queue_active & inp.queue_exists).to(i32)
    return Buffers(node_int, node_cs, jsta, jdyn, qdes, qsta, qdyn)


class Operands(NamedTuple):
    """Everything one solve reads or writes, as the kernel takes it."""
    lay: Layout
    bufs: Buffers
    task_data: torch.Tensor  # [P, task_width] i32
    task_sig: torch.Tensor   # [P] i32
    sig_mask: torch.Tensor   # [S, N] float
    sig_bonus: torch.Tensor  # [S, N] i32
    nport: torch.Tensor      # [NP, N] i32, updated in place
    nsel: torch.Tensor       # [NS, N] i32, updated in place
    total: torch.Tensor      # [R] float
    score_shift: torch.Tensor  # [2] i32


def _fresh_i32_t(x: torch.Tensor) -> torch.Tensor:
    """A new contiguous int32 copy of x transposed (never a view of x)."""
    return x.T.to(torch.int32).clone(memory_format=torch.contiguous_format)


def _operands(inp: SolverInputs) -> Operands:
    lay = _layout_of(inp)
    fdt = inp.job_ts.dtype
    task_data = torch.cat(
        [x.to(torch.int32) for x in (
            inp.task_req, inp.task_res, inp.task_ports, inp.task_aff_req,
            inp.task_anti, inp.task_match, inp.task_paff_w,
            inp.task_panti_w)], dim=1).contiguous()
    return Operands(
        lay=lay, bufs=build_buffers(inp), task_data=task_data,
        task_sig=inp.task_sig.to(torch.int32).contiguous(),
        sig_mask=inp.sig_mask.to(fdt).contiguous(),
        sig_bonus=inp.sig_bonus.to(torch.int32).contiguous(),
        nport=_fresh_i32_t(inp.node_ports), nsel=_fresh_i32_t(inp.node_selcnt),
        total=inp.total_res.to(fdt).contiguous(),
        score_shift=inp.score_shift.to(torch.int32).contiguous())


_JOB_KEYS = {"priority": 1, "gang": 2, "drf": 3}
_QUEUE_KEYS = {"proportion": 1}


def _key_codes(order, codes, slots: int):
    """The conf's known order keys in tier order, first occurrence only
    (a repeated key cannot change a lexicographic order), padded with 0."""
    out = []
    for name in order:
        c = codes.get(name)
        if c is not None and c not in out:
            out.append(c)
    return out + [0] * (slots - len(out))


def _weight_args(cfg: SolverConfig):
    w = cfg.weights
    vals = (int(w.least_requested) * 5, int(w.most_requested) * 5,
            int(w.balanced_resource))
    for v in vals:
        if not -2 ** 31 <= v < 2 ** 31:
            raise ValueError(f"score weights {w} overflow int32")
    return vals


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------

def _i32(x: int) -> int:
    """Python int wrapped to int32, as XLA and the kernel wrap."""
    return ((int(x) + 2 ** 31) % 2 ** 32) - 2 ** 31


def _lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 lanes (jax.lax.shift_right_logical)."""
    return ((x.to(torch.int64) & 0xFFFFFFFF) >> s).to(torch.int32)


def solve_allocate_plain(inp: SolverInputs, cfg: SolverConfig):
    """The kernel's plain PyTorch version: the same session solve over the
    same buffers, one torch op at a time, with the control state in
    Python ints.  Returns (SolveResult, FinalState)."""
    return _solve_blocks([_operands(inp)], cfg)


def _solve_blocks(blocks, cfg: SolverConfig):
    """The plain session solve over the node blocks ``blocks`` (Operands,
    each holding a contiguous node slice, in node order; the first one's
    task, job and queue buffers carry the session).  One block is the
    single-device solve.  With several (the sharded plain version,
    parallel/sharded_solver.py), each placement takes every block's local
    first max and reduces them as the reference's mesh does: the max of
    the scores (pmax), then the min of the word ``(global index << 2) |
    (fit_idle << 1) | fit_rel`` among the blocks at that max (pmin), so
    ties break on the global first index; only the owning block's node
    state is updated.  The FinalState's node rows are the blocks'
    concatenated on the first block's device."""
    ops = blocks[0]
    lay, (_, _, jsta, jdyn, qdes, qsta, qdyn) = ops.lay, ops.bufs
    r = ops.total.shape[0]
    np_pad = lay.aff - lay.ports
    ns_pad = lay.anti - lay.aff
    sizes = [b.bufs.node_int.shape[1] for b in blocks]
    offsets = [sum(sizes[:k]) for k in range(len(blocks))]
    n_total = sum(sizes)
    jdim = jsta.shape[1]
    qdim = qsta.shape[1]
    p = ops.task_data.shape[0]
    n_sig = ops.sig_mask.shape[0]
    dev = jsta.device
    fdt = jsta.dtype
    inf = torch.tensor(float("inf"), dtype=fdt, device=dev)
    col_j = torch.arange(jdim, device=dev)
    col_q = torch.arange(qdim, device=dev)
    w_least5, w_most5, w_bal = _weight_args(cfg)
    shifts = [int(s) for s in ops.score_shift.tolist()]
    task_host = ops.task_data.cpu().numpy()
    sig_host = ops.task_sig.cpu().numpy()
    out = np.zeros((p, 4), np.int32)
    out[:, 0] = -1
    out[:, 2] = -1
    ndyn = 3 * r + 1

    def lex_first_index(mask, keys, col, dim) -> int:
        m = mask
        for k in keys:
            kv = torch.where(m, k, inf)
            m = m & (kv == torch.min(kv))
        return int(torch.min(torch.where(m, col, dim)))

    def queue_share_row():
        share = torch.zeros(qdim, dtype=torch.float32, device=dev)
        for i in range(r):
            share = torch.maximum(share, safe_share(
                qdyn[lay.qalloc + i], qsta[lay.qdesf + i]))
        return share.to(fdt)

    def drf_share_row():
        share = torch.zeros(jdim, dtype=torch.float32, device=dev)
        for i in range(r):
            share = torch.maximum(share, safe_share(
                jdyn[lay.jalloc + i], ops.total[i]))
        return share.to(fdt)

    def scan(block, row, req, res, sig):
        """The block's local first max: (best score, local index, the
        node's fit-idle and fit-releasing bits) as Python ints."""
        nint, ncs = block.bufs.node_int, block.bufs.node_cs
        nport, nsel_rows = block.nport, block.nsel
        n = nint.shape[1]
        bdev = nint.device
        fit_idle = fit_rel = None
        for i in range(r):
            mi = nint[lay.idle + i]
            mr = nint[lay.rel + i]
            oki = (req[i] < mi) | (torch.abs(req[i] - mi) < EPS_QUANTA)
            okr = (req[i] < mr) | (torch.abs(req[i] - mr) < EPS_QUANTA)
            if i >= 2 and req[i] <= EPS_QUANTA:
                oki = okr = torch.ones_like(oki)
            fit_idle = oki if fit_idle is None else fit_idle & oki
            fit_rel = okr if fit_rel is None else fit_rel & okr

        feasible = ((block.sig_mask[sig] > 0.5) & (nint[lay.exists] > 0)
                    & (nint[lay.cnt] < nint[lay.cap])
                    & (fit_idle | fit_rel))
        if cfg.has_ports:
            for i in range(np_pad):
                if row[lay.ports + i] > 0:
                    feasible = feasible & ~(nport[i] > 0)
        if cfg.has_pod_affinity:
            for s in range(ns_pad):
                have = nsel_rows[s] > 0
                if row[lay.aff + s] > 0:
                    feasible = feasible & have
                if row[lay.anti + s] > 0:
                    feasible = feasible & ~have

        g = []
        for d in range(2):
            cs = ncs[d]
            xs = torch.minimum(
                _lshr(nint[lay.used + d] + res[d], shifts[d]), cs)
            qv = ((xs * SCORE_GRID_K).to(fdt)
                  / torch.clamp(cs, min=1).to(fdt)).to(torch.int32)
            g.append(torch.where(cs == 0, SCORE_GRID_K, qv))
        gc, gm = g
        score = torch.zeros(n, dtype=torch.int32, device=bdev)
        if w_least5:
            score = score + w_least5 * (2 * SCORE_GRID_K - gc - gm)
        if w_most5:
            score = score + w_most5 * (gc + gm)
        if w_bal:
            score = score + w_bal * (10 * SCORE_GRID_K
                                     - 10 * torch.abs(gc - gm))
        if cfg.has_pod_affinity_score:
            for s in range(ns_pad):
                wd = _i32(int(row[lay.paffw + s])
                          - int(row[lay.pantiw + s]))
                score = score + _i32(SCORE_GRID_K * wd) * nsel_rows[s]
        score = score + block.sig_bonus[sig]
        score = torch.where(feasible, score, SCORE_NEG_INF)

        best = torch.max(score)
        pick = torch.min(torch.where(
            score == best, torch.arange(n, device=bdev), n))
        return torch.stack([best.long(), pick, fit_idle[pick].long(),
                            fit_rel[pick].long()]).tolist()

    def first_max(row, req, res, sig):
        """(best, global index, fit_idle, fit_rel) over every block: the
        reference's pmax of the scores, then pmin of the packed word."""
        local = [scan(b, row, req, res, sig) for b in blocks]
        best = max(v[0] for v in local)
        word = min(((off + v[1]) << 2) | (v[2] << 1) | v[3]
                   if v[0] == best else (n_total << 2) | 3
                   for off, v in zip(offsets, local))
        return best, word >> 2, (word >> 1) & 1, word & 1

    step = 0
    while bool(torch.any(qdyn[lay.qact] > 0)):
        # ---- queue pop ----------------------------------------------------
        qkeys = [queue_share_row() for name in cfg.queue_key_order
                 if name == "proportion"]
        qkeys += [qsta[lay.qts], qsta[lay.quid]]
        q = lex_first_index(qdyn[lay.qact] > 0, qkeys, col_q, qdim)

        overused = False
        if cfg.has_proportion:
            des = qdes[:r, q].tolist() if q < qdim else [0] * r
            alc = (qdyn[lay.qalloc:lay.qalloc + r, q].tolist() if q < qdim
                   else [0] * r)
            overused = True
            for i in range(r):
                ok = des[i] < alc[i] or _i32(abs(_i32(des[i] - alc[i]))) \
                    < EPS_QUANTA
                if i >= 2:
                    ok = ok or des[i] <= EPS_QUANTA
                overused = overused and ok

        # ---- job pop ------------------------------------------------------
        j_active = (jdyn[lay.jact] > 0) & (jsta[lay.jqueue] == float(q))
        jkeys = []
        for name in cfg.job_key_order:
            if name == "priority":
                jkeys.append(-jsta[lay.jprio])
            elif name == "gang":
                jkeys.append((jdyn[lay.jready].to(fdt)
                              >= jsta[lay.jmin]).to(fdt))
            elif name == "drf":
                jkeys.append(drf_share_row())
        jkeys += [jsta[lay.jts], jsta[lay.juid]]
        j = lex_first_index(j_active, jkeys, col_j, jdim)
        has_job = j < jdim
        retire = overused or not has_job

        start = count = minavail = ptr = ready_cnt = 0
        if has_job:
            start, count, minavail = (
                int(v) for v in jsta[[lay.jstart, lay.jcount, lay.jmin],
                                     j].tolist())
            ptr, ready_cnt = jdyn[[lay.jptr, lay.jready], j].tolist()
        count_j = 0 if retire else count

        # ---- drain the popped job ----------------------------------------
        done = survive = False
        dstep = step
        dres = [0] * r
        while not done:
            exhausted = ptr >= count_j
            t = min(max(_i32(start + ptr), 0), p - 1)
            row = task_host[t]
            req = [int(v) for v in row[lay.req:lay.req + r]]
            res = [int(v) for v in row[lay.res:lay.res + r]]
            sig = min(max(int(sig_host[t]), 0), n_sig - 1)

            best, pick, fi, fr = first_max(row, req, res, sig)
            feasible_any = best > SCORE_NEG_INF

            placing = not exhausted and feasible_any
            alloc_ok = placing and bool(fi)
            pipe_ok = placing and not fi and bool(fr)
            placed = alloc_ok or pipe_ok
            if placed:
                k = max(i for i, off in enumerate(offsets) if off <= pick)
                owner, local = blocks[k], pick - offsets[k]
                bdev = owner.bufs.node_int.device
                delta = ([-res[i] if alloc_ok else 0 for i in range(r)]
                         + [-res[i] if pipe_ok else 0 for i in range(r)]
                         + res + [1])
                owner.bufs.node_int[:ndyn, local] += torch.tensor(
                    [_i32(v) for v in delta], dtype=torch.int32,
                    device=bdev)
                out[t] = (pick, 1 if alloc_ok else 2, dstep, 0)
                if cfg.has_ports:
                    owner.nport[:, local] |= torch.as_tensor(
                        row[lay.ports:lay.ports + np_pad], device=bdev)
                if cfg.has_pod_affinity or cfg.has_pod_affinity_score:
                    owner.nsel[:, local] += torch.as_tensor(
                        row[lay.match:lay.match + ns_pad], device=bdev)
                ptr += 1
                dstep += 1
                dres = [_i32(dres[i] + res[i]) for i in range(r)]
            if alloc_ok:
                ready_cnt += 1

            ready = ready_cnt >= minavail if cfg.has_gang else True
            remaining = ptr < count_j
            done = exhausted or not feasible_any or ready or not remaining
            survive = (not exhausted and feasible_any and ready
                       and remaining)

        # ---- write-back ---------------------------------------------------
        step = dstep
        if not retire:
            upd = torch.tensor(dres, dtype=torch.int32, device=dev)
            jdyn[lay.jalloc:lay.jalloc + r, j] += upd
            if q < qdim:
                qdyn[lay.qalloc:lay.qalloc + r, q] += upd
            jdyn[lay.jptr, j] = ptr
            jdyn[lay.jready, j] = ready_cnt
            jdyn[lay.jact, j] = int(survive)
        elif q < qdim:
            qdyn[lay.qact, q] = 0

    out_t = torch.from_numpy(out).to(dev)
    result = SolveResult(assignment=out_t[:, 0], kind=out_t[:, 1],
                         order=out_t[:, 2],
                         step=torch.tensor(step, dtype=torch.int32,
                                           device=dev))

    def joined(rows):
        return torch.cat([x.to(dev) for x in rows], dim=1) \
            if len(rows) > 1 else rows[0]

    return result, FinalState(joined([b.bufs.node_int for b in blocks]),
                              jdyn, qdyn, joined([b.nport for b in blocks]),
                              joined([b.nsel for b in blocks]))


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_POINTER_FIELDS = ("node_int", "node_cs", "task_data", "task_sig",
                   "sig_mask", "sig_bonus", "jsta", "jdyn", "qsta", "qdes",
                   "qdyn", "nport", "nsel", "total", "score_shift", "out",
                   "steps", "stamps", "scratch", "xchg")
_SHAPE_FIELDS = ("n", "p", "jdim", "qdim", "r", "np_pad", "ns_pad", "n_sig")
_PLAN_FIELDS = ClusterPlan._fields[:ClusterPlan._fields.index("smem_bytes") + 1]
_CONFIG_FIELDS = ("w_least5", "w_most5", "w_bal", "has_gang",
                  "has_proportion", "has_ports", "has_pod_affinity",
                  "has_pod_affinity_score", "job_key0", "job_key1",
                  "job_key2", "queue_key0")
# Shard mode's launch arguments (solve_allocate_cuda_sharded): the
# shard's index, the shard count, its first global node, the solve's
# epoch (tags its exchange slots) and the spin's bound in milliseconds.
_SHARD_FIELDS = ("shard", "shards", "node_off", "epoch", "spin_ms")


# The kernel's phase stamps, in slot order: cycles of thread 0 in each
# phase, then the counts of placements (node scans) and pops, then the
# cycles of the whole launch, then (shard mode only) the cycles of the
# cross-shard exchange.
PHASES = ("queue_pop", "job_pop", "node_scan", "cta_reduce",
          "cluster_exchange", "owner_update", "write_back", "placements",
          "pops", "total", "shard_exchange")


class SolveArgs(ctypes.Structure):
    """Mirror of ``struct SolveArgs`` in csrc/solve_session.cu: device
    pointers, shapes, the cluster plan, the conf as launch arguments, then
    the Layout."""
    _fields_ = ([(f, ctypes.c_void_p) for f in _POINTER_FIELDS]
                + [(f, ctypes.c_int32) for f in
                   _SHAPE_FIELDS + _PLAN_FIELDS + _CONFIG_FIELDS
                   + _SHARD_FIELDS + Layout._fields])


class _Kernel:
    """The loaded library and how this process came by it.  ``lock``
    guards the check-and-set of ``lib``: a warmup thread and the
    scheduler thread that reach the first build together share one
    ``nvcc`` run (ops/compile_cache.py starts the warmup at boot)."""
    lib = None
    build_seconds = None
    build_log = ""
    # True when this process ran nvcc, False when it loaded a library
    # an earlier build left in the build directory; None before either.
    built = None
    path = None
    # Where the libraries are looked for and built; None is BUILD_DIR
    # (``set_build_dir``, the compile cache's directory).
    build_dir = None
    lock = threading.Lock()
    stem, units, entry = "libsolve_session", UNITS, ()


class _ShardKernel:
    """The same for shard mode's library (``build_shard_kernel``); it is
    looked for and built in ``_Kernel.build_dir``."""
    lib = None
    build_seconds = None
    build_log = ""
    built = None
    path = None
    lock = threading.Lock()
    stem, units, entry = ("libsolve_session_shard", SHARD_UNITS,
                          ("-DKBT_ENTRY_SHARD",))


def kernel_tag(which=_Kernel) -> str:
    """A library's key: a hash of the kernel's source, its flags and its
    units."""
    src = _SRC.read_bytes()
    how = repr((NVCC_FLAGS, LINK_FLAGS, which.units) + (
        (which.entry,) if which.entry else ())).encode()
    return hashlib.sha256(src + how).hexdigest()[:16]


def _unit_flags(unit) -> list:
    t, stamp, chip, shard = unit
    return [f"-DKBT_UNIT_T={t}", f"-DKBT_UNIT_STAMP={stamp}",
            f"-DKBT_UNIT_CHIP={chip}", f"-DKBT_UNIT_SHARD={shard}"]


def _compile(nvcc: str, so: Path, tmp: Path, which=_Kernel) -> str:
    """nvcc's units of csrc/solve_session.cu for ``which`` library, all
    at once (one thread each), then one link into ``tmp``; returns their
    ptxas reports.  Raises on the first failed step."""
    from concurrent.futures import ThreadPoolExecutor
    units = which.units
    objs = [tmp.with_name(f"{tmp.name}.{i}.o")
            for i in range(len(units) + 1)]
    argvs = [[nvcc, *NVCC_FLAGS, *_unit_flags(unit), "-c", "-o", str(obj),
              str(_SRC)] for unit, obj in zip(units, objs)]
    argvs.append([nvcc, *NVCC_FLAGS, *which.entry, "-c", "-o",
                  str(objs[-1]), str(_SRC)])
    try:
        with ThreadPoolExecutor(len(argvs)) as pool:
            procs = list(pool.map(lambda argv: subprocess.run(
                argv, capture_output=True, text=True, check=False), argvs))
        for argv, proc in zip(argvs, procs):
            if proc.returncode != 0:
                unit = " ".join(a for a in argv if a.startswith("-DKBT"))
                raise RuntimeError(f"nvcc failed on {_SRC} "
                                   f"({unit or 'entry unit'}):\n"
                                   f"{proc.stderr}")
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {so.name}:\n"
                               f"{link.stderr}")
    finally:
        for obj in objs:
            if obj.exists():
                obj.unlink()
    return "".join(proc.stderr for proc in procs)


def library_path(build_dir=None, which=_Kernel) -> Path:
    """Where ``which`` library of this source and these flags lives
    (ptxas' report of its build beside it, ``.ptxas.txt``)."""
    root = Path(build_dir or _Kernel.build_dir or BUILD_DIR)
    return root / f"{which.stem}_{kernel_tag(which)}.so"


def _log_path(so: Path) -> Path:
    return so.with_name(so.name + ".ptxas.txt")


def _publish(src: Path, dest: Path) -> None:
    """Copy ``src`` to ``dest`` through a temporary file named after the
    process and the thread, then ``os.replace``: a reader never loads a
    half-written library."""
    tmp = dest.with_name(
        f"{dest.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        shutil.copyfile(src, tmp)
        os.replace(tmp, dest)
    finally:
        if tmp.exists():
            tmp.unlink()


def set_build_dir(path) -> Path:
    """Make ``path`` the directory where ``build_kernel`` looks for the
    library and builds it.  A library already loaded in this process
    stays loaded; it is copied into ``path`` (when ``path`` lacks it) so
    the next process that points there loads it without nvcc."""
    root = Path(path).resolve()
    root.mkdir(parents=True, exist_ok=True)
    with _Kernel.lock, _ShardKernel.lock:
        _Kernel.build_dir = root
        for which in (_Kernel, _ShardKernel):
            loaded = which.path
            dest = library_path(root, which)
            if loaded is None or Path(loaded) == dest or dest.exists():
                continue
            if _log_path(Path(loaded)).exists():
                _publish(_log_path(Path(loaded)), _log_path(dest))
            _publish(Path(loaded), dest)
            log.warning("the kernel library was loaded from %s before %s "
                        "became the build directory; copied it there for "
                        "the next boot", loaded, root)
    return root


def build_kernel() -> ctypes.CDLL:
    """Compile csrc/solve_session.cu with nvcc into the build directory
    (once per source content; its UNITS in parallel, then a link) and
    load it.  Raises when nvcc or the build fails.  Thread-safe:
    concurrent first callers share one build."""
    return _build(_Kernel)


def build_shard_kernel() -> ctypes.CDLL:
    """``build_kernel`` for shard mode's library (SHARD_UNITS), which
    only a sharded solve loads."""
    return _build(_ShardKernel)


def _build(which) -> ctypes.CDLL:
    lib = which.lib
    if lib is not None:
        return lib
    with which.lock:
        if which.lib is not None:
            return which.lib
        so = library_path(which=which)
        began = time.perf_counter()
        built = False
        if not so.exists():
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            if not os.path.exists(nvcc):
                raise RuntimeError("nvcc not found: the CUDA toolkit is "
                                   "needed to build csrc/solve_session.cu")
            so.parent.mkdir(parents=True, exist_ok=True)
            # Named after the process and the thread: two builds never
            # write one temporary file, and os.replace publishes whole.
            tmp = so.with_name(
                f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            try:
                which.build_log = _compile(nvcc, so, tmp, which)
                _log_path(tmp).write_text(which.build_log)
                os.replace(_log_path(tmp), _log_path(so))
                os.replace(tmp, so)
            finally:
                for left in (tmp, _log_path(tmp)):
                    if left.exists():
                        left.unlink()
            built = True
        elif _log_path(so).exists():
            which.build_log = _log_path(so).read_text()
        lib = ctypes.CDLL(str(so))
        lib.kbt_solve_session.argtypes = [ctypes.POINTER(SolveArgs),
                                          ctypes.c_int, ctypes.c_void_p]
        lib.kbt_solve_session.restype = ctypes.c_int
        lib.kbt_cluster_capacity.argtypes = [ctypes.POINTER(SolveArgs),
                                             ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int)]
        lib.kbt_cluster_capacity.restype = ctypes.c_int
        lib.kbt_error_string.argtypes = [ctypes.c_int]
        lib.kbt_error_string.restype = ctypes.c_char_p
        if which is _ShardKernel:
            lib.kbt_xchg_alloc.argtypes = [ctypes.c_size_t,
                                           ctypes.POINTER(ctypes.c_void_p),
                                           ctypes.POINTER(ctypes.c_void_p)]
            lib.kbt_xchg_alloc.restype = ctypes.c_int
            lib.kbt_stream_create.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
            lib.kbt_stream_create.restype = ctypes.c_int
        which.build_seconds = time.perf_counter() - began
        which.built = built
        which.path = so
        which.lib = lib
    return lib


def _check_operands(ops: Operands, dev: torch.device) -> None:
    lay, bufs = ops.lay, ops.bufs
    r = ops.total.shape[0]
    if r < 1:
        raise ValueError(f"the kernel takes at least one resource dim, "
                         f"got {r}")
    fdt = bufs.jsta.dtype
    if fdt not in (torch.float32, torch.float64):
        raise ValueError(f"float key dtype must be float32 or float64, "
                         f"got {fdt}")
    n = bufs.node_int.shape[1]
    if n >= 2 ** 30 or ops.task_data.shape[0] < 1:
        raise ValueError(f"unsupported shape: N={n}, "
                         f"P={ops.task_data.shape[0]}")
    expect = {
        "node_int": (bufs.node_int, torch.int32, (lay.ni_rows, n)),
        "node_cs": (bufs.node_cs, torch.int32, (8, n)),
        "jsta": (bufs.jsta, fdt, (lay.jsta_rows, bufs.jsta.shape[1])),
        "jdyn": (bufs.jdyn, torch.int32, (lay.jdyn_rows, bufs.jsta.shape[1])),
        "qdes": (bufs.qdes, torch.int32, (lay.qdes_rows, bufs.qsta.shape[1])),
        "qsta": (bufs.qsta, fdt, (lay.qsta_rows, bufs.qsta.shape[1])),
        "qdyn": (bufs.qdyn, torch.int32, (lay.qdyn_rows, bufs.qsta.shape[1])),
        "task_data": (ops.task_data, torch.int32,
                      (ops.task_data.shape[0], lay.task_width)),
        "task_sig": (ops.task_sig, torch.int32, (ops.task_data.shape[0],)),
        "sig_mask": (ops.sig_mask, fdt, (ops.sig_mask.shape[0], n)),
        "sig_bonus": (ops.sig_bonus, torch.int32, tuple(ops.sig_mask.shape)),
        "nport": (ops.nport, torch.int32, (lay.aff - lay.ports, n)),
        "nsel": (ops.nsel, torch.int32, (lay.anti - lay.aff, n)),
        "total": (ops.total, fdt, (lay.res,)),
        "score_shift": (ops.score_shift, torch.int32, (2,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: the kernel takes a contiguous {dtype} {shape} "
                f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    if ops.sig_mask.shape[0] < 1:
        raise ValueError("sig_mask needs at least one signature row")


# Clusters the card can run at once for a plan, by (plan, float64, R):
# asked of the card once per plan (``hostable_plan``).
_CAPACITY: dict = {}


def _launch_args(ops: Operands, cfg: SolverConfig, plan: ClusterPlan,
                 tensors: dict, shard: tuple = (0, 1, 0, 0, 0)) -> SolveArgs:
    """The launch arguments; ``shard`` is (shard, shards, node_off,
    epoch, spin_ms), the single-device solve's by default."""
    lay, bufs = ops.lay, ops.bufs
    w_least5, w_most5, w_bal = _weight_args(cfg)
    job_keys = _key_codes(cfg.job_key_order, _JOB_KEYS, 3)
    (queue_key,) = _key_codes(cfg.queue_key_order, _QUEUE_KEYS, 1)
    return SolveArgs(
        *[None if tensors.get(f) is None else tensors[f].data_ptr()
          for f in _POINTER_FIELDS],
        n=bufs.node_int.shape[1], p=ops.task_data.shape[0],
        jdim=bufs.jsta.shape[1], qdim=bufs.qsta.shape[1],
        r=ops.total.shape[0], np_pad=lay.aff - lay.ports,
        ns_pad=lay.anti - lay.aff, n_sig=ops.sig_mask.shape[0],
        **{f: int(getattr(plan, f)) for f in _PLAN_FIELDS},
        w_least5=w_least5, w_most5=w_most5, w_bal=w_bal,
        has_gang=bool(cfg.has_gang),
        has_proportion=bool(cfg.has_proportion),
        has_ports=bool(cfg.has_ports),
        has_pod_affinity=bool(cfg.has_pod_affinity),
        has_pod_affinity_score=bool(cfg.has_pod_affinity_score),
        job_key0=job_keys[0], job_key1=job_keys[1], job_key2=job_keys[2],
        queue_key0=queue_key, **dict(zip(_SHARD_FIELDS, shard)),
        **lay._asdict())


def hostable_plan(inp: SolverInputs, cfg: SolverConfig, ops: Operands,
                  max_cluster: int = CLUSTER_SIZES[-1],
                  need: int = 1, shards: int = 1) -> ClusterPlan:
    """The plan of ``plan_of`` under the largest cluster bound, at most
    ``max_cluster``, of which the card can host ``need`` clusters at once
    at that plan's shared memory (``cudaOccupancyMaxActiveClusters`` in
    the bound library, asked once per plan).  A card or partition that
    cannot host 16 CTAs gets the 8-CTA plan, with more rows in global
    memory.  Shard mode (``shards`` > 1, asked of its own library) asks
    for one cluster per shard on the card: its shards spin on each other,
    so they must all be resident at once.  Raises when not even ``need``
    clusters of one CTA fit."""
    lib = build_shard_kernel() if shards > 1 else build_kernel()
    f64 = int(ops.bufs.jsta.dtype == torch.float64)
    bound = max_cluster
    while True:
        plan = plan_of(inp, cfg, bound)
        key = (plan, f64, ops.total.shape[0], shards > 1)
        if key not in _CAPACITY:
            args = _launch_args(ops, cfg, plan, {},
                                shard=(0, shards, 0, 0, 0))
            got = ctypes.c_int(0)
            rc = lib.kbt_cluster_capacity(ctypes.byref(args), f64,
                                          ctypes.byref(got))
            if rc != 0:
                raise RuntimeError("cluster capacity query failed: "
                                   + lib.kbt_error_string(rc).decode())
            _CAPACITY[key] = got.value
        if _CAPACITY[key] >= need:
            return plan
        if plan.cluster == 1:
            raise RuntimeError(
                f"the card cannot host {need} cluster(s) of one CTA of "
                f"{plan.smem_bytes} B of shared memory at once (it hosts "
                f"{_CAPACITY[key]})")
        bound = plan.cluster // 2


class K1Timing:
    """Two timing events around one K1 launch on its stream, and a host
    ``perf_counter`` stamp paired with a third event recorded when the
    stream was idle, so that the launch lands on the host clock.  It
    rides the launch's result (``TimedResult``) and its PendingSolve, and
    the fetch that waits for them turns it into a ``k1.device`` span; a
    discarded handle drops it.  When the stream was busy at the pairing,
    the span is ``aligned`` false: its duration holds, its place does
    not."""

    __slots__ = ("pair", "host", "aligned", "start", "end")

    SPAN = "k1.device"

    @classmethod
    def begin(cls, stream) -> "K1Timing | None":
        """Pair the host clock with ``stream`` and record the start
        event; None, and no event created, under KUBE_BATCH_TPU_TRACE=0."""
        from ..trace import spans as trace
        if not trace.enabled():
            return None
        self = cls()
        self.pair = torch.cuda.Event(enable_timing=True)
        self.aligned = bool(stream.query())
        self.pair.record(stream)
        # After the record returns: the event goes to the idle stream at
        # the end of the call, which a profiler's callbacks can lengthen.
        self.host = time.perf_counter()
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(stream)
        return self

    def launched(self, stream) -> None:
        """Record the end event after the launch."""
        self.end = torch.cuda.Event(enable_timing=True)
        self.end.record(stream)

    def record(self) -> None:
        """The launch's ``SPAN`` span in the active session trace (host
        clock, track ``device``); ``device_ms`` is the time between its
        events.  Called by the fetch once it has waited for the solve,
        so the end event has completed."""
        from ..trace import spans as trace
        self.end.synchronize()
        device_ms = self.start.elapsed_time(self.end)
        start = self.host + self.pair.elapsed_time(self.start) / 1e3
        trace.record_span(self.SPAN, start, start + device_ms / 1e3,
                          track="device", device_ms=device_ms,
                          aligned=self.aligned)


class EvictTiming(K1Timing):
    """K1Timing around the batched eviction solve
    (ops/evict_solver.py), on its own or as the fused program's evict
    leg; the scanner records it as ``evict.device`` once the solve's
    readback has waited."""

    __slots__ = ("stream",)

    SPAN = "evict.device"

    @classmethod
    def around(cls, device) -> "EvictTiming | None":
        """Begin on the current stream of ``device``; None off the card
        (and under KUBE_BATCH_TPU_TRACE=0).  ``launched()`` then records
        the end event on the same stream."""
        if torch.device(device).type != "cuda":
            return None
        stream = torch.cuda.current_stream(device)
        self = cls.begin(stream)
        if self is not None:
            self.stream = stream
        return self

    def launched(self, stream=None) -> None:
        super().launched(self.stream if stream is None else stream)


class TimedResult(SolveResult):
    """The SolveResult of one K1 launch, with its K1Timing in
    ``timing``."""


def solve_allocate_cuda(inp: SolverInputs, cfg: SolverConfig, *,
                        stamps: torch.Tensor | None = None,
                        max_cluster: int = CLUSTER_SIZES[-1]):
    """One launch of the whole-session kernel on the current stream.
    Returns (SolveResult, FinalState) without waiting for the device.
    Raises on CPU tensors and on anything the kernel does not take.

    ``stamps``, an int64 [len(PHASES)] tensor on the device, turns on the
    kernel's clock64() phase stamps and receives them (see PHASES); the
    main path passes none and runs the kernel without them.
    ``max_cluster`` caps the cluster size below the card's own bound."""
    dev = inp.node_idle.device
    if dev.type != "cuda":
        raise ValueError("solve_allocate_cuda takes CUDA tensors; use "
                         "solve_allocate_plain for tensors on the CPU")
    for name, leaf in zip(SolverInputs._fields, inp):
        if leaf.device != dev:
            raise ValueError(f"{name} is on {leaf.device}, not {dev}")
    _weight_args(cfg)
    with torch.cuda.device(dev):
        ops = _operands(inp)
        _check_operands(ops, dev)
        bufs = ops.bufs
        p = ops.task_data.shape[0]
        out = torch.empty((p, 4), dtype=torch.int32, device=dev)
        steps = torch.empty(1, dtype=torch.int32, device=dev)
        if stamps is not None and (
                stamps.device != dev or stamps.dtype != torch.int64
                or tuple(stamps.shape) != (len(PHASES),)):
            raise ValueError(f"stamps: the kernel takes an int64 "
                             f"[{len(PHASES)}] tensor on {dev}")
        tensors = dict(zip(Buffers._fields, bufs))
        tensors.update(task_data=ops.task_data, task_sig=ops.task_sig,
                       sig_mask=ops.sig_mask, sig_bonus=ops.sig_bonus,
                       nport=ops.nport, nsel=ops.nsel, total=ops.total,
                       score_shift=ops.score_shift, out=out, steps=steps)
        plan = hostable_plan(inp, cfg, ops, max_cluster)
        tensors["stamps"] = stamps
        tensors["scratch"] = torch.empty(plan.scratch_ints,
                                         dtype=torch.int32, device=dev)
        args = _launch_args(ops, cfg, plan, tensors)
        lib = build_kernel()
        current = torch.cuda.current_stream(dev)
        stream = current.cuda_stream
        timing = K1Timing.begin(current)
        rc = lib.kbt_solve_session(ctypes.byref(args),
                                   int(bufs.jsta.dtype == torch.float64),
                                   stream)
        if rc == 0 and timing is not None:
            timing.launched(current)
    if rc != 0:
        raise RuntimeError("solve_session kernel launch failed: "
                           + lib.kbt_error_string(rc).decode())
    solve_allocate_cuda.launches += 1
    tally = solve_allocate_cuda.stream_launches
    tally[stream] = tally.get(stream, 0) + 1
    result = SolveResult(assignment=out[:, 0], kind=out[:, 1],
                         order=out[:, 2], step=steps[0])
    if timing is not None:
        result = TimedResult(*result)
        result.timing = timing
    return result, FinalState(bufs.node_int, bufs.jdyn, bufs.qdyn,
                              ops.nport, ops.nsel)


# Launches of the kernel since the count was last set to 0, and the same
# launches by the raw handle of the CUDA stream each went to (set to {}
# with the count): the shard pipeline launches each shard's solve on its
# own view's stream.
solve_allocate_cuda.launches = 0
solve_allocate_cuda.stream_launches = {}


# ---------------------------------------------------------------------------
# Shard mode: one launch per shard of the mesh, the exchange in host memory
# ---------------------------------------------------------------------------

# How long a shard spins on the exchange before it gives up (the kernel's
# %globaltimer bound): far above any exchange's wait (microseconds), and
# short enough that a shard that never started fails the solve quickly.
SPIN_MS = 5000
# int64 words per exchange slot (kSlotWords in the kernel): one 64-byte
# line each, word 0 of the buffer the abort word.
_SLOT_WORDS = 8


class _Exchange:
    """One exchange buffer of shard mode: pinned host memory mapped into
    every device (``kbt_xchg_alloc``), 2 parities x K slots.  Reused by a
    later solve once the events of the launches that read it completed
    (the pool holds as many as solves ever ran at once, for the life of
    the process); the epoch in each slot's tag keeps solves apart, so
    only the abort word is cleared."""

    def __init__(self, lib, shards: int):
        self.shards = shards
        self.words = _SLOT_WORDS * (1 + 2 * shards)
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        rc = lib.kbt_xchg_alloc(8 * self.words, ctypes.byref(host),
                                ctypes.byref(dev))
        if rc != 0:
            raise RuntimeError("exchange buffer allocation failed: "
                               + lib.kbt_error_string(rc).decode())
        self.host, self.dev = host.value, dev.value
        self.view = np.ctypeslib.as_array(
            (ctypes.c_int64 * self.words).from_address(self.host))
        self.events = ()

    @property
    def nbytes(self) -> int:
        return 8 * self.words

    def busy(self) -> bool:
        return any(not e.query() for e in self.events)

    def abort(self) -> None:
        """Raise the abort word from the host: every shard still spinning
        stops at its next poll."""
        self.view[0] = 1

    def aborted(self) -> bool:
        return bool(self.view[0])


_XCHG_POOL: list = []
_XCHG_LOCK = threading.Lock()
# Each solve's epoch, the high word of its exchange tags (never 0, so a
# zeroed slot matches no tag).
_EPOCH = [0]
# The shards' own streams, by (device index, shard): created once, shared
# with no other work (kbt_stream_create).
_SHARD_STREAMS: dict = {}
# One sharded solve launches at a time, and only once the last one's
# shards have all ended (``_LAST_SHARDS``, their events): two solves'
# shards interleaved on the shared streams (A0, B0 on stream 0, B1, A1
# on stream 1) would each wait for a shard queued behind the other's, and
# their residency was checked for one solve's clusters alone.
_LAUNCH_LOCK = threading.Lock()
_LAST_SHARDS: list = []   # guarded-by: _LAUNCH_LOCK


def _exchange_for(lib, shards: int) -> _Exchange:
    """A free exchange buffer of ``shards`` slots per parity, with a new
    epoch: (buffer, epoch)."""
    with _XCHG_LOCK:
        _EPOCH[0] = _EPOCH[0] % (2 ** 31 - 1) + 1
        epoch = _EPOCH[0]
        for x in _XCHG_POOL:
            if x.shards == shards and not x.busy():
                x.view[0] = 0
                x.events = ()
                return x, epoch
        x = _Exchange(lib, shards)
        _XCHG_POOL.append(x)
        return x, epoch


def _shard_stream(lib, device: torch.device, shard: int):
    key = (device.index, shard)
    stream = _SHARD_STREAMS.get(key)
    if stream is None:
        raw = ctypes.c_void_p()
        rc = lib.kbt_stream_create(device.index, ctypes.byref(raw))
        if rc != 0:
            raise RuntimeError("shard stream creation failed: "
                               + lib.kbt_error_string(rc).decode())
        stream = torch.cuda.ExternalStream(raw.value, device=device)
        _SHARD_STREAMS[key] = stream
    return stream


def solve_allocate_cuda_sharded(inp: SolverInputs, cfg: SolverConfig, *,
                                spin_ms: int | None = None,
                                max_cluster: int = CLUSTER_SIZES[-1],
                                stamps=None, late: tuple | None = None):
    """K1's shard mode over the mesh of ``inp``'s sharded leaves
    (parallel/mesh.py): one launch of the kernel per shard, each on the
    shard's device and its own stream, over the shard's node slice and
    the replicated task, job and queue state, the shards' per-placement
    keys meeting in one exchange buffer of mapped host memory (see the
    kernel's header).  Returns (SolveResult, FinalState) of shard 0 (every
    shard records the same outputs; the FinalState's node rows are shard
    0's slice) without waiting for the device; the caller's current
    streams wait for every shard.  Everything a launch needs is allocated
    before the first launch: a shard spins on the others, so no
    allocation (which may synchronize the device) may come between the
    launches.  A shard that gives up poisons the result, and the fetch
    raises ``DeviceFailure``.  Raises on CPU tensors, on anything the
    kernel does not take, and when a card cannot host its shards at
    once.  Sharded solves launch one at a time, each after the previous
    one's shards have ended (``_LAUNCH_LOCK``).  ``spin_ms`` bounds each
    wait on the exchange (default SPIN_MS).  ``stamps``: one int64
    [len(PHASES)] tensor per shard, on its device, turns on the phase
    stamps (see PHASES).  ``late`` (shard, ms), a drill of the exchange's
    deadline (chip_smoke.py), launches that shard ms after the others.
    The result is shard 0's, with ``kind`` and ``step`` -1 throughout
    when any shard gave up.  Every shard's (SolveResult, FinalState) is
    kept in ``.last_shards``."""
    from ..parallel.mesh import shard_mesh, shard_view
    mesh = shard_mesh(inp)
    if mesh is None:
        raise ValueError("solve_allocate_cuda_sharded takes inputs in the "
                         "mesh layout (parallel.mesh.shard_solver_inputs)")
    if any(d.type != "cuda" for d in mesh.devices):
        raise ValueError("solve_allocate_cuda_sharded takes CUDA shards; "
                         "use parallel.sharded_solver."
                         "solve_allocate_sharded_plain on the CPU")
    _weight_args(cfg)
    lib = build_shard_kernel()
    spin_ms = int(SPIN_MS if spin_ms is None else spin_ms)
    k = mesh.size
    per_device = {d: mesh.devices.count(d) for d in mesh.devices}
    f64 = int(inp.job_ts.dtype == torch.float64)
    launches = []
    offset = 0
    for s, dev in enumerate(mesh.devices):
        view = shard_view(inp, s)
        with torch.cuda.device(dev):
            ops = _operands(view)
            _check_operands(ops, dev)
            n_local = ops.bufs.node_int.shape[1]
            p = ops.task_data.shape[0]
            out = torch.empty((p, 4), dtype=torch.int32, device=dev)
            steps = torch.empty(1, dtype=torch.int32, device=dev)
            plan = hostable_plan(view, cfg, ops, max_cluster,
                                 need=per_device[dev], shards=k)
            tensors = dict(zip(Buffers._fields, ops.bufs))
            stamp = None if stamps is None else stamps[s]
            if stamp is not None and (
                    stamp.device != dev or stamp.dtype != torch.int64
                    or tuple(stamp.shape) != (len(PHASES),)):
                raise ValueError(f"stamps[{s}]: the kernel takes an int64 "
                                 f"[{len(PHASES)}] tensor on {dev}")
            tensors.update(task_data=ops.task_data, task_sig=ops.task_sig,
                           sig_mask=ops.sig_mask, sig_bonus=ops.sig_bonus,
                           nport=ops.nport, nsel=ops.nsel, total=ops.total,
                           score_shift=ops.score_shift, out=out,
                           steps=steps, stamps=stamp,
                           scratch=torch.empty(plan.scratch_ints,
                                               dtype=torch.int32,
                                               device=dev))
        launches.append((dev, ops, plan, tensors, offset))
        offset += n_local
    with _LAUNCH_LOCK:
        xchg, epoch = _exchange_for(lib, k)
        streams = [_shard_stream(lib, dev, s)
                   for s, dev in enumerate(mesh.devices)]
        args = []
        for s, (dev, ops, plan, tensors, off) in enumerate(launches):
            tensors["xchg"] = None
            a = _launch_args(ops, cfg, plan, tensors,
                             shard=(s, k, off, epoch, spin_ms))
            a.xchg = xchg.dev
            args.append(a)
            streams[s].wait_stream(torch.cuda.current_stream(dev))
            for ev in _LAST_SHARDS:
                streams[s].wait_event(ev)
        order = list(range(k))
        if late is not None:
            order.remove(late[0])
            order.append(late[0])
        launched = []
        try:
            for s in order:
                if late is not None and s == late[0]:
                    time.sleep(late[1] / 1e3)
                rc = lib.kbt_solve_session(ctypes.byref(args[s]), f64,
                                           streams[s].cuda_stream)
                if rc != 0:
                    raise RuntimeError(
                        f"solve_session shard {s} of {k}: kernel launch "
                        f"failed: " + lib.kbt_error_string(rc).decode())
                launched.append(s)
                solve_allocate_cuda_sharded.launches += 1
        except BaseException:
            xchg.abort()  # the shards already running stop spinning
            raise
        finally:
            events = []
            for s in launched:
                dev = mesh.devices[s]
                torch.cuda.current_stream(dev).wait_stream(streams[s])
                ev = torch.cuda.Event()
                ev.record(streams[s])
                events.append(ev)
            xchg.events = tuple(events)
            _LAST_SHARDS[:] = events
    solve_allocate_cuda_sharded.last_exchange_bytes = xchg.nbytes
    shards = []
    for _dev, ops, _plan, tensors, _off in launches:
        out = tensors["out"]
        shards.append((SolveResult(assignment=out[:, 0], kind=out[:, 1],
                                   order=out[:, 2], step=tensors["steps"][0]),
                       FinalState(ops.bufs.node_int, ops.bufs.jdyn,
                                  ops.bufs.qdyn, ops.nport, ops.nsel)))
    solve_allocate_cuda_sharded.last_shards = tuple(shards)
    with torch.cuda.device(mesh.devices[0]):
        return poisoned_by_any_shard(shards), shards[0][1]


def poisoned_by_any_shard(shards) -> SolveResult:
    """Shard 0's SolveResult of a sharded solve's (SolveResult,
    FinalState) per shard, with ``kind`` and ``step`` -1 throughout when
    any shard's step is -1 (it gave up on the exchange): a shard that gave
    up at the last exchange, after the others had its key, leaves shard
    0's outputs whole while its own node slice missed the update."""
    res0 = shards[0][0]
    dev = res0.kind.device
    bad = torch.stack([res.step.to(dev) for res, _ in shards]).lt(0).any()
    return res0._replace(kind=torch.where(bad, -1, res0.kind),
                         step=torch.where(bad, -1, res0.step))


# Shard launches since the count was last set to 0 (one per shard of each
# shard-mode solve), and the exchange buffer's bytes of the last solve.
solve_allocate_cuda_sharded.launches = 0
solve_allocate_cuda_sharded.last_exchange_bytes = 0
solve_allocate_cuda_sharded.last_shards = ()
