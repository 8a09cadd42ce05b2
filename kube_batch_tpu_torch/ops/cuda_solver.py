"""The whole-session allocate solve as one CUDA kernel launch.

Counterpart of kube_batch_tpu/ops/pallas_solver.py: ``build_buffers`` is
``_build_buffers``, ``solve_allocate_cuda`` launches
``csrc/solve_session.cu`` (the port of ``_solve_kernel``), and
``solve_allocate_plain`` is a plain PyTorch transcription of that kernel
over the same buffers.  The plain version is what the CPU route runs and
what the tests and chip_smoke.py hold the kernel against; nothing on the
main path calls it for CUDA tensors.

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
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .fairness import safe_share
from .resources import EPS_QUANTA, SCORE_GRID_K
from .scoring import SCORE_NEG_INF
from .solver import SolveResult, SolverConfig, SolverInputs

# The kernel keeps a task's request and a job's drain sums in registers.
MAX_R = 8
# Threads of one CTA (kThreads in the kernel), the shared memory one CTA
# may hold on an H100, and the cluster sizes the kernel launches with (16
# is Hopper's non-portable size; a card that cannot host it raises).
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
                 dtype: torch.dtype, jdim: int, qdim: int) -> ClusterPlan:
    """The smallest cluster in CLUSTER_SIZES whose slice is at most
    SLICE_NODES (or the largest cluster) and whose CTAs hold all the
    session's state in shared memory: the queue piece, their node slice's
    rows, their job copy and the static job rows.  Where none does, the
    largest cluster, with as much on chip as fits in this order: node rows
    (a prefix), job copy, static job rows; the rest lives in the global
    scratch and solves through the same code.  The queue piece always
    lives on chip: raises ValueError for a queue count beyond that.
    ``np_use``/``ns_use`` are the port and selector rows the conf reads (0
    when it switches them off)."""
    lay = layout(r, np_use, ns_use)
    rows = node_rows(r, np_use, ns_use)
    fbytes = 4 if dtype == torch.float32 else 8
    warps = THREADS // 32
    js = (lay.juid + 1) * jdim * fbytes
    # job piece: dynamic copy and DRF shares (4 bytes each)
    jpiece = (lay.jact + 2) * jdim
    jw = jpiece * 4
    # exchange slots and mbarriers (two parities), task buffer and pop
    # result, then the queue piece: static queue rows (float key type),
    # dynamic copy, job cache [Q, warps], queue shares and deserved quanta
    # (4 bytes each)
    queue = ((lay.qdesf + r) * qdim * fbytes
             + (lay.qact + 2 + warps + r) * qdim * 4)

    def fixed(c):
        return c * 2 * warps * 8 + 2 * 8 + 72 * 4 + queue

    def plan(c, slice_, smem_rows, js_in, jw_in, used):
        return ClusterPlan(c, slice_, rows, smem_rows, js_in, jw_in, used,
                           rows * n + c * jpiece)

    for c in CLUSTER_SIZES:
        slice_ = -(-n // c)
        need = fixed(c) + js + rows * slice_ * 4 + jw
        if need <= SMEM_PER_CTA and (slice_ <= SLICE_NODES
                                     or c == CLUSTER_SIZES[-1]):
            return plan(c, slice_, rows, True, True, need)
    c = CLUSTER_SIZES[-1]
    slice_ = -(-n // c)
    used = fixed(c)
    if used > SMEM_PER_CTA:
        raise ValueError(
            f"{qdim} queues need {queue} B of shared memory for the queue "
            f"state, over the {SMEM_PER_CTA} B a CTA holds")
    smem_rows = min(rows, (SMEM_PER_CTA - used) // (slice_ * 4))
    used += smem_rows * slice_ * 4
    jw_in = used + jw <= SMEM_PER_CTA
    used += jw if jw_in else 0
    js_in = used + js <= SMEM_PER_CTA
    used += js if js_in else 0
    return plan(c, slice_, smem_rows, js_in, jw_in, used)


def plan_of(inp: SolverInputs, cfg: SolverConfig) -> ClusterPlan:
    """The cluster plan the kernel launches with for ``inp`` under
    ``cfg``."""
    lay = _layout_of(inp)
    uses_sel = cfg.has_pod_affinity or cfg.has_pod_affinity_score
    return cluster_plan(
        inp.node_idle.shape[0], inp.task_req.shape[1],
        lay.aff - lay.ports if cfg.has_ports else 0,
        lay.anti - lay.aff if uses_sel else 0, inp.job_ts.dtype,
        inp.job_start.shape[0], inp.queue_deserved.shape[0])


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
    ops = _operands(inp)
    lay, (nint, ncs, jsta, jdyn, qdes, qsta, qdyn) = ops.lay, ops.bufs
    nport, nsel_rows = ops.nport, ops.nsel
    r = inp.task_req.shape[1]
    np_pad = lay.aff - lay.ports
    ns_pad = lay.anti - lay.aff
    n = nint.shape[1]
    jdim = jsta.shape[1]
    qdim = qsta.shape[1]
    p = ops.task_data.shape[0]
    n_sig = ops.sig_mask.shape[0]
    dev = nint.device
    fdt = jsta.dtype
    inf = torch.tensor(float("inf"), dtype=fdt, device=dev)
    col_n = torch.arange(n, device=dev)
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

            feasible = ((ops.sig_mask[sig] > 0.5) & (nint[lay.exists] > 0)
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
            score = torch.zeros(n, dtype=torch.int32, device=dev)
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
            score = score + ops.sig_bonus[sig]
            score = torch.where(feasible, score, SCORE_NEG_INF)

            best = torch.max(score)
            pick = torch.min(torch.where(score == best, col_n, n))
            best, pick, fi, fr = torch.stack(
                [best.long(), pick, fit_idle[pick].long(),
                 fit_rel[pick].long()]).tolist()
            feasible_any = best > SCORE_NEG_INF

            placing = not exhausted and feasible_any
            alloc_ok = placing and bool(fi)
            pipe_ok = placing and not fi and bool(fr)
            placed = alloc_ok or pipe_ok
            if placed:
                delta = ([-res[i] if alloc_ok else 0 for i in range(r)]
                         + [-res[i] if pipe_ok else 0 for i in range(r)]
                         + res + [1])
                nint[:ndyn, pick] += torch.tensor(
                    [_i32(v) for v in delta], dtype=torch.int32, device=dev)
                out[t] = (pick, 1 if alloc_ok else 2, dstep, 0)
                if cfg.has_ports:
                    nport[:, pick] |= torch.as_tensor(
                        row[lay.ports:lay.ports + np_pad], device=dev)
                if cfg.has_pod_affinity or cfg.has_pod_affinity_score:
                    nsel_rows[:, pick] += torch.as_tensor(
                        row[lay.match:lay.match + ns_pad], device=dev)
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
    return result, FinalState(nint, jdyn, qdyn, nport, nsel_rows)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_POINTER_FIELDS = ("node_int", "node_cs", "task_data", "task_sig",
                   "sig_mask", "sig_bonus", "jsta", "jdyn", "qsta", "qdes",
                   "qdyn", "nport", "nsel", "total", "score_shift", "out",
                   "steps", "stamps", "scratch")
_SHAPE_FIELDS = ("n", "p", "jdim", "qdim", "r", "np_pad", "ns_pad", "n_sig")
_PLAN_FIELDS = ClusterPlan._fields[:ClusterPlan._fields.index("smem_bytes") + 1]
_CONFIG_FIELDS = ("w_least5", "w_most5", "w_bal", "has_gang",
                  "has_proportion", "has_ports", "has_pod_affinity",
                  "has_pod_affinity_score", "job_key0", "job_key1",
                  "job_key2", "queue_key0")


# The kernel's phase stamps, in slot order: cycles of thread 0 in each
# phase, then the counts of placements (node scans) and pops, then the
# cycles of the whole launch.
PHASES = ("queue_pop", "job_pop", "node_scan", "cta_reduce",
          "cluster_exchange", "owner_update", "write_back", "placements",
          "pops", "total")


class SolveArgs(ctypes.Structure):
    """Mirror of ``struct SolveArgs`` in csrc/solve_session.cu: device
    pointers, shapes, the cluster plan, the conf as launch arguments, then
    the Layout."""
    _fields_ = ([(f, ctypes.c_void_p) for f in _POINTER_FIELDS]
                + [(f, ctypes.c_int32) for f in
                   _SHAPE_FIELDS + _PLAN_FIELDS + _CONFIG_FIELDS
                   + Layout._fields])


class _Kernel:
    lib = None
    build_seconds = None
    build_log = ""


def build_kernel() -> ctypes.CDLL:
    """Compile csrc/solve_session.cu with nvcc into BUILD_DIR (once per
    source content) and load it.  Raises when nvcc or the build fails."""
    if _Kernel.lib is not None:
        return _Kernel.lib
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libsolve_session_{tag}.so"
    began = time.perf_counter()
    if not so.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA toolkit is needed "
                               "to build csrc/solve_session.cu")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SRC}:\n{proc.stderr}")
        _Kernel.build_log = proc.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.kbt_solve_session.argtypes = [ctypes.POINTER(SolveArgs),
                                      ctypes.c_int, ctypes.c_void_p]
    lib.kbt_solve_session.restype = ctypes.c_int
    lib.kbt_error_string.argtypes = [ctypes.c_int]
    lib.kbt_error_string.restype = ctypes.c_char_p
    _Kernel.build_seconds = time.perf_counter() - began
    _Kernel.lib = lib
    return lib


def _check_operands(ops: Operands, dev: torch.device) -> None:
    lay, bufs = ops.lay, ops.bufs
    r = ops.total.shape[0]
    if not 1 <= r <= MAX_R:
        raise ValueError(f"the kernel takes 1..{MAX_R} resource dims, got {r}")
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


def solve_allocate_cuda(inp: SolverInputs, cfg: SolverConfig, *,
                        stamps: torch.Tensor | None = None):
    """One launch of the whole-session kernel on the current stream.
    Returns (SolveResult, FinalState) without waiting for the device.
    Raises on CPU tensors and on anything the kernel does not take.

    ``stamps``, an int64 [len(PHASES)] tensor on the device, turns on the
    kernel's clock64() phase stamps and receives them (see PHASES); the
    main path passes none and runs the kernel without them."""
    dev = inp.node_idle.device
    if dev.type != "cuda":
        raise ValueError("solve_allocate_cuda takes CUDA tensors; use "
                         "solve_allocate_plain for tensors on the CPU")
    for name, leaf in zip(SolverInputs._fields, inp):
        if leaf.device != dev:
            raise ValueError(f"{name} is on {leaf.device}, not {dev}")
    w_least5, w_most5, w_bal = _weight_args(cfg)
    with torch.cuda.device(dev):
        ops = _operands(inp)
        _check_operands(ops, dev)
        lay, bufs = ops.lay, ops.bufs
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
        job_keys = _key_codes(cfg.job_key_order, _JOB_KEYS, 3)
        (queue_key,) = _key_codes(cfg.queue_key_order, _QUEUE_KEYS, 1)
        r = inp.task_req.shape[1]
        np_pad, ns_pad = lay.aff - lay.ports, lay.anti - lay.aff
        plan = plan_of(inp, cfg)
        tensors["stamps"] = stamps
        tensors["scratch"] = torch.empty(plan.scratch_ints,
                                         dtype=torch.int32, device=dev)
        args = SolveArgs(
            *[None if tensors[f] is None else tensors[f].data_ptr()
              for f in _POINTER_FIELDS],
            n=bufs.node_int.shape[1], p=p, jdim=bufs.jsta.shape[1],
            qdim=bufs.qsta.shape[1], r=r, np_pad=np_pad, ns_pad=ns_pad,
            n_sig=ops.sig_mask.shape[0],
            **{f: int(getattr(plan, f)) for f in _PLAN_FIELDS},
            w_least5=w_least5, w_most5=w_most5, w_bal=w_bal,
            has_gang=bool(cfg.has_gang),
            has_proportion=bool(cfg.has_proportion),
            has_ports=bool(cfg.has_ports),
            has_pod_affinity=bool(cfg.has_pod_affinity),
            has_pod_affinity_score=bool(cfg.has_pod_affinity_score),
            job_key0=job_keys[0], job_key1=job_keys[1], job_key2=job_keys[2],
            queue_key0=queue_key, **lay._asdict())
        lib = build_kernel()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.kbt_solve_session(ctypes.byref(args),
                                   int(bufs.jsta.dtype == torch.float64),
                                   stream)
    if rc != 0:
        raise RuntimeError("solve_session kernel launch failed: "
                           + lib.kbt_error_string(rc).decode())
    solve_allocate_cuda.launches += 1
    result = SolveResult(assignment=out[:, 0], kind=out[:, 1],
                         order=out[:, 2], step=steps[0])
    return result, FinalState(bufs.node_int, bufs.jdyn, bufs.qdyn,
                              ops.nport, ops.nsel)


# Launches of the kernel since the count was last set to 0.
solve_allocate_cuda.launches = 0
