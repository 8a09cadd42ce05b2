"""Candidate-row solve prefilter: the [C << N] allocate program.

Counterpart of kube_batch_tpu/ops/prefilter.py, carried over line for
line but for the route names (``cuda`` and ``torch``) and the sharded
gather, which waits for the multi-device mesh.  On the card the gathered
program is one launch of the session kernel (csrc/solve_session.cu) on
the [C] rows, on the CPU its plain version (ops/solver.py).

The last solver-side per-cycle floor (ROADMAP item #2, doc/INCREMENTAL.md
"Killing the per-cycle floors"): even a micro session's solve scans every
[N] node row per placement, so a 0.1% churn cycle at 50k x 10k still pays
the full-cluster device wait.  This module derives, on host and per
session, a PROVABLY sufficient candidate node set C from the staged start
tensors; the dispatch then gathers only those rows out of the resident
buffer into a bucketed [C]-node program and the readback scatters the
assignment back into full-node indices — bit-identical placements at a
per-placement cost of O(C) instead of O(N).

## Why the candidate set is exact (not a heuristic)

Fix the session-start tensors.  During the allocate solve:

* a node's ``idle``/``releasing`` only DECREASE and its ``count`` only
  INCREASES — and only when a task is placed on it ("touched");
* ``sig_mask``/``node_exists``/``node_alloc``/``sig_bonus`` never change;
* an UNTOUCHED node's feasibility for a task profile and its score are
  therefore constant, equal to their session-start values.

At every placement step the argmax winner is either (a) a previously
touched node, or (b) the (score desc, node-index asc)-best start-feasible
untouched node.  At most ``T = p_real`` placements happen, so at most T
nodes are ever touched, and the winner-from-untouched at any step lies
within the first ``T+1`` start-feasible nodes of its profile's start
ranking.  Inductively every winner — hence every touched node — lies in

    C = union over distinct pending profiles (sig, req, res) of the
        first min(T+1, all) start-feasible nodes in
        (start score desc, node index asc) order,

evaluated with the device's exact integer formulas (the same grid-score
ints as ops/scoring.grid_score and the kernel's node scan).  Ties are
safe because candidate rows are gathered in ascending node order, so
"first max" over the gathered program equals "first max" over the full
one restricted to C — and no node outside C can attain the max.

Dynamic predicates (host ports, pod (anti-)affinity) make untouched-node
scores task-placement-dependent only through occupancy tensors that also
change exclusively on touch — but the required-affinity mask can GROW
feasibility, so rather than ranking under those features the prefilter
simply stands down when any of them is active (they are rare; the full
program is the unconditional fallback and the parity control).

The prefilter keys off the resident buffer's generation contract: it is
consulted only on the dispatch path (a byte-clean ship reuses the cached
solve without any program at all, doc/INCREMENTAL.md), and the readback
is remapped and stored in the SAME generation-keyed solve cache, so a
later clean cycle reuses the full-space result regardless of which
program produced it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import knobs
from .compile_cache import bucket
from .resources import EPS_QUANTA, SCORE_GRID_K

# Escape hatch for A/B measurement and field debugging: =0 always runs
# the full-node-bucket program (placement-identical by construction).
CANDIDATE_SOLVE_ENV = knobs.CANDIDATE_SOLVE.env
# Above this many distinct pending (sig, req, res) profiles the host
# ranking pass costs more than the device scan it would save.
_MAX_PROFILES = 64


def candidate_solve_enabled() -> bool:
    return knobs.CANDIDATE_SOLVE.enabled()


class CandidateSet:
    """One session's candidate-row gather plan.

    ``remap`` maps every gathered program row back to its full-space node
    row — the scatter applied to the readback's assignment column.  The
    mesh route's per-shard plan ([n_dev, L] device-local index/valid
    matrices) comes with the multi-device mesh."""

    __slots__ = ("count", "remap", "idx", "valid")

    def __init__(self, count, remap, idx, valid):
        self.count = count          # real candidate rows (pre-padding)
        self.remap = remap          # np [C_pad] int32 full node rows
        self.idx = idx              # np [C_pad] int32
        self.valid = valid          # np [C_pad] bool


def _fit_rows(req: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """[N] bool epsilon LessEqual of one task request against [N, R]
    state — the numpy mirror of the solve's fit test
    (ops/resources.less_equal_vec, the kernel's node scan: same
    EPS_QUANTA semantics per dimension, scalar dims >= 2 skipped when
    the request is epsilon-low).  Exactness-load-bearing: a drift from
    the device math would silently mis-rank candidates, so
    tests/test_torch_prefilter.py::test_prefilter_host_mirrors_equal_device_math
    pins value identity — change them together."""
    r = mat.shape[1]
    ok = None
    for i in range(r):
        l = int(req[i])
        m = mat[:, i].astype(np.int64)
        oki = (l < m) | (np.abs(l - m) < EPS_QUANTA)
        if i >= 2:
            oki = oki | (l <= EPS_QUANTA)
        ok = oki if ok is None else ok & oki
    return ok


def _grid_score_rows(res: np.ndarray, used: np.ndarray, alloc: np.ndarray,
                     shift: np.ndarray, weights) -> np.ndarray:
    """[N] int64 start scores — the exact integer math of
    ops/scoring.grid_score (same ints as the kernel's node scan: grid
    floor divisions + weighted sums).  Pinned against grid_score by
    test_prefilter_host_mirrors_equal_device_math — change together."""
    g = []
    for d in range(2):
        cs = alloc[:, d].astype(np.int64) >> int(shift[d])
        xs = np.minimum((used[:, d].astype(np.int64) + int(res[d]))
                        >> int(shift[d]), cs)
        q = np.where(cs > 0, (xs * SCORE_GRID_K) // np.maximum(cs, 1),
                     SCORE_GRID_K)
        g.append(q)
    gc, gm = g
    score = np.zeros(used.shape[0], np.int64)
    if weights.least_requested:
        score += int(weights.least_requested) * 5 * (
            2 * SCORE_GRID_K - gc - gm)
    if weights.most_requested:
        score += int(weights.most_requested) * 5 * (gc + gm)
    if weights.balanced_resource:
        score += int(weights.balanced_resource) * (
            10 * SCORE_GRID_K - 10 * np.abs(gc - gm))
    return score


def derive_candidates(snap, route: str) -> Optional["CandidateSet"]:
    """The session's candidate set, or None when the full program should
    run (feature gated off, dynamic predicates active, too many
    profiles, or C's bucket is not strictly smaller than the node
    bucket — no win to be had).  ``route`` is ``choose_solver_mesh``'s
    choice: ``cuda`` or ``torch`` gather on one device; ``sharded``
    raises until the multi-device mesh is ported."""
    if not candidate_solve_enabled():
        return None
    cfg = snap.config
    if cfg.has_ports or cfg.has_pod_affinity or cfg.has_pod_affinity_score:
        return None  # dynamic occupancy terms: see module docstring
    p_real = len(snap.tasks)
    if p_real == 0:
        return None
    inp = snap.inputs
    n_pad = int(np.asarray(inp.node_idle).shape[0])

    task_sig = np.asarray(inp.task_sig)[:p_real].astype(np.int64)
    task_req = np.asarray(inp.task_req)[:p_real].astype(np.int64)
    task_res = np.asarray(inp.task_res)[:p_real].astype(np.int64)
    profiles = np.unique(
        np.concatenate([task_sig[:, None], task_req, task_res], axis=1),
        axis=0)
    if profiles.shape[0] > _MAX_PROFILES:
        return None

    idle = np.asarray(inp.node_idle)
    releasing = np.asarray(inp.node_releasing)
    used = np.asarray(inp.node_used)
    alloc = np.asarray(inp.node_alloc)
    count = np.asarray(inp.node_count).astype(np.int64)
    maxt = np.asarray(inp.node_max_tasks).astype(np.int64)
    exists = np.asarray(inp.node_exists)
    sig_mask = np.asarray(inp.sig_mask)
    sig_bonus = np.asarray(inp.sig_bonus).astype(np.int64)
    shift = np.asarray(inp.score_shift)
    r = task_req.shape[1]

    top_k = p_real + 1  # T+1: at most p_real placements can touch nodes
    static_ok = exists & (count < maxt)
    members = []
    for row in profiles:
        sig = int(row[0])
        req = row[1:1 + r]
        res = row[1 + r:]
        feasible = (sig_mask[sig] & static_ok
                    & (_fit_rows(req, idle) | _fit_rows(req, releasing)))
        feas_idx = np.nonzero(feasible)[0]
        if feas_idx.size == 0:
            continue
        if feas_idx.size > top_k:
            score = (_grid_score_rows(res, used[feas_idx], alloc[feas_idx],
                                      shift, cfg.weights)
                     + sig_bonus[sig][feas_idx])
            # (score desc, node index asc): lexsort's last key is
            # primary; feas_idx is already ascending so equal scores
            # keep index order.
            order = np.lexsort((feas_idx, -score))[:top_k]
            feas_idx = feas_idx[order]
        members.append(feas_idx)
    if not members:
        return None  # nothing placeable: the full program retires fast
    cand = np.unique(np.concatenate(members)).astype(np.int32)

    if route == "sharded":
        raise NotImplementedError(
            "the per-shard candidate gather comes with the multi-device "
            "mesh; one device gathers on the cuda or torch route")

    c_pad = bucket(int(cand.size))
    if c_pad >= n_pad:
        return None
    idx = np.full((c_pad,), int(cand[-1]), np.int32)
    idx[:cand.size] = cand
    valid = np.zeros((c_pad,), bool)
    valid[:cand.size] = True
    remap = idx.copy()
    return CandidateSet(int(cand.size), remap, idx, valid)
