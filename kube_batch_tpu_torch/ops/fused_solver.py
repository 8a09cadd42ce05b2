"""One-dispatch sessions: the action ladder's solve families enqueued as
ONE device program (kube_batch_tpu/ops/fused_solver.py, doc/FUSED.md).

Three solver families read the same resident node image and none depends
on another's device output: the allocate solve (ops/solver.py), the
batched eviction solve (ops/evict_solver.py) and the topo box scan
(ops/topo_solver.py).  The reference composes their jitted programs in one
outer jit.  On the card the program is one enqueue sequence on the
current CUDA stream (under tenancy, the shard view's own, scheduler.py),
with no host synchronisation between its first and last enqueue:

  * ``topo`` leg — ``box_scan``'s [N, 6] origin stats for the first slice
    job, staged by actions/topo_allocate.py before the scanner builds;
  * ``evict`` leg — ``evict_batch_solve``'s [K, N] profile scan and the
    victim permutation, consumed lazily by models/scanner.py;
  * ``postevict`` leg (the storm half) — ``_postevict_adjust``, tensor
    code that predicts reclaim's first committed iteration and adjusts
    the allocate inputs by its mutations;
  * ``alloc`` leg — one launch of the hand-written session kernel
    (ops/cuda_solver.solve_allocate_cuda; its plain version on the CPU)
    on the full node axis, on the gathered candidate rows, or on the
    storm leg's adjusted inputs, packed through ``_pack_result_ordered``
    into the same ``PendingSolve`` that ``dispatch_solve`` builds, so
    tpu-allocate's ``finish`` consumes it through ``fetch_solve``
    unchanged.

Each leg's readback is a non-blocking copy into pinned host memory
followed by its own event, and the legs are enqueued in the order their
consumers run (topo-allocate, then the eviction walk, then tpu-allocate):
a consumer waits on its leg's event only, so the eviction walk starts
while the session kernel still runs.  The reference's single program has
no order the host can see; on one stream the enqueue order decides what
the first consumer waits for.

Validity is generation-proved, never assumed: the alloc leg records the
shipper generation it solved at, and tpu-allocate consumes it only when
its own ship comes back CLEAN at that same generation with the same
config and the same candidate gather.  Anything else counts a
``kube_batch_tpu_fused_legs_total{outcome="invalidated"}`` and the family
re-dispatches on the card.  ``KUBE_BATCH_TPU_FUSED=0`` is the control.

A fused dispatch or readback failure feeds the device breaker, counts,
invalidates the resident image and re-dispatches per family on the card,
as in the reference; a family whose own dispatch then fails raises
``DeviceFailure`` on the card (chaos/breaker.py).  On the mesh each leg
takes its sharded route (parallel/): the allocate leg K1's shard mode (its
plain version on CPU shards), the evict leg the sharded batch solve
reading the resident node leaves in place, the topo leg the
origin-sharded box scan.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import knobs

FUSED_ENV = knobs.FUSED.env
FUSED_SOLVE_CHOICE = "fused"

# Leg outcome vocabulary (kube_batch_tpu_fused_legs_total{outcome=}):
#   served      — the precomputed tensor answered the family's question
#   invalidated — host state moved between dispatch and consume (or the
#                 consumer's staging differed); per-family re-dispatch
#   unused      — dispatched but never consumed (e.g. the incremental
#                 cache answered first, or the session aborted)
#   failed      — the fused dispatch/readback itself errored


def fused_enabled() -> bool:
    return knobs.FUSED.enabled()


def storm_enabled() -> bool:
    """The storm half (doc/FUSED.md): the fused program also solves the
    post-eviction placements against the occupancy its own evict leg
    adjusts on device, so an eviction-led cycle stays at one dispatch."""
    return knobs.FUSED.enabled() and knobs.FUSED_STORM.enabled()


class _AllocLeg(NamedTuple):
    """The alloc leg's host-side capture: everything tpu-allocate must
    re-derive identically for the precomputed solve to be ITS solve."""
    inputs: object        # resident SolverInputs (the shipped image)
    cfg: object           # SolverConfig
    route: str            # choose_solver_mesh choice at stage time
    mesh: object          # its mesh on the sharded route, else None
    generation: int       # shipper generation the solve read
    cand_sig: object      # candidate-gather identity (None = full bucket)
    candidates: object    # the staged CandidateSet (remap for the fetch)


class FusedState:
    """Per-session fused-dispatch ledger, cached on ``ssn._fused_state``.

    One fused dispatch per session maximum: the first device-needing
    consumer stages every leg it can prove out and fires; later
    consumers either match their capture (served) or re-dispatch per
    family (invalidated, counted)."""

    __slots__ = ("dispatched", "failed", "legs", "alloc_pending",
                 "alloc_leg", "topo_request", "topo_out", "topo_sig",
                 "early_scanner", "storm")

    def __init__(self):
        self.dispatched = False
        self.failed = False
        self.legs = ()
        self.alloc_pending = None   # PendingSolve until consumed/discarded
        self.alloc_leg = None       # _AllocLeg capture
        self.topo_request = None    # (BoxInputs np, shape, sig) staging
        self.topo_out = None        # (host [N, 6] stats, ready event)
        self.topo_sig = None
        self.early_scanner = False  # scanner seeded before mutations ran
        self.storm = None           # _StormCapture (postevict leg)


def _storm_nbytes(cap) -> int:
    total = 0
    for a in (cap.vic_res, cap.vic_qix, cap.vic_jix, cap.vic_node):
        if a is not None:
            total += int(a.nbytes)
    if cap.dinp:
        for a in cap.dinp.values():
            total += int(a.nbytes)
    return total


# The SolverInputs fields _prove_storm compares against the fresh
# staging: the delta-replay targets (P3), the remap-compared task
# columns and the must-be-bit-equal axes (P4), and the job-block
# geometry.  Captured as numpy COPIES at dispatch time: the persistent
# staging layer rewrites the session snapshot and its buffers in place
# on the next tensorize (models/tensor_snapshot.py), so by-reference
# capture would compare the fresh state to itself.
_PROOF_FIELDS = (
    # P4: per-task columns (compared under the uid remap)
    "task_req", "task_res", "task_sig", "task_ports", "task_aff_req",
    "task_anti", "task_match", "task_paff_w", "task_panti_w",
    # P4: axes the predicted iteration cannot touch (bit-equal)
    "sig_mask", "sig_bonus", "node_idle", "node_alloc", "node_max_tasks",
    "node_exists", "node_coords", "queue_deserved", "queue_deserved_f",
    "queue_ts", "queue_uid_rank", "queue_exists", "job_queue",
    "job_minavail", "job_prio", "job_ts", "job_uid_rank", "total_res",
    "eps", "scalar_dims", "score_shift",
    # P4: job-block geometry
    "job_start", "job_count", "task_sorted",
    # P3: the mutated axes (fresh == these + modeled deltas)
    "node_releasing", "node_used", "node_count", "node_ports",
    "node_selcnt", "queue_init_alloc", "job_init_alloc",
    "job_init_ready",
)


class _StormCapture:
    """Host half of the post-eviction storm leg: the dispatch-time
    staging captured BY VALUE (uid axis, axis name lists, config, numpy
    copies of the proof-compared input arrays), the victim staging
    columns the device chose from, the device's prediction readbacks
    (pinned host ``meta`` and ``sel`` behind the ``ready`` event), and
    the session mutation log the serve proof replays against
    (doc/FUSED.md "Storm half").  Released at consume or at session
    close — the ledger audit pins retention.

    # mem-ledger: fused_storm
    """

    __slots__ = ("duids", "dnode_names", "djob_uids", "dqueue_ids",
                 "dres_names", "dconfig", "dinp", "route", "vic_res",
                 "vic_qix", "vic_jix", "vic_node", "uids", "meta", "sel",
                 "ready", "mutlog", "_mem_key", "__weakref__")

    def __init__(self, snap, route, vic_res, vic_qix, vic_jix, vic_node,
                 uids, meta, sel, ready):
        self.duids = [t.uid for t in snap.tasks]  # dispatch task axis
        self.dnode_names = list(snap.node_names)
        self.djob_uids = list(snap.job_uids)
        self.dqueue_ids = list(snap.queue_ids)
        self.dres_names = list(snap.resource_names)
        self.dconfig = snap.config
        self.dinp = {name: np.array(np.asarray(getattr(snap.inputs, name)))
                     for name in _PROOF_FIELDS}
        self.route = route          # the route the adjusted solve ran on
        self.vic_res = vic_res      # [M, R] i32 victim resreq quanta
        self.vic_qix = vic_qix      # [M] i32 queue index (Q = absent)
        self.vic_jix = vic_jix      # [M] i32 job index (J = absent)
        self.vic_node = vic_node    # [M] i32 node row (evict-leg column)
        self.uids = list(uids)      # [m] victim uid per slot
        self.meta = meta            # host [6] i32 did,q*,j*,t*,n*,vcnt
        self.sel = sel              # host [M] bool chosen-victim mask
        self.ready = ready          # event after both copies (None: CPU)
        self.mutlog = []            # (kind, uid, node) from Session hooks
        from ..metrics import memledger
        self._mem_key = memledger.ledger("fused_storm").track(
            self, sizer=_storm_nbytes)
        memledger.ledger("fused_storm").set(self._mem_key,
                                            _storm_nbytes(self))

    def prediction(self):
        """(meta, sel) as numpy, after the leg's readback event."""
        if self.ready is not None:
            self.ready.synchronize()
        return self.meta.numpy(), self.sel.numpy()

    def release(self) -> None:
        self.duids = []
        self.dnode_names = self.djob_uids = self.dqueue_ids = []
        self.dres_names = []
        self.dconfig = None
        self.dinp = {}
        self.vic_res = self.vic_qix = self.vic_jix = self.vic_node = None
        self.meta = self.sel = self.ready = None
        self.uids = []
        self.mutlog = []
        from ..metrics import memledger
        memledger.ledger("fused_storm").set(self._mem_key, 0)


def state_for(ssn) -> FusedState:
    st = getattr(ssn, "_fused_state", None)
    if st is None:
        st = FusedState()
        ssn._fused_state = st
    return st


def _conf_names(ssn) -> tuple:
    """The session's action ladder (scheduler stamps it at open)."""
    return tuple(getattr(ssn, "_conf_actions", ()) or ())


# ---------------------------------------------------------------------------
# The fused program.
# ---------------------------------------------------------------------------

def _postevict_adjust(inp, cfg, vic_node, vic_res, vic_queue, vic_job):
    """Predict reclaim's first committed iteration and adjust the solve
    inputs by exactly its mutations (doc/FUSED.md "Storm half"), as
    tensor code on the inputs' device with no host read.

    The prediction mirrors actions/reclaim.py against the OPEN-state
    arrays the dispatch staged: q* is the first queue surviving the PQ
    guards (exists, a pending candidate job, not Overused) in (share,
    ts, uid) order; j* is q*'s front job by the tiered job-order chain;
    t* is j*'s front task; n* is the first node ascending that passes
    the static+dynamic predicate chain AND whose other-queue residents'
    total resreq covers t*'s init request; the victims are the
    slot-order prefix of n*'s other-queue residents until the running
    sum covers (the evict loop's inclusive break).  Every delta below is
    the staged image of the host mutations those commits cause; the
    serve proof in ``_prove_storm`` re-derives the same deltas on the
    host and refuses the leg on any mismatch, so a wrong prediction can
    only cost a re-dispatch, never a wrong placement.

    The reference scatters with ``mode="drop"`` onto sentinel rows (a
    padding victim's node N, an unchosen or axis-absent victim's queue Q
    and job J, q* and j* when nothing was done).  On the card an
    out-of-range scatter is a device-side assert that poisons the
    context, so every scatter here goes to a buffer one row longer,
    every index outside the axis is sent to that row, and the row is
    sliced off.  Gathers clamp their index, as XLA's gather does.

    Returns ``(adjusted inputs, meta, chosen)`` with ``meta`` = i32
    ``[did, q*, j*, t*, n*, v_count]`` and ``chosen`` the [M] victim
    mask.  When ``did`` is 0 the adjustment is the identity."""
    from .fairness import queue_shares, safe_share
    from .resources import less_equal_vec
    from .solver import _lex_argmin, dynamic_predicate_mask
    i32 = torch.int32
    dev = inp.node_exists.device
    kdt = inp.job_ts.dtype
    nb = inp.node_exists.shape[0]
    qb = inp.queue_exists.shape[0]
    jb = inp.job_start.shape[0]
    vic_node = vic_node.long()
    vic_queue = vic_queue.long()
    vic_job = vic_job.long()
    valid = vic_node < nb

    def sink(idx, size):
        """``idx`` as a scatter index into a [size + 1] buffer: anything
        outside [0, size) goes to the dropped last row."""
        idx = idx.long()
        return torch.where((idx >= 0) & (idx < size), idx,
                           torch.full_like(idx, size))

    def scatter_add(base, idx, src):
        """``base.at[idx].add(src, mode="drop")``: a new tensor."""
        size = base.shape[0]
        buf = torch.cat([base, base.new_zeros((1,) + tuple(base.shape[1:]))])
        buf.index_add_(0, sink(idx, size), src.to(base.dtype))
        return buf[:size]

    def row(x, i):
        """``x[i]`` for a 0-d index tensor, clamped into range."""
        return x[i.long().clamp(0, x.shape[0] - 1)]

    # q* — reclaim.py:54-61 guards in pop order.
    has_pending = scatter_add(torch.zeros((qb,), dtype=i32, device=dev),
                              inp.job_queue,
                              (inp.job_count > 0).to(i32)) > 0
    if cfg.has_proportion:
        overused = less_equal_vec(inp.queue_deserved, inp.queue_init_alloc,
                                  inp.eps, inp.scalar_dims)
    else:
        overused = torch.zeros((qb,), dtype=torch.bool, device=dev)
    qmask = inp.queue_exists & has_pending & ~overused
    qkeys = []
    for name in cfg.queue_key_order:
        if name == "proportion":
            qkeys.append(queue_shares(inp.queue_init_alloc,
                                      inp.queue_deserved_f))
    qkeys.extend([inp.queue_ts, inp.queue_uid_rank])
    qstar = _lex_argmin(qmask, qkeys, kdt)

    # j* — the tiered chain of _select_job over the open-state arrays
    # (reclaim pops before anything mutates, so init IS the live state).
    jmask = (qmask.any() & (inp.job_queue == qstar) & (inp.job_count > 0)
             & (inp.job_minavail >= 0))
    jkeys = []
    for name in cfg.job_key_order:
        if name == "priority":
            jkeys.append(-inp.job_prio)
        elif name == "gang":
            ready = inp.job_init_ready >= inp.job_minavail
            jkeys.append(ready.to(kdt))
        elif name == "drf":
            jkeys.append(torch.amax(
                safe_share(inp.job_init_alloc, inp.total_res[None, :]),
                dim=-1))
    jkeys.extend([inp.job_ts, inp.job_uid_rank])
    jstar = _lex_argmin(jmask, jkeys, kdt)
    tstar = row(inp.task_sorted, row(inp.job_start, jstar)).to(i32)
    treq = row(inp.task_req, tstar)

    # n* — first node ascending passing the scanner's predicate chain
    # (models/scanner._scores_numpy feasibility) with an admissible
    # other-queue resident set whose TOTAL covers (reclaim.py:119-142).
    other = valid & (vic_queue != qstar)
    zero_res = torch.zeros_like(vic_res)
    tot = scatter_add(torch.zeros((nb, treq.shape[0]), dtype=i32,
                                  device=dev),
                      vic_node, torch.where(other[:, None], vic_res,
                                            zero_res))
    covers = less_equal_vec(treq[None, :].expand(tot.shape), tot, inp.eps,
                            inp.scalar_dims)
    feas = (row(inp.sig_mask, row(inp.task_sig, tstar)) & inp.node_exists
            & (inp.node_count < inp.node_max_tasks))
    dyn = dynamic_predicate_mask(cfg, tstar, inp.task_ports,
                                 inp.task_aff_req, inp.task_anti,
                                 inp.node_ports, inp.node_selcnt)
    if dyn is not None:
        feas = feas & dyn
    adm = scatter_add(torch.zeros((nb,), dtype=i32, device=dev), vic_node,
                      other.to(i32)) > 0
    elig = feas & covers & adm
    did = qmask.any() & jmask.any() & elig.any()
    nstar = torch.argmax(elig.to(i32)).to(i32)

    # Victims: slot-order prefix of n*'s other-queue residents until
    # the cumulative sum covers, INCLUSIVE of the covering victim (the
    # evict loop breaks after adding, reclaim.py:144-155).
    eln = other & (vic_node == nstar)
    contrib = torch.where(eln[:, None], vic_res, zero_res)
    csum = torch.cumsum(contrib, dim=0, dtype=i32)
    before = less_equal_vec(treq[None, :].expand(csum.shape),
                            csum - contrib, inp.eps, inp.scalar_dims)
    chosen = eln & ~before & did
    vcnt = chosen.sum().to(i32)
    d = did.to(i32)

    # Deltas.  Evict (release_resident): node releasing += resreq, the
    # victim queue's proportion allocation and the victim job's DRF
    # allocation / ready count shrink.  Pipeline of t* on n* (add_task
    # Pipelined + allocate event): releasing -= resreq, used += resreq,
    # count += 1, ports/selcnt gain t*'s footprint, q*'s proportion
    # allocation grows; the job block re-sorts with t* consumed.
    chv = torch.where(chosen[:, None], vic_res, zero_res)
    vq = torch.where(chosen, vic_queue, torch.full_like(vic_queue, qb))
    vj = torch.where(chosen, vic_job, torch.full_like(vic_job, jb))
    tres = row(inp.task_res, tstar) * d
    n1 = nstar.long()[None]
    node_rel = scatter_add(inp.node_releasing, vic_node, chv)
    node_rel = node_rel.index_add(0, n1, -tres[None])
    node_used = inp.node_used.index_add(0, n1, tres[None])
    node_count = inp.node_count.index_add(0, n1, d[None])
    node_ports = inp.node_ports.index_copy(
        0, n1, (inp.node_ports[n1] | (did & row(inp.task_ports, tstar))))
    node_sel = inp.node_selcnt.index_add(0, n1, torch.where(
        did, row(inp.task_match, tstar).to(inp.node_selcnt.dtype),
        torch.zeros_like(inp.node_selcnt[0]))[None])
    q_at = torch.where(did, qstar, torch.full_like(qstar, qb))[None]
    j_at = torch.where(did, jstar, torch.full_like(jstar, jb))[None]
    if cfg.has_proportion:
        q_alloc = scatter_add(inp.queue_init_alloc, vq, -chv)
        q_alloc = scatter_add(q_alloc, q_at, tres[None])
    else:
        q_alloc = inp.queue_init_alloc  # stays zeros host-side too
    j_alloc = scatter_add(inp.job_init_alloc, vj, -chv)
    j_ready = scatter_add(inp.job_init_ready, vj, -chosen.to(i32))
    one = torch.ones((1,), dtype=inp.job_start.dtype, device=dev)
    j_start = scatter_add(inp.job_start, j_at, one)
    j_count = scatter_add(inp.job_count, j_at, -one)

    adj = inp._replace(
        node_releasing=node_rel, node_used=node_used,
        node_count=node_count, node_ports=node_ports,
        node_selcnt=node_sel, queue_init_alloc=q_alloc,
        job_init_alloc=j_alloc, job_init_ready=j_ready,
        job_start=j_start, job_count=j_count)
    meta = torch.stack([d, qstar, jstar, tstar, nstar, vcnt]).to(i32)
    return adj, meta, chosen


def _fused_program(legs, acfg, has_cand, ainp, cand, cand_idx,
                   cand_valid, cand_remap, amesh, ecfg, r, np_pad, ns_pad,
                   statics, edyn, eresident, trows, vic_node, vic_rank,
                   box, sx, sy, sz, tmesh, pe_res, pe_queue,
                   pe_job) -> dict:
    """Enqueue every staged leg on the current stream, each followed by
    its pinned readback and event (ops/solver.to_host_async); returns
    the legs' host handles without waiting.  The alloc leg's handle is a
    PendingSolve in the in-flight ledger, exactly as ``dispatch_solve``
    builds it; the others are ``(host tensors..., event)``.  A leg with a
    mesh (``amesh``, ``eresident`` in the mesh layout, ``tmesh``) takes
    its sharded route."""
    from .solver import to_host_async
    out = {}
    if "topo" in legs:
        from .topo_solver import box_scan, box_scan_sharded
        stats = (box_scan_sharded(box, sx, sy, sz, tmesh)
                 if tmesh is not None else box_scan(box, sx, sy, sz))
        (stats,), ready = to_host_async(stats)
        out["topo"] = (stats, ready)
    if "evict" in legs:
        from .evict_solver import choose_evict_route, evict_batch_solve
        if eresident is not None:
            # The sharded batch solve reads the resident node leaves in
            # place; no chaos site here (the fused dispatch has its own).
            from ..parallel.sharded_scan import evict_batch_solve_sharded
            emesh = choose_evict_route(eresident)[1]
            pair = evict_batch_solve_sharded(
                ecfg, r, np_pad, ns_pad, statics, eresident.node_used,
                eresident.node_count, eresident.node_ports,
                eresident.node_selcnt, trows, vic_node, vic_rank, emesh)
            timing = None
        else:
            from .cuda_solver import EvictTiming
            timing = EvictTiming.around(edyn.device)
            pair = evict_batch_solve(ecfg, r, np_pad, ns_pad, statics, edyn,
                                     trows, vic_node, vic_rank)
            if timing is not None:
                timing.launched()
        (scores, perm), ready = to_host_async(*pair)
        out["evict"] = (scores, perm, ready, timing)
    if "solve" in legs:
        from .solver import (_gather_candidate_inputs, packed_host,
                             pending_of, solve_on_route)
        host = packed_host(ainp)
        sinp = ainp
        if "postevict" in legs:
            # Storm half: the predicted first reclaim iteration's
            # occupancy update, and the solve against the ADJUSTED
            # state.  Never staged with a candidate gather.  On the
            # mesh the adjustment runs on the gathered node state and
            # its result is split back into the mesh layout.
            from ..parallel.mesh import gathered, shard_solver_inputs
            sinp, pe_meta, pe_sel = _postevict_adjust(
                gathered(ainp), acfg, vic_node, pe_res, pe_queue, pe_job)
            if amesh is not None:
                sinp = shard_solver_inputs(sinp, amesh)
            (meta, sel), ready = to_host_async(pe_meta, pe_sel)
            out["postevict"] = (meta, sel, ready)
        if has_cand and amesh is not None:
            from ..parallel.sharded_solver import gather_candidate_sharded
            sinp = gather_candidate_sharded(ainp, cand.local_idx,
                                            cand.local_valid, amesh)
        elif has_cand:
            sinp = _gather_candidate_inputs(ainp, cand_idx, cand_valid)
        res = solve_on_route(sinp, acfg)
        out["alloc"] = pending_of(res, cand_remap, host)
    return out


def fused_solve_key(legs, aroute, has_cand, cand_rows, a_shape,
                    eroute, e_shape, troute, t_shape) -> tuple:
    """Compile-cache identity of one fused program: the static leg set
    plus each present leg's degrees of freedom (the per-family
    solve_key/evict_solve_key/topo_solve_key disciplines folded into one
    tuple), noted in ops/compile_cache.py and warmed by its
    ``_warm_fused``."""
    return (FUSED_SOLVE_CHOICE, tuple(legs), aroute, has_cand, cand_rows,
            a_shape, eroute, e_shape, troute, t_shape)


# ---------------------------------------------------------------------------
# Staging: what each leg must prove on the host before riding along.
# ---------------------------------------------------------------------------

def _cand_sig(candidates) -> object:
    """Byte identity of a candidate gather: same remap => same gathered
    program => same placements.  None means the full-bucket program."""
    if candidates is None:
        return None
    remap = candidates.remap
    return (int(candidates.count),
            None if remap is None else remap.tobytes())


def _stage_alloc(ssn, snap, device, dtype) -> Optional[_AllocLeg]:
    """Decide whether the allocate solve can ride the fused dispatch,
    and stage exactly what tpu-allocate's begin half would stage: the
    shipped resident image, the route, and the candidate gather.  Every
    predicate mirrors actions/tpu_allocate.execute_begin so the capture
    is the SAME dispatch that action would have issued — the consume
    check then only has to prove nothing moved in between."""
    if "tpu-allocate" not in _conf_names(ssn):
        return None
    if not knobs.PIPELINE.enabled():
        # The sequential control solves synchronously; a pre-staged
        # async handle would change its timing topology.
        return None
    from ..chaos.breaker import device_breaker
    if not device_breaker().allow():
        return None
    if snap.needs_fallback or not snap.tasks:
        return None
    from ..models import incremental
    from ..models.shipping import resident_shipper
    from .solver import choose_solver_mesh
    shipper = resident_shipper(ssn.cache, device)
    inputs = shipper.ship(snap.inputs, snap.config, dtype)
    inc_state = (incremental.state_for(ssn.cache, create=False)
                 if incremental.incremental_enabled() else None)
    if (inc_state is not None
            and shipper.last_mode == "clean"
            and inc_state.solve_gen == shipper.generation
            and inc_state.solve_cfg == snap.config
            and inc_state.solve_result is not None):
        # The generation-keyed cache already holds this session's
        # answer; tpu-allocate will reuse it without any dispatch.
        return None
    route, mesh = choose_solver_mesh(inputs)
    candidates = None
    if inc_state is not None and inc_state.last_kind == "micro":
        from .prefilter import derive_candidates
        candidates = derive_candidates(snap, route, mesh)
    return _AllocLeg(inputs=inputs, cfg=snap.config, route=route,
                     mesh=mesh, generation=shipper.generation,
                     cand_sig=_cand_sig(candidates), candidates=candidates)


def _stage_storm(ssn, scanner, node_p):
    """Host staging for the postevict leg: the victim detail columns
    (resreq quanta, queue/job snapshot indices) slot-aligned with the
    evict leg's staging and padded to its bucket, plus the per-slot
    uids the serve proof matches the committed victim order against.
    None (leg not staged; the solve ships unadjusted exactly as before)
    when the session's ladder has no reclaim walk to predict, or the
    columns can't be proven (missing snapshot, quanta overflow)."""
    if "reclaim" not in _conf_names(ssn):
        # The prediction models actions/reclaim.py specifically; a
        # preempt/backfill-only ladder would invalidate every clean
        # session against a reclaim-shaped prediction.
        return None
    snap = getattr(scanner, "snap", None)
    if snap is None or snap.needs_fallback:
        return None
    from ..models.victim_index import VictimIndex
    vindex = VictimIndex.for_session(ssn)
    qix_map = {q: i for i, q in enumerate(snap.queue_ids)}
    jix_map = {u: i for i, u in enumerate(snap.job_uids)}
    detail = vindex.victim_detail(scanner.node_index, snap.resource_names,
                                  qix_map, jix_map)
    if detail is None:
        return None
    res, qix, jix = detail
    uids = vindex.victim_tensors(scanner.node_index)[2]
    mb = int(np.asarray(node_p).shape[0])
    m = res.shape[0]
    r = int(snap.inputs.task_req.shape[1])
    if m > mb or res.shape[1] != r:
        return None
    qb = int(snap.inputs.queue_exists.shape[0])
    jb = int(snap.inputs.job_start.shape[0])
    res_p = np.zeros((mb, r), np.int32)
    qix_p = np.full((mb,), qb, np.int32)
    jix_p = np.full((mb,), jb, np.int32)
    if m:
        res_p[:m] = res
        # Sentinel = axis bucket: the device scatter drops them, so
        # victims of axis-absent queues/jobs update nothing — their
        # host twins aren't in the solve universe either.
        qix_p[:m] = np.where(qix >= 0, qix, qb)
        jix_p[:m] = np.where(jix >= 0, jix, jb)
    return res_p, qix_p, jix_p, uids


def _chaos_consume(arr: np.ndarray) -> np.ndarray:
    """Readback fault sites for the fused legs (doc/CHAOS.md):
    ``fused.slow`` sleeps before the transfer is consumed and
    ``fused.poison`` truncates the trailing column — the shape every
    consumer validates before seeding caches.  One no-op branch when
    the chaos engine is off."""
    from ..chaos import plan as chaos_plan
    plan = chaos_plan.PLAN
    if plan is None:
        return arr
    slow = plan.fire("fused.slow")
    if slow is not None:
        time.sleep(0.01 + 0.05 * slow.magnitude)
    if plan.fire("fused.poison") and arr.ndim >= 2 and arr.shape[-1]:
        return arr[..., :-1]
    return arr


def _fail(ssn, st: FusedState, exc: Exception, families) -> None:
    """Shared degrade path: feed the breaker, invalidate the resident
    image (the fused program may have died mid-write), count the
    failure, and let every family re-dispatch on its own device."""
    from ..chaos.breaker import feed_failure
    from ..metrics import metrics
    st.failed = True
    st.alloc_pending = None
    st.alloc_leg = None
    st.topo_out = None
    storm = getattr(st, "storm", None)
    if storm is not None:
        st.storm = None
        ssn._fused_mutlog = None
        storm.release()
    for fam in families:
        metrics.note_fused_leg(fam, "failed")
    feed_failure("fused",
                 f"fused dispatch failed ({type(exc).__name__}); per-family "
                 "re-dispatch", exc, owner=ssn.cache,
                 what="the fused session dispatch")


# ---------------------------------------------------------------------------
# Consumers.
# ---------------------------------------------------------------------------

def take_evict(ssn, scanner, trows, node_p, rank_p):
    """The fused dispatch point, called from scanner.batch_seed with the
    eviction staging fully derived.  Stages every other leg the session
    can prove out (alloc from the scanner's own snapshot; topo if
    actions/topo_allocate.py staged a request) and enqueues the ONE
    program.  Returns the evict leg's host handles (scores, perm,
    event) — the scanner defers the readback to its first consumer — or
    None, in which case batch_seed dispatches per family."""
    if not fused_enabled():
        return None
    st = state_for(ssn)
    if st.dispatched or st.failed:
        return None
    from ..metrics import metrics
    from ..trace import spans as trace

    # The evict leg runs on the scanner's device, or over the mesh of its
    # resident image (eroute "sharded", reading its node leaves in place).
    from .evict_solver import choose_evict_route
    device = scanner.device
    dtype = scanner.dtype
    eroute, _emesh = choose_evict_route(scanner._resident)
    legs = ["evict"]
    alloc = None
    try:
        alloc = _stage_alloc(ssn, scanner.snap, device, dtype)
    except Exception:  # lint: allow-swallow(a leg that cannot be staged rides no fused program; tpu-allocate dispatches it per family; counted)
        metrics.note_swallowed("fused_stage_alloc")
        alloc = None
    if alloc is not None:
        legs.append("solve")
    storm = None
    if (alloc is not None and alloc.candidates is None
            and knobs.FUSED_STORM.enabled()):
        try:
            storm = _stage_storm(ssn, scanner, node_p)
        except Exception:  # lint: allow-swallow(an unstageable storm leg leaves the plain alloc leg; counted)
            metrics.note_swallowed("fused_stage_storm")
            storm = None
    if storm is not None:
        legs.append("postevict")
    topo = st.topo_request
    troute, tmesh = "torch", None
    if topo is not None:
        from .topo_solver import choose_topo_route
        troute, tmesh = choose_topo_route(int(topo[0].coords.shape[0]))
        legs.append("topo")
    legs = tuple(legs)

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)

    has_cand = alloc is not None and alloc.candidates is not None
    cand_idx = cand_valid = cand_remap = None
    if has_cand:
        c = alloc.candidates
        if not c.sharded:
            cand_idx = dev(c.idx).long()
            cand_valid = dev(c.valid)
        cand_remap = c.remap
    pe_res = pe_queue = pe_job = None
    if storm is not None:
        pe_res, pe_queue, pe_job = (dev(a) for a in storm[:3])
    sx = sy = sz = 0
    box = None
    if topo is not None:
        from .topo_solver import stage_box_inputs
        sx, sy, sz = topo[1]
        box = stage_box_inputs(topo[0], device)

    start = time.time()
    try:
        from ..chaos import plan as chaos_plan
        plan = chaos_plan.PLAN
        if plan is not None and plan.fire("fused.device_error"):
            raise RuntimeError("chaos: fused session dispatch failed "
                               "(injected)")
        with trace.span("fused.dispatch", legs=",".join(legs)):
            out = _fused_program(
                legs, alloc.cfg if alloc is not None else None, has_cand,
                alloc.inputs if alloc is not None else None,
                alloc.candidates if alloc is not None else None, cand_idx,
                cand_valid, cand_remap,
                alloc.mesh if alloc is not None else None, scanner.cfg,
                scanner.r, scanner.np_pad, scanner.ns_pad, scanner.statics,
                None if eroute == "sharded" else dev(scanner.dyn),
                scanner._resident if eroute == "sharded" else None,
                dev(trows), dev(node_p), dev(rank_p), box, sx, sy, sz, tmesh,
                pe_res, pe_queue, pe_job)
    except Exception as exc:
        _fail(ssn, st, exc, legs)
        return None

    st.dispatched = True
    st.legs = legs
    metrics.note_session_dispatch("fused")
    metrics.note_route("fused", "+".join(sorted(legs)))
    from .compile_cache import note_solve_key
    note_solve_key(fused_solve_key(
        legs,
        (alloc.route if alloc is not None
         else ("cuda" if device.type == "cuda" else "torch")),
        has_cand,
        (int(cand_remap.shape[0] if cand_remap is not None
             else alloc.candidates.count) if has_cand else 0),
        (None if alloc is None
         else (int(alloc.inputs.node_idle.shape[0]), alloc.cfg)),
        eroute,
        (scanner.cfg, scanner.r, scanner.np_pad, scanner.ns_pad,
         int(np.asarray(trows).shape[0]), int(np.asarray(node_p).shape[0])),
        troute, (int(sx), int(sy), int(sz))))
    metrics.set_cycle_floor("fused", time.time() - start)
    trace.annotate(fused_legs=",".join(legs))

    if alloc is not None:
        st.alloc_leg = alloc
        st.alloc_pending = out["alloc"]
        if storm is not None:
            meta, sel, ready = out["postevict"]
            cap = _StormCapture(
                snap=scanner.snap, route=alloc.route,
                vic_res=storm[0], vic_qix=storm[1], vic_jix=storm[2],
                vic_node=np.array(np.asarray(node_p)), uids=storm[3],
                meta=meta, sel=sel, ready=ready)
            st.storm = cap
            # Arm the session mutation log: the serve proof replays the
            # committed evict/pipeline sequence against the device's
            # predicted iteration (framework/session.py hooks).
            ssn._fused_mutlog = cap.mutlog
    if topo is not None:
        st.topo_out = out["topo"]
        st.topo_sig = topo[2]
    return out["evict"]


def consume_evict(scores, perm, ready, kb: int, n_pad: int):
    """Host readback of the deferred evict leg after its event, with the
    fused chaos seams applied and the poisoned-shape check every seeded
    row depends on.  Raises on any fault."""
    if ready is not None:
        ready.synchronize()
    packed = _chaos_consume(scores.numpy())
    if packed.shape != (kb, n_pad):
        raise RuntimeError(
            f"fused evict readback shape {packed.shape} != ({kb}, {n_pad})")
    return packed.astype(np.int64), perm.numpy().copy()


def take_alloc(ssn, shipper, snap, route, candidates):
    """tpu-allocate's consume point.

    Quiet half: the precomputed solve is THIS session's solve iff the
    action's own ship came back CLEAN at the dispatch generation with
    the same config, route and candidate gather.

    Storm half (doc/FUSED.md): when the dispatch carried a postevict
    leg, a DIRTY ship can still serve — iff the committed mutations are
    bit-identical to the device's predicted reclaim iteration and the
    fresh staging equals the dispatch staging plus the modeled deltas
    (``_prove_storm``).  The served packed result is the adjusted solve
    remapped onto the fresh task axis; any divergence discards the leg
    and re-dispatches per-family, counted under family="postevict".

    Returns the PendingSolve (the action's finish continuation fetches
    it through the standard path) or None for the per-family dispatch."""
    st = getattr(ssn, "_fused_state", None)
    if st is None or st.alloc_pending is None:
        return None
    from ..metrics import metrics
    from .solver import discard_solve
    pending, leg = st.alloc_pending, st.alloc_leg
    st.alloc_pending = None
    st.alloc_leg = None
    storm = getattr(st, "storm", None)
    st.storm = None
    if storm is not None:
        ssn._fused_mutlog = None
    ok = (shipper.last_mode == "clean"
          and shipper.generation == leg.generation
          and snap.config == leg.cfg
          and route == leg.route
          and _cand_sig(candidates) == leg.cand_sig)
    if storm is None:
        if not ok:
            discard_solve(pending)
            metrics.note_fused_leg("solve", "invalidated")
            return None
        metrics.note_fused_leg("solve", "served")
        return pending

    from ..chaos import plan as chaos_plan
    plan = chaos_plan.PLAN
    poison = plan is not None and plan.fire("fused.postevict_poison")
    served = None
    family = "postevict"
    try:
        if ok:
            # Clean ship at the dispatch generation: nothing mutated,
            # so the leg is valid iff the device ALSO predicted a quiet
            # session — then the adjustment was the identity and the
            # packed result IS the plain fused solve (counted under the
            # plain family).  A clean session with a non-identity
            # prediction is a model divergence: discard.
            meta, _sel = storm.prediction()
            if (int(meta[0]) == 0 and int(meta[5]) == 0
                    and not storm.mutlog):
                served, family = pending, "solve"
        else:
            served = _prove_storm(storm, snap, route, candidates, pending)
    except Exception:  # lint: allow-swallow(an unprovable storm leg re-dispatches per family, decisions unchanged; counted)
        metrics.note_swallowed("fused_storm_prove")
        served = None
    storm.release()
    if served is None:
        discard_solve(pending)
        metrics.note_fused_leg("postevict", "invalidated")
        return None
    if poison:
        # Chaos site fused.postevict_poison (doc/CHAOS.md): a malformed
        # served leg must die in tpu-allocate's _validate_result before
        # any apply.
        from .solver import PendingSolve
        if served.ready is not None:
            served.ready.synchronize()
        packed = served.packed
        if packed.ndim >= 2 and packed.shape[-1]:
            served = PendingSolve(packed[..., :-1].contiguous(), None,
                                  served.remap, served.timing)
    metrics.note_fused_leg(family, "served")
    return served


def _prove_storm(storm, snap, route, candidates, pending):
    """The storm serve proof (doc/FUSED.md "Storm half"): serve ONLY
    when the host's committed mutation log bit-matches the device's
    predicted iteration (P1: victim uid sequence in slot order; P2: the
    single pipeline of t* onto n*) AND the fresh staging equals the
    dispatch staging plus the modeled deltas on every mutated axis (P3)
    with the fresh task universe exactly the dispatch universe minus t*
    (P4).  Then the device's adjusted solve IS the solve the per-family
    re-dispatch would run, and the packed result remapped onto the
    fresh task axis is served.  Returns the remapped PendingSolve or
    None (per-family re-dispatch).  Host numpy, after the legs' events."""
    if route != storm.route or candidates is not None:
        return None
    dinp = storm.dinp
    if not dinp or snap.needs_fallback:
        return None
    if snap.config != storm.dconfig:
        return None
    if (list(snap.node_names) != storm.dnode_names
            or list(snap.job_uids) != storm.djob_uids
            or list(snap.queue_ids) != storm.dqueue_ids
            or list(snap.resource_names) != storm.dres_names):
        return None
    meta, sel = storm.prediction()
    sel = sel.astype(bool)
    did, qstar, jstar, tstar, nstar, vcnt = (int(v) for v in meta[:6])
    if did != 1 or vcnt < 0:
        return None
    slots = np.nonzero(sel)[0]
    if slots.size != vcnt or (slots.size
                              and int(slots[-1]) >= len(storm.uids)):
        return None
    if tstar >= len(storm.duids) or nstar >= len(storm.dnode_names):
        return None

    # P1 + P2 — the committed log is EXACTLY the predicted iteration.
    log = list(storm.mutlog)
    if len(log) != vcnt + 1:
        return None
    for i in range(vcnt):
        kind, uid, _node = log[i]
        if kind != "evict" or uid != storm.uids[int(slots[i])]:
            return None
    kind, uid, node = log[-1]
    if (kind != "pipeline" or uid != storm.duids[tstar]
            or node != storm.dnode_names[nstar]):
        return None

    finp = snap.inputs
    npa = np.asarray

    # P4 — fresh task universe == dispatch minus t*, per-job order kept.
    if len(snap.tasks) != len(storm.duids) - 1:
        return None
    drow = {uid: i for i, uid in enumerate(storm.duids)}
    remap = np.empty(len(snap.tasks), np.int64)
    for f, t in enumerate(snap.tasks):
        dr = drow.get(t.uid)
        if dr is None or dr == tstar:
            return None
        remap[f] = dr
    fstart, fcount = npa(finp.job_start), npa(finp.job_count)
    dstart, dcount = dinp["job_start"], dinp["job_count"]
    if fstart.shape != dstart.shape or jstar >= dcount.shape[0]:
        return None
    adjc = np.zeros_like(dcount)
    adjc[jstar] = 1
    if not np.array_equal(fcount, dcount - adjc):
        return None
    fsorted, dsorted = npa(finp.task_sorted), dinp["task_sorted"]
    if int(dsorted[int(dstart[jstar])]) != tstar:
        return None
    jobs = np.nonzero(fcount > 0)[0]
    reps = fcount[jobs].astype(np.int64)
    total = int(reps.sum())
    if total != len(snap.tasks):
        return None
    if total:
        jrep = np.repeat(jobs, reps)
        within = (np.arange(total, dtype=np.int64)
                  - np.repeat(np.cumsum(reps) - reps, reps))
        fpos = fstart[jrep].astype(np.int64) + within
        dpos = (dstart[jrep].astype(np.int64)
                + (jrep == jstar).astype(np.int64) + within)
        frows = fsorted[fpos]
        if frows.size and int(frows.max()) >= remap.shape[0]:
            return None
        if not np.array_equal(remap[frows], dsorted[dpos]):
            return None

    # P4 — per-task columns equal under the uid remap; sig tables and
    # every axis the iteration cannot touch bit-equal.
    rows = np.arange(len(snap.tasks), dtype=np.int64)
    for name in ("task_req", "task_res", "task_sig", "task_ports",
                 "task_aff_req", "task_anti", "task_match",
                 "task_paff_w", "task_panti_w"):
        fa, da = npa(getattr(finp, name)), dinp[name]
        if fa.shape[1:] != da.shape[1:] or fa.shape[0] < len(snap.tasks):
            return None
        if not np.array_equal(fa[rows], da[remap]):
            return None
    for name in ("sig_mask", "sig_bonus", "node_idle", "node_alloc",
                 "node_max_tasks", "node_exists", "node_coords",
                 "queue_deserved", "queue_deserved_f", "queue_ts",
                 "queue_uid_rank", "queue_exists", "job_queue",
                 "job_minavail", "job_prio", "job_ts", "job_uid_rank",
                 "total_res", "eps", "scalar_dims", "score_shift"):
        fa, da = npa(getattr(finp, name)), dinp[name]
        if fa.shape != da.shape or not np.array_equal(fa, da):
            return None

    # P3 — fresh mutated axes == dispatch + modeled deltas (int64
    # intermediates; int32 staging can't overflow them).
    i64 = np.int64
    tres = dinp["task_res"][tstar].astype(i64)
    vres = storm.vic_res[slots].astype(i64)
    vnode = storm.vic_node[slots].astype(i64)
    if slots.size and not np.all(vnode == nstar):
        return None
    exp = dinp["node_releasing"].astype(i64)
    np.add.at(exp, vnode, vres)
    exp[nstar] -= tres
    if not np.array_equal(npa(finp.node_releasing).astype(i64), exp):
        return None
    exp = dinp["node_used"].astype(i64)
    exp[nstar] += tres
    if not np.array_equal(npa(finp.node_used).astype(i64), exp):
        return None
    exp = dinp["node_count"].astype(i64)
    exp[nstar] += 1
    if not np.array_equal(npa(finp.node_count).astype(i64), exp):
        return None
    expp = dinp["node_ports"].copy()
    expp[nstar] = expp[nstar] | dinp["task_ports"][tstar]
    if not np.array_equal(npa(finp.node_ports), expp):
        return None
    exp = dinp["node_selcnt"].astype(i64)
    exp[nstar] += dinp["task_match"][tstar].astype(i64)
    if not np.array_equal(npa(finp.node_selcnt).astype(i64), exp):
        return None
    qb = dinp["queue_init_alloc"].shape[0]
    jb = dinp["job_init_alloc"].shape[0]
    if qstar >= qb:
        return None
    if snap.config.has_proportion:
        exp = dinp["queue_init_alloc"].astype(i64)
        vq = storm.vic_qix[slots].astype(i64)
        keep = vq < qb
        np.subtract.at(exp, vq[keep], vres[keep])
        exp[qstar] += tres
        if not np.array_equal(npa(finp.queue_init_alloc).astype(i64),
                              exp):
            return None
    elif not np.array_equal(npa(finp.queue_init_alloc),
                            dinp["queue_init_alloc"]):
        return None
    vj = storm.vic_jix[slots].astype(i64)
    keepj = vj < jb
    exp = dinp["job_init_alloc"].astype(i64)
    np.subtract.at(exp, vj[keepj], vres[keepj])
    if not np.array_equal(npa(finp.job_init_alloc).astype(i64), exp):
        return None
    exp = dinp["job_init_ready"].astype(i64)
    np.subtract.at(exp, vj[keepj], 1)
    if not np.array_equal(npa(finp.job_init_ready).astype(i64), exp):
        return None

    # Serve: remap the packed adjusted solve onto the fresh task axis.
    # Fresh real row f held dispatch row remap[f]; extras (BestEffort)
    # and padding rows stay unplaced, exactly as a fresh solve leaves
    # them.  The perm rebuild is _pack_result_ordered's argsort over
    # the same (placed, order) keys, so the fetch path decodes the
    # served leg exactly like a per-family readback.
    from .solver import PendingSolve
    if pending.ready is not None:
        pending.ready.synchronize()
    packed = pending.packed.numpy()
    if packed.ndim != 2 or packed.shape[0] != 4:
        return None
    if remap.size and int(remap.max()) >= packed.shape[1]:
        return None
    pf = int(finp.task_req.shape[0])
    a_f = np.zeros((pf,), np.int32)
    k_f = np.zeros((pf,), np.int32)
    o_f = np.zeros((pf,), np.int32)
    a_f[rows] = packed[0][remap]
    k_f[rows] = packed[1][remap]
    o_f[rows] = packed[2][remap]
    if int((packed[1] > 0).sum()) != int((k_f > 0).sum()):
        return None  # the device placed a row outside the fresh universe
    key = np.where(k_f > 0, o_f.astype(np.int64),
                   np.iinfo(np.int32).max)
    perm_f = np.argsort(key, kind="stable").astype(np.int32)
    out = np.ascontiguousarray(np.stack([a_f, k_f, o_f, perm_f]))
    # K1's timing rides on: the fetch records the served launch's span.
    return PendingSolve(torch.from_numpy(out), None, None, pending.timing)


def take_topo(ssn, inp, shape, n: int, device, dtype):
    """actions/topo_allocate's chokepoint, wired around dispatch_box_scan.

    First call in a session STAGES the scan and — when the conf carries
    an eviction action — triggers the shared scanner build (on the
    action's ``device``, tensorized with ``dtype``) so the fused dispatch
    serves all three families from one program.  Returns the host
    [n, 6] stats when the staged leg matches this exact request (same
    arrays, same shape), else None for the per-family dispatch."""
    if not fused_enabled():
        return None
    st = state_for(ssn)
    if st.failed:
        return None
    from ..metrics import metrics
    sig = (tuple(int(v) for v in shape),
           b"".join(np.ascontiguousarray(a).tobytes() for a in inp))
    if not st.dispatched and st.topo_request is None:
        st.topo_request = (inp, tuple(int(v) for v in shape), sig)
        names = _conf_names(ssn)
        if {"reclaim", "preempt", "backfill"} & set(names):
            from ..models.scanner import batch_evict_enabled, \
                maybe_shared_scanner
            if batch_evict_enabled():
                st.early_scanner = True
                try:
                    # batch_seed -> take_evict
                    sc = maybe_shared_scanner(ssn, device, dtype)
                    if sc is not None:
                        # Seeded BEFORE this session's mutating actions:
                        # refresh drops the victim ranking on the first
                        # mutation so the walk replays the exact queue.
                        sc._fused_early = True
                except Exception:  # lint: allow-swallow(an early scanner that cannot build leaves the per-family scan; the eviction action rebuilds its own; counted)
                    metrics.note_swallowed("fused_topo_scanner")
        if not st.dispatched:
            st.topo_request = None  # nothing fused it; per-family path
            return None
    if not st.dispatched or st.topo_out is None:
        return None
    if sig != st.topo_sig:
        metrics.note_fused_leg("topo", "invalidated")
        return None
    try:
        host, ready = st.topo_out
        if ready is not None:
            ready.synchronize()
        stats = _chaos_consume(host.numpy())
        if stats.ndim != 2 or stats.shape[1] != 6 or stats.shape[0] < n:
            raise RuntimeError(
                f"fused topo readback shape {stats.shape} (need >= "
                f"({n}, 6))")
    except Exception as exc:
        _fail(ssn, st, exc, ("topo",))
        return None
    metrics.note_fused_leg("topo", "served")
    return stats[:n]


def flush_deferred(ssn) -> None:
    """Flush commit sinks the action-commit scope deferred into the
    fused dispatch window (framework/commit.py): tpu-allocate's finish
    calls this FIRST — before fetching the device result — so the
    cluster egress overlaps the device wait and evict events still
    precede the session's binds on every path (served, invalidated,
    fallback).  close_session's finalize is the safety net when the
    consume never ran."""
    sinks = getattr(ssn, "_deferred_flush", None)
    if not sinks:
        return
    ssn._deferred_flush = []
    for sink in sinks:
        sink.flush()


def finalize_session(ssn) -> None:
    """Ledger hygiene at session close/abandon: flush any commit sinks
    still deferred into a dispatch window nobody reached, release the
    storm capture, and retire an unconsumed alloc leg's in-flight
    dispatch handle (incremental cache answered first, fallback path,
    stale abort)."""
    flush_deferred(ssn)
    st = getattr(ssn, "_fused_state", None)
    if st is None:
        return
    storm = getattr(st, "storm", None)
    if storm is not None:
        st.storm = None
        ssn._fused_mutlog = None
        storm.release()
    if st.alloc_pending is None:
        return
    from ..metrics import metrics
    from .solver import discard_solve
    pending, st.alloc_pending, st.alloc_leg = st.alloc_pending, None, None
    discard_solve(pending)
    metrics.note_fused_leg("solve", "unused")
