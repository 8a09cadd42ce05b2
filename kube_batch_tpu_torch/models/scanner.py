"""DeviceNodeScanner: device-accelerated node walks for preempt/reclaim
(kube_batch_tpu/models/scanner.py).

Tensorizes the session once at action start, then answers each pending
task's candidate-node question (predicates + scores over ALL nodes) with a
single device call (ops/scan.py), replacing the per-node Python predicate/
prioritizer loops (reference util/scheduler_helper.go's 16-goroutine
fan-out).  Mutable node state lives in numpy mirrors updated per
evict/pipeline — O(1) row updates — with checkpoint/restore mirroring the
Statement's commit/discard transaction.

The scanner only accelerates; decisions (victim chains, Statement
semantics, gang commit conditions) stay on the host action.  Sessions the
tensorizer can't express (``snap.needs_fallback``) run the pure-host
walk, as in the reference.  A device FAILURE — the scanner's tensorize,
the batched eviction dispatch, or the fused evict leg's readback —
feeds the shared device breaker (chaos/breaker.feed_failure).  On the
CPU it then degrades to the host walk or to per-profile host scoring, as
in the reference (decisions are identical, the batching only
accelerates); on a CUDA device it raises ``DeviceFailure``, as does an
open breaker, so no card work moves to numpy.

The scanner owns a device (CUDA unless the caller asks for the CPU) and
the float key dtype of its tensorize, both threaded in from the eviction
actions' registration.  Every device-to-host readback is a copy, so the
no-retain/no-mutate contract of ``scores()`` holds on the CPU too.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import knobs
from ..api import TaskInfo
from ..device import resolve_device
from ..ops.resources import quantize_value
from ..ops.scan import ScanStatics, best_scan_nodes
from ..ops.scoring import SCORE_NEG_INF

# Node counts below this are cheaper as the plain per-node object walk
# than tensorizing at all; tests set 0 to force the scanner.
SCAN_MIN_NODES_ENV = knobs.SCAN_MIN_NODES.env
DEFAULT_SCAN_MIN_NODES = knobs.SCAN_MIN_NODES.default
# The scan math is exact int32 either way; numpy wins whenever the
# host<->device round trip exceeds the ~N*40 integer ops of one profile's
# scan.  Set =1 to run the per-profile scan on the device.
SCAN_DEVICE_ENV = knobs.SCAN_DEVICE.env

# Distinct task profiles whose score vectors stay warm at once; a storm
# interleaves preemptors of a handful of profiles, far under this.
_SCORE_CACHE_CAP = 64
# =1 makes scores() return a defensive copy instead of the live cached
# view (ADVICE r5 #3 hardened): callers may then retain or mutate freely
# at the cost of one [N] copy per call.  Default off — the fast path's
# no-retain/no-mutate contract is machine-checked by graftlint's
# frozen-after rule instead — and on in tests (tests/conftest.py).
SAFE_SCORES_ENV = knobs.SAFE_SCORES.env
# Batched eviction engine (doc/EVICTION.md): =0 restores the sequential
# control — one scanner per action, one score solve per preemptor, host
# victim sorts — with bit-identical placements and victim choices.
BATCH_EVICT_ENV = knobs.BATCH_EVICT.env
# Whether the batched engine stages its device statics through the
# DeviceResidentShipper (delta against the resident SolverInputs buffer).
# Default auto: on for the card (one delta ship that tpu-allocate then
# reuses beats six leaf transfers), off on the CPU where a ship is just a
# large memcpy that the plain per-leaf copy undercuts.  =1/=0 force.
EVICT_SHIP_ENV = knobs.EVICT_SHIP.env
# Dirty-row patches at or under this many rows take the scalar Python
# scorer (_score_rows_py) instead of numpy: the per-call numpy overhead
# (slicing eight statics, ~20 tiny-array ops) dominates 1-4 row patches,
# which is exactly what one preemptor's statement dirties.
_PY_PATCH_MAX = 8


def batch_evict_enabled() -> bool:
    return knobs.BATCH_EVICT.enabled()


def _shipper_wanted(device: torch.device) -> bool:
    """The reference tests ``jax.default_backend() != "cpu"``; the port
    tests the scanner's device.  Its sharded branch (the mesh-routed
    engine reads sharded resident leaves) waits for ROADMAP queue 1
    item 5."""
    forced = knobs.EVICT_SHIP.tristate()
    if forced is not None:
        return forced
    return device.type != "cpu"


def _build_scanner(ssn, use_shipper: bool = False, device=None,
                   dtype: torch.dtype = torch.float32
                   ) -> Optional["DeviceNodeScanner"]:
    from ..chaos.breaker import device_breaker
    from .tensor_snapshot import tensorize_session
    min_nodes = knobs.SCAN_MIN_NODES.value()
    if len(ssn.nodes) < min_nodes:
        return None
    device = resolve_device(device)
    breaker = device_breaker()
    if not breaker.allow():
        # Device path quarantined (doc/CHAOS.md): on the CPU the
        # eviction actions fall back to the pure-host walk they already
        # support — the scanner only accelerates, it never decides; on
        # the card the action raises.
        from ..chaos.breaker import refuse_open
        refuse_open("the eviction actions", device,
                    "device breaker open: eviction actions ran the host "
                    "walk")
        return None
    try:
        snap = tensorize_session(ssn, dtype)
    except Exception as exc:
        from ..chaos.breaker import feed_failure
        feed_failure("tensorize",
                     f"scanner tensorize failed ({type(exc).__name__}); "
                     "eviction actions ran the host walk", exc,
                     owner=ssn.cache, breaker=breaker,
                     what="the eviction scanner", device=device)
        return None
    if snap.needs_fallback or not (snap.tasks or snap.tasks_extra):
        return None
    device_inputs = None
    if use_shipper and _shipper_wanted(device):
        # Ship the snapshot through the DeviceResidentShipper (a delta
        # against the previous cycle's image on steady clusters): the
        # batched dispatch's statics then come from the already-resident
        # SolverInputs buffer, and tpu-allocate's own ship later this
        # cycle delta-ships against this staging: no extra full ship.
        from .shipping import resident_shipper
        device_inputs = resident_shipper(ssn.cache, device).ship(
            snap.inputs, snap.config, dtype)
    scanner = DeviceNodeScanner(snap, device, device_inputs=device_inputs,
                                dtype=dtype)
    from ..framework.events import EventHandler
    ssn.add_event_handler(EventHandler(
        allocate_func=lambda e: scanner._used_delta(e.task, +1),
        deallocate_func=lambda e: scanner._used_delta(e.task, -1)))
    return scanner


def maybe_shared_scanner(ssn, device=None,
                         dtype: torch.dtype = torch.float32
                         ) -> Optional["DeviceNodeScanner"]:
    """The batched eviction engine's entry point: ONE scanner per
    session, tensorized/seeded at first use (on the first eviction
    action's device) and re-attached (dirty-node refresh) by every later
    eviction action.  Falls back to a fresh per-action scanner when the
    engine is disabled."""
    cached = getattr(ssn, "_shared_scanner", False)
    if cached is not False:
        if cached is not None:
            cached.refresh(ssn)
        return cached
    scanner = _build_scanner(ssn, use_shipper=True, device=device,
                             dtype=dtype)
    ssn._shared_scanner = scanner
    if scanner is not None:
        scanner.batch_seed(ssn)
    return scanner


def maybe_scanner(ssn, shared: bool = False, device=None,
                  dtype: torch.dtype = torch.float32
                  ) -> Optional["DeviceNodeScanner"]:
    """Build a scanner for the session, or None (fallback to host walk).
    Registers session event handlers so the scoring mirror tracks every
    allocate/deallocate — including Statement rollback and the
    commit-failure unevict path — exactly as nodeorder's GridUsage does.

    ``shared``: under the batched eviction engine the reclaim, backfill
    and preempt actions reuse ONE session scanner instead of
    re-tensorizing per action.  The reuse is exact: node membership is
    fixed for the session, node STATIC state (labels, taints,
    allocatable — the [S, N] mask inputs) is never session-mutated, and
    ``refresh`` re-derives the dynamic rows of every session-mutated
    node from live truth at attach time, which is precisely what a fresh
    tensorize would stage for them (Session.mutated_nodes is complete by
    the delta-shipping contract, framework/session.py).

    ``device`` (CUDA unless the caller passes the CPU) and ``dtype`` (the
    float key type of the scanner's tensorize) are the calling action's."""
    if shared and batch_evict_enabled():
        return maybe_shared_scanner(ssn, device, dtype)
    return _build_scanner(ssn, device=device, dtype=dtype)


def _readback(t: torch.Tensor) -> np.ndarray:
    """Device -> host as a writable numpy array that never aliases the
    tensor (``.numpy()`` of a CPU tensor would)."""
    return t.detach().to("cpu", copy=True).numpy()


class DeviceNodeScanner:

    def __init__(self, snap, device=None, device_inputs=None,
                 dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype  # the float key type ``snap`` was tensorized with
        self.snap = snap
        inp = snap.inputs
        self.r = inp.task_req.shape[1]
        self.np_pad = inp.task_ports.shape[1]
        self.ns_pad = inp.task_aff_req.shape[1]
        self.cfg = snap.config
        # ``device_inputs``: the session's SolverInputs as shipped by the
        # DeviceResidentShipper (batched eviction engine) — the statics
        # below then come from the already-device-resident buffer, so
        # building the scanner moves no static bytes over the bus.  The
        # shipper's leaves are views of one flat buffer that a later
        # delta ship in the same scheduling session (tpu-allocate's)
        # rewrites IN PLACE (JAX arrays are immutable, so the reference
        # never meets this): the six statics are cloned on the device
        # now, [S, N] bool and [N, R] int32 at most.  Without it (the
        # sequential control, and the CPU) the ``statics`` property
        # copies the host mirrors to the device at their first device
        # use, so a scanner that only runs the numpy engine ships none.
        self._resident = device_inputs
        self._statics: Optional[ScanStatics] = None
        if device_inputs is not None:
            self._statics = ScanStatics(
                sig_mask=device_inputs.sig_mask.clone(),
                sig_bonus=device_inputs.sig_bonus.clone(),
                node_alloc=device_inputs.node_alloc.clone(),
                node_max_tasks=device_inputs.node_max_tasks.clone(),
                node_exists=device_inputs.node_exists.clone(),
                score_shift=device_inputs.score_shift.clone())
        n_pad = inp.node_idle.shape[0]
        # Packed mutable state: used | count | ports | selcnt (scan.py).
        self.dyn = np.concatenate(
            [np.asarray(inp.node_used),
             np.asarray(inp.node_count)[:, None],
             np.asarray(inp.node_ports).astype(np.int32),
             np.asarray(inp.node_selcnt)], axis=1).astype(np.int32)
        assert self.dyn.shape == (n_pad,
                                  self.r + 1 + self.np_pad + self.ns_pad)
        self.node_index: Dict[str, int] = {
            name: i for i, name in enumerate(snap.node_names)}
        self.task_index: Dict[str, int] = {
            t.uid: i for i, t in enumerate(snap.tasks)}
        # BestEffort rows sit after the candidate range (tensor_snapshot
        # extras): scanner-visible for backfill's predicate sweep.
        for k, t in enumerate(snap.tasks_extra):
            self.task_index[t.uid] = len(snap.tasks) + k
        self._task_ports = np.asarray(inp.task_ports).astype(np.int32)
        self._task_aff = np.asarray(inp.task_aff_req).astype(np.int32)
        self._task_anti = np.asarray(inp.task_anti).astype(np.int32)
        self._task_match = np.asarray(inp.task_match).astype(np.int32)
        self._task_paffw = np.asarray(inp.task_paff_w)
        self._task_pantiw = np.asarray(inp.task_panti_w)
        self._task_res = np.asarray(inp.task_res)
        self._task_sig = np.asarray(inp.task_sig)
        # numpy mirrors of the static node tensors: _scores_numpy runs
        # once per preemptor (thousands per storm) and np.asarray on a
        # device array per call is pure overhead.
        self._np_alloc = np.asarray(inp.node_alloc)
        self._np_sig_mask = np.asarray(inp.sig_mask)
        self._np_exists = np.asarray(inp.node_exists)
        self._np_maxt = np.asarray(inp.node_max_tasks)
        self._np_shift = np.asarray(inp.score_shift)
        self._np_bonus = np.asarray(inp.sig_bonus)
        self._checkpoints: List[Dict[int, np.ndarray]] = []
        # Incremental rescoring: between consecutive scans only the few
        # rows an evict/pipeline touched change, so cache score vectors
        # per task-profile key and recompute just the rows touched since
        # that entry was last current (identical ints to a full
        # recompute — the math is row-pure).  A single-entry cache
        # thrashed when a storm interleaves preemptors of different
        # profiles (every scores() call was a full [N] recompute); the
        # keyed LRU + append-only edit log make the steady state O(rows
        # touched since last seen) per profile.
        self._edit_log: List[int] = []
        self._score_cache: "OrderedDict[tuple, list]" = OrderedDict()
        self._axis = snap.resource_names
        # Batched eviction engine state (doc/EVICTION.md): uid -> position
        # in the precomputed victim order (None until batch_seed ran with
        # the stock task order), and the engine's observability counters
        # (tests + trace assertions read these).
        # Fused-dispatch deferral (ops/fused_solver.py): the evict leg's
        # pinned host readback and its event, parked between the
        # one-dispatch session program and the first consumer —
        # _consume_batch materializes them.
        self._pending_batch = None
        self._fused_early = False  # seeded before mutating actions ran
        self.victim_rank = None
        self._batched = False  # True once batch_seed ran (engine active)
        # The staged host inputs of the last batched dispatch (dyn,
        # trows, victim nodes, victim ranks), so a caller can replay the
        # dispatch on another device and compare (chip_smoke.py does).
        self.last_batch = None
        self.stats = {"batch_dispatches": 0, "seeded_profiles": 0,
                      "dirty_rows_patched": 0, "full_recomputes": 0,
                      "refresh_rows": 0, "refreshes": 0}

    @property
    def statics(self) -> ScanStatics:
        """The six static node tensors on the scanner's device: the
        resident buffer's clones, or the host mirrors copied over at the
        first device use (the batched dispatch, a per-row device scan)."""
        if self._statics is None:
            def dev(a):
                return torch.tensor(a, device=self.device)
            self._statics = ScanStatics(
                sig_mask=dev(self._np_sig_mask),
                sig_bonus=dev(self._np_bonus),
                node_alloc=dev(self._np_alloc),
                node_max_tasks=dev(self._np_maxt),
                node_exists=dev(self._np_exists),
                score_shift=dev(self._np_shift))
        return self._statics

    # -- batched eviction engine (doc/EVICTION.md) --------------------------

    @property
    def victim_rank(self) -> Optional[Dict[str, int]]:
        """uid -> precomputed victim-order position.  A deferred fused
        readback materializes at first touch — consumers (preempt's
        rank lookup) never see the parked readback."""
        self._consume_batch()
        return self._victim_rank

    @victim_rank.setter
    def victim_rank(self, value) -> None:
        self._victim_rank = value

    def _consume_batch(self) -> None:
        """Materialize the fused evict leg (ops/fused_solver.py): ONE
        wait on the leg's event, seeding the score cache exactly as the
        per-family batch_seed would have — keyed at the dispatch-time
        edit-log position, so rows dirtied while the readback was parked
        patch through the normal edit-log path.  A readback fault (chaos
        ``fused.poison``/``fused.slow``, a device error) feeds the shared
        breaker and then, like a dispatch failure, degrades on the CPU
        (caches stay unseeded, every scores() call takes the per-profile
        host path) or raises ``DeviceFailure`` on the card."""
        pb = self._pending_batch
        if pb is None:
            return
        self._pending_batch = None
        from ..metrics import metrics
        from ..ops import fused_solver
        from ..trace import spans as trace
        try:
            with trace.span("fused.evict_consume",
                            profiles=len(pb["keys"])):
                mat, perm = fused_solver.consume_evict(
                    pb["scores"], pb["perm"], pb["ready"], pb["kb"],
                    self.dyn.shape[0])
        except Exception as exc:
            from ..chaos.breaker import feed_failure
            self._batched = False
            self.stats["batch_dispatches"] -= 1
            self.stats["seeded_profiles"] -= len(pb["keys"])
            metrics.note_fused_leg("evict", "failed")
            feed_failure("fused",
                         f"fused evict readback failed "
                         f"({type(exc).__name__}); per-profile host "
                         "scoring", exc, owner=pb["owner"],
                         what="the eviction scanner", device=self.device)
            return
        from ..chaos.breaker import device_breaker
        breaker = device_breaker()
        if not breaker.closed():
            # Same half-open resolution rule as the per-family dispatch:
            # the successful readback IS the recovery evidence.
            breaker.success()
        for i, key in enumerate(pb["keys"]):
            self._score_cache[key] = [mat[i], pb["pos"]]
        if pb["stock_order"]:
            rank_map: Dict[str, int] = {}
            m = pb["m"]
            for p, j in enumerate(perm.tolist()):
                if j < m:
                    rank_map[pb["vic_uids"][j]] = p
            self._victim_rank = rank_map
        metrics.note_fused_leg("evict", "served")

    def _profile_key(self, ti: int) -> tuple:
        return (int(self._task_sig[ti]), self._task_res[ti].tobytes(),
                self._task_ports[ti].tobytes(),
                self._task_aff[ti].tobytes(),
                self._task_anti[ti].tobytes(),
                self._task_paffw[ti].tobytes(),
                self._task_pantiw[ti].tobytes())

    def _profile_trow(self, ti: int) -> np.ndarray:
        return np.concatenate(
            [np.asarray([self._task_sig[ti]], np.int32),
             self._task_res[ti],
             self._task_ports[ti], self._task_aff[ti],
             self._task_anti[ti],
             self._task_paffw[ti], self._task_pantiw[ti]]
        ).astype(np.int32)

    def batch_seed(self, ssn) -> None:
        """ONE device dispatch computing the candidate-node answer for
        every distinct pending-task profile of the session (the whole
        preemptor/reclaimer universe: snap.tasks, plus the BestEffort
        rows backfill sweeps) AND the victim-candidate ranking — seeded
        into the score cache, so the host walk's scores() calls become
        cache hits patched only for rows that went dirty since.

        Parity: the batched kernel vmaps the exact per-row scan body, so
        a seeded row equals what scores() would have computed; seeding
        can therefore never change a placement or victim choice."""
        from ..ops import evict_solver
        from ..ops.compile_cache import bucket
        from ..trace import spans as trace
        from .victim_index import VictimIndex

        n_candidates = len(self.snap.tasks) + len(self.snap.tasks_extra)
        if not n_candidates:
            return
        # Distinct profiles via one vectorized row-dedup over the packed
        # trow matrix (the candidate rows concatenated column-wise —
        # exactly the per-profile trow layout), instead of a per-task
        # Python key loop over a 50k-candidate storm.
        all_rows = np.concatenate(
            [self._task_sig[:n_candidates, None].astype(np.int32),
             self._task_res[:n_candidates].astype(np.int32),
             self._task_ports[:n_candidates],
             self._task_aff[:n_candidates],
             self._task_anti[:n_candidates],
             self._task_paffw[:n_candidates],
             self._task_pantiw[:n_candidates]], axis=1).astype(np.int32)
        _uniq, rep = np.unique(all_rows, axis=0, return_index=True)
        if len(rep) > _SCORE_CACHE_CAP:
            # Profiles beyond the cache cap would be LRU-evicted
            # unconsumed; they fall back to the per-profile path.
            rep = rep[:_SCORE_CACHE_CAP]
        tis = [int(i) for i in rep]
        keys = [self._profile_key(ti) for ti in tis]
        kb = bucket(len(keys))
        trows = np.zeros((kb, 1 + self.r + self.np_pad + 4 * self.ns_pad),
                         np.int32)
        trows[:len(tis)] = all_rows[rep]
        # The precomputed ranking encodes the STOCK victim-order key
        # (priority asc, ts desc, uid desc), which is the host's order
        # only when the ENABLED task-order chain is exactly the priority
        # plugin — enablement, not registration: a conf with
        # `enableTaskOrder: false` leaves the fn registered while
        # victims_queue ignores it (Session.task_sort_key walks the same
        # tier flags).  Anything else keeps victim_rank None and the
        # walk falls back to the exact session queue.
        enabled_order = [p.name for tier in ssn.tiers for p in tier.plugins
                         if p.enabled_task_order
                         and p.name in ssn.task_order_fns]
        stock_order = bool(enabled_order) and set(enabled_order) == {
            "priority"}
        vic_node, vic_rank, vic_uids = VictimIndex.for_session(
            ssn).victim_tensors(self.node_index)
        m = len(vic_uids)
        mb = bucket(max(m, 1))
        node_p = np.full((mb,), self.dyn.shape[0], np.int32)
        rank_p = np.full((mb,), mb, np.int32)
        node_p[:m] = vic_node
        rank_p[:m] = vic_rank
        self.last_batch = (self.dyn.copy(), trows, node_p, rank_p)
        # One-dispatch sessions (ops/fused_solver.py): the fused program
        # serves this eviction staging — plus the allocate solve and any
        # staged topo scan — from ONE enqueue sequence; the readback
        # parks on _pending_batch until the first consumer.  None =>
        # per-family dispatch below, exactly the KUBE_BATCH_TPU_FUSED=0
        # control.
        from ..chaos.breaker import device_breaker
        from ..ops import fused_solver
        dev = self.device
        with trace.span("evict.batch_solve", profiles=len(keys),
                        victims=m, nodes=len(self.snap.node_names)):
            fused = fused_solver.take_evict(ssn, self, trows, node_p,
                                            rank_p)
            if fused is not None:
                self._pending_batch = dict(
                    scores=fused[0], perm=fused[1], ready=fused[2], kb=kb,
                    keys=keys, vic_uids=vic_uids, m=m,
                    stock_order=stock_order, pos=len(self._edit_log),
                    owner=ssn.cache)
                self._batched = True
                self.stats["batch_dispatches"] += 1
                self.stats["seeded_profiles"] += len(keys)
                return
            try:
                scores, perm = evict_solver.dispatch_evict_batch_solve(
                    self.cfg, self.r, self.np_pad, self.ns_pad,
                    self.statics, torch.as_tensor(self.dyn, device=dev),
                    torch.as_tensor(trows, device=dev),
                    torch.as_tensor(node_p, device=dev),
                    torch.as_tensor(rank_p, device=dev))
                mat = _readback(scores).astype(np.int64)
                perm = _readback(perm)
            except Exception as exc:
                # The failure feeds the shared device breaker
                # (doc/CHAOS.md).  On the CPU an unseeded scanner still
                # answers every scores() call through the per-profile
                # host path and the victim order falls back to the exact
                # session queue — decisions identical, the batching is
                # only an accelerator.  On the card it raises.
                from ..chaos.breaker import feed_failure
                feed_failure("evict_solve",
                             f"batched eviction solve failed "
                             f"({type(exc).__name__}); per-profile host "
                             "scoring", exc, owner=ssn.cache,
                             what="the eviction scanner", device=dev)
                return
        breaker = device_breaker()
        if not breaker.closed():
            # Resolve a half-open probe: this dispatch IS the recovery
            # evidence.  A success while CLOSED is deliberately not
            # recorded — it would reset the consecutive-failure count
            # the allocate solve is accumulating in the same cycles, and
            # a small evict solve succeeding must not mask an allocate
            # solve that errors or overruns its deadline every session.
            breaker.success()
        # The reference notes evict_solve_key in its compile cache here;
        # the port's warmup ledger comes with ROADMAP queue 1 item 8.
        pos = len(self._edit_log)
        for i, key in enumerate(keys):
            self._score_cache[key] = [mat[i], pos]
        if stock_order:
            # perm orders residents (node asc, victim order); a victim
            # list sorted by global position is therefore in exactly the
            # order victims_queue would drain (uids make the key total,
            # and victims always share one node per walk step).
            rank_map: Dict[str, int] = {}
            for p, j in enumerate(perm.tolist()):
                if j < m:
                    rank_map[vic_uids[j]] = p
            self.victim_rank = rank_map
        self._batched = True
        self.stats["batch_dispatches"] += 1
        self.stats["seeded_profiles"] += len(keys)

    def refresh(self, ssn) -> None:
        """Re-derive the dynamic row of every session-mutated node from
        live truth — the batched engine's dirty-node invalidation.  Run
        at action attach (between actions, so no Statement transaction
        is open): a recomputed row is exactly what a fresh tensorize
        would stage for that node (same quantization, same membership
        walk), and untouched nodes cannot have drifted (every session
        mutation path routes through Session._dirty_node), so after
        refresh the shared scanner's dyn equals the per-action rebuild
        the sequential control pays."""
        from ..trace import spans as trace
        from .tensor_snapshot import stage_node_dyn_row

        if self._checkpoints:
            raise RuntimeError(
                "scanner.refresh inside an open transaction (checkpoint "
                "frames present) — attach must happen between actions")
        self._consume_batch()
        names = sorted(n for n in ssn.mutated_nodes if n in self.node_index)
        if names and self._fused_early:
            # Early-seeded scanner (fused topo-first build): the victim
            # ranking was computed BEFORE this session's mutations, so
            # residents placed since are missing from the map.  Drop it —
            # the walk falls back to the exact session victim queue,
            # which is bit-identical by the batch_seed parity contract.
            self._victim_rank = None
        self.stats["refreshes"] += 1
        if not names:
            return
        with trace.span("evict.recompute", rows=len(names)):
            for name in names:
                nix = self.node_index[name]
                self.dyn[nix] = stage_node_dyn_row(
                    ssn.nodes[name], self._axis, self.snap.port_index,
                    self.snap.selectors, self.np_pad,
                    self.ns_pad).astype(np.int32)
                self._edit_log.append(nix)
        self.stats["refresh_rows"] += len(names)
        trace.counter("evict.refresh_rows", len(names))

    # -- transaction mirror (Statement commit/discard) ----------------------
    # Copy-on-write: a checkpoint is a {row -> saved row copy} undo log
    # filled lazily by _save_row at the first touch of each row, not a
    # full dyn copy — a preemption storm opens one Statement per
    # preemptor job (thousands per cycle) while each statement touches a
    # handful of rows, so whole-array copies dominated the action.

    def checkpoint(self) -> None:
        self._checkpoints.append({})

    def _save_row(self, nix: int) -> None:
        if self._checkpoints:
            undo = self._checkpoints[-1]
            if nix not in undo:
                undo[nix] = self.dyn[nix].copy()

    def commit(self) -> None:
        if self._checkpoints:
            committed = self._checkpoints.pop()
            if self._checkpoints and committed:
                # Nested transactions: the outer frame must still be
                # able to undo rows the inner one touched first.
                outer = self._checkpoints[-1]
                for nix, row in committed.items():
                    outer.setdefault(nix, row)

    def restore(self) -> None:
        if self._checkpoints:
            undo = self._checkpoints.pop()
            for nix, row in undo.items():
                self.dyn[nix] = row
                self._edit_log.append(nix)  # restored rows need a rescore

    # -- state updates ------------------------------------------------------
    # ``used`` (the scoring dimension) tracks session allocate/deallocate
    # EVENTS — fired by Session/Statement for pipeline, evict, and both
    # rollback paths — mirroring nodeorder's GridUsage bit for bit.
    # Membership-derived state (count/ports/selcnt) changes only when a
    # pod joins a node, which the actions signal via apply_pipeline;
    # discard rollback restores it wholesale from the checkpoint.

    def _used_delta(self, task: TaskInfo, sign: int) -> None:
        nix = self.node_index.get(task.node_name)
        if nix is None:
            return
        self._save_row(nix)
        self.dyn[nix, 0] += sign * quantize_value(task.resreq.milli_cpu, 0)
        self.dyn[nix, 1] += sign * quantize_value(task.resreq.memory, 1)
        self._edit_log.append(nix)

    def apply_pipeline(self, task: TaskInfo, hostname: str) -> None:
        nix = self.node_index.get(hostname)
        if nix is None:
            return
        self._save_row(nix)
        self._edit_log.append(nix)
        row = self.dyn[nix]
        ti = self.task_index.get(task.uid)
        r = self.r
        if ti is not None:
            row[r + 1:r + 1 + self.np_pad] |= self._task_ports[ti]
            row[r + 1 + self.np_pad:] += self._task_match[ti]
        else:
            # Task outside the snapshot's candidate set (e.g. BestEffort,
            # filtered by the is_empty gate): derive its port keys and
            # selector matches directly so occupancy stays truthful.
            from .tensor_snapshot import _task_port_keys
            for pk in _task_port_keys(task):
                pid = self.snap.port_index.get(pk)
                if pid is not None:
                    row[r + 1 + pid] = 1
            labels = task.pod.metadata.labels
            for si, sel in enumerate(self.snap.selectors):
                if all(labels.get(k) == v for k, v in sel.items()):
                    row[r + 1 + self.np_pad + si] += 1
        row[r] += 1  # pod count

    # -- the scan -----------------------------------------------------------

    def scores(self, task: TaskInfo) -> Optional[np.ndarray]:  # frozen-after: scores
        """[N_real] int scores (SCORE_NEG_INF = predicate-rejected), or None
        when the task is outside the snapshot's candidate set.

        CONTRACT — no-retain, no-mutate: the returned vector is a live
        view into this scanner's LRU-cached score array, which later
        ``scores()`` calls patch IN PLACE (the incremental-rescore path).
        Callers must consume it before their next ``scores()`` call and
        must never write to it (e.g. an in-place admissibility mask) —
        either silently corrupts or observes-mutated cached scores.
        Retaining callers must copy (``scores(t).copy()``).  The contract
        is machine-checked: the ``frozen-after: scores`` marker above
        makes graftlint flag in-place mutation of any name bound from a
        ``.scores(...)`` call (doc/LINT.md rule 4), and
        ``KUBE_BATCH_TPU_SAFE_SCORES=1`` returns a defensive copy so a
        contract hole corrupts nothing there."""
        safe = knobs.SAFE_SCORES.enabled()
        self._consume_batch()
        ti = self.task_index.get(task.uid)
        if ti is None:
            return None
        key = self._profile_key(ti)
        log = self._edit_log
        entry = self._score_cache.get(key)
        if entry is None and knobs.SCAN_DEVICE.enabled():
            # Per-row device scan (opt-in env).  A batch-seeded profile
            # skips this: its row already came back from the ONE batched
            # dispatch and only dirty rows need the numpy patch —
            # identical ints either way (the engines share the math).
            trow = self._profile_trow(ti)
            out = _readback(best_scan_nodes(self.cfg, self.r, self.np_pad,
                                            self.ns_pad, self.statics,
                                            self.dyn, trow))
            view = out[:len(self.snap.node_names)]
            # The readback is already a fresh host copy; safe mode copies
            # once more so this engine keeps the same promise as the
            # cached one.
            return view.copy() if safe else view
        if entry is not None:
            out, pos = entry
            gap = len(log) - pos
            if gap > self.dyn.shape[0]:
                # The patch pass scans the whole log gap; past one row
                # per node the plain full recompute is strictly cheaper
                # (the log is append-only and lives one session, so a
                # profile revisited after a long storm hits this).
                out[:] = self._scores_numpy(ti)
                entry[1] = len(log)
                self.stats["full_recomputes"] += 1
            elif gap:  # patch rows touched since last seen
                if self._batched and gap <= _PY_PATCH_MAX:
                    # The engine's dirty-row patcher: one preemptor's
                    # statement dirties 1-4 rows; the scalar scorer
                    # computes the identical integers without numpy's
                    # per-tiny-op overhead.  Only under the batched
                    # engine so the =0 control stays the unmodified
                    # sequential path.
                    touched = sorted(set(log[pos:]))
                    for nix, v in zip(touched,
                                      self._score_rows_py(ti, touched)):
                        out[nix] = v
                    self.stats["dirty_rows_patched"] += len(touched)
                else:
                    rows = np.unique(np.fromiter(
                        log[pos:], dtype=np.int64, count=gap))
                    out[rows] = self._scores_numpy(ti, rows)
                    self.stats["dirty_rows_patched"] += int(rows.size)
                entry[1] = len(log)
            self._score_cache.move_to_end(key)
        else:
            out = self._scores_numpy(ti)
            self._score_cache[key] = [out, len(log)]
            self.stats["full_recomputes"] += 1
            if len(self._score_cache) > _SCORE_CACHE_CAP:
                self._score_cache.popitem(last=False)
        view = out[:len(self.snap.node_names)]
        return view.copy() if safe else view

    def _score_rows_py(self, ti: int, rows) -> List[int]:
        """Scalar-Python scoring of a few node rows: the exact integers
        of _scores_numpy/_scan_body (every operation is integer — grid
        shifts, floor divisions, weighted sums — and Python ints cannot
        overflow), without numpy's fixed per-op cost.  Used only for the
        tiny dirty-row patches of the incremental-rescore path; parity
        with _scores_numpy is pinned by tests/test_evict_batch.py."""
        from ..ops.resources import SCORE_GRID_K
        cfg = self.cfg
        r = self.r
        sig = int(self._task_sig[ti])
        sig_row = self._np_sig_mask[sig]
        bonus_row = self._np_bonus[sig]
        exists = self._np_exists
        maxt = self._np_maxt
        alloc = self._np_alloc
        dyn = self.dyn
        sh0 = int(self._np_shift[0])
        sh1 = int(self._np_shift[1])
        res = self._task_res[ti]
        res0, res1 = int(res[0]), int(res[1])
        w = cfg.weights
        wl = int(w.least_requested)
        wm = int(w.most_requested)
        wb = int(w.balanced_resource)
        neg = int(SCORE_NEG_INF)
        has_ports = cfg.has_ports
        has_aff = cfg.has_pod_affinity
        has_paff = cfg.has_pod_affinity_score
        tports = self._task_ports[ti] if has_ports else None
        taff = self._task_aff[ti] if has_aff else None
        tanti = self._task_anti[ti] if has_aff else None
        if has_paff:
            wdiff = (self._task_paffw[ti].astype(np.int64)
                     - self._task_pantiw[ti])
        out: List[int] = []
        for nix in rows:
            row = dyn[nix]
            feasible = (bool(sig_row[nix]) and bool(exists[nix])
                        and int(row[r]) < int(maxt[nix]))
            if feasible and has_ports:
                for j in range(self.np_pad):
                    if tports[j] > 0 and row[r + 1 + j] > 0:
                        feasible = False
                        break
            if feasible and has_aff:
                base = r + 1 + self.np_pad
                for j in range(self.ns_pad):
                    have = row[base + j] > 0
                    if (taff[j] != 0 and not have) \
                            or (tanti[j] != 0 and have):
                        feasible = False
                        break
            if not feasible:
                out.append(neg)
                continue
            cs0 = int(alloc[nix, 0]) >> sh0
            cs1 = int(alloc[nix, 1]) >> sh1
            xs0 = min((int(row[0]) + res0) >> sh0, cs0)
            xs1 = min((int(row[1]) + res1) >> sh1, cs1)
            gc = ((xs0 * SCORE_GRID_K) // max(cs0, 1) if cs0 > 0
                  else SCORE_GRID_K)
            gm = ((xs1 * SCORE_GRID_K) // max(cs1, 1) if cs1 > 0
                  else SCORE_GRID_K)
            score = 0
            if wl:
                score += wl * 5 * (2 * SCORE_GRID_K - gc - gm)
            if wm:
                score += wm * 5 * (gc + gm)
            if wb:
                score += wb * (10 * SCORE_GRID_K - 10 * abs(gc - gm))
            if has_paff:
                base = r + 1 + self.np_pad
                acc = 0
                for j in range(self.ns_pad):
                    acc += int(wdiff[j]) * int(row[base + j])
                score += SCORE_GRID_K * acc
            out.append(score + int(bonus_row[nix]))
        return out

    def _scores_numpy(self, ti: int, rows=None) -> np.ndarray:
        """The exact integer math of ops/scan.py in numpy: the grid floor
        divisions and weighted sums are plain int ops, so both engines
        produce identical score integers.  ``rows``: optional node-row
        index array — compute only those rows (the incremental-rescore
        patch path); the math is row-pure, so a subset recompute equals
        the full one on those rows."""
        from ..ops.resources import SCORE_GRID_K
        cfg = self.cfg
        r = self.r
        dyn = self.dyn if rows is None else self.dyn[rows]
        used = dyn[:, :r]
        count = dyn[:, r]
        sig = int(self._task_sig[ti])
        alloc = self._np_alloc
        sig_row = self._np_sig_mask[sig]
        exists = self._np_exists
        maxt = self._np_maxt
        if rows is not None:
            alloc = alloc[rows]
            sig_row = sig_row[rows]
            exists = exists[rows]
            maxt = maxt[rows]
        shift = self._np_shift
        feasible = sig_row & exists & (count < maxt)
        if cfg.has_ports:
            ports = dyn[:, r + 1:r + 1 + self.np_pad]
            conflict = ((self._task_ports[ti][None, :] > 0)
                        & (ports > 0)).any(axis=-1)
            feasible = feasible & ~conflict
        if cfg.has_pod_affinity:
            selcnt = dyn[:, r + 1 + self.np_pad:]
            have = selcnt > 0
            aff_ok = np.all((self._task_aff[ti][None, :] == 0) | have,
                            axis=-1)
            anti_ok = np.all((self._task_anti[ti][None, :] == 0) | ~have,
                             axis=-1)
            feasible = feasible & aff_ok & anti_ok
        res = self._task_res[ti]
        g = []
        for d in range(2):
            cs = alloc[:, d].astype(np.int64) >> shift[d]
            xs = np.minimum((used[:, d].astype(np.int64) + int(res[d]))
                            >> shift[d], cs)
            q = np.where(cs > 0, (xs * SCORE_GRID_K) // np.maximum(cs, 1),
                         SCORE_GRID_K)
            g.append(q)
        gc, gm = g
        w = cfg.weights
        score = np.zeros(used.shape[0], np.int64)
        if w.least_requested:
            score += int(w.least_requested) * 5 * (2 * SCORE_GRID_K - gc - gm)
        if w.most_requested:
            score += int(w.most_requested) * 5 * (gc + gm)
        if w.balanced_resource:
            score += int(w.balanced_resource) * (
                10 * SCORE_GRID_K - 10 * np.abs(gc - gm))
        if cfg.has_pod_affinity_score:
            selcnt = dyn[:, r + 1 + self.np_pad:]
            wdiff = (self._task_paffw[ti].astype(np.int64)
                     - self._task_pantiw[ti])[None, :]
            score += SCORE_GRID_K * (wdiff * selcnt).sum(axis=-1)
        bonus = self._np_bonus[sig]
        score += bonus if rows is None else bonus[rows]
        return np.where(feasible, score,
                        np.int64(SCORE_NEG_INF)).astype(np.int64)

    def candidate_nodes(self, task: TaskInfo, scored: bool,
                        admissible=None):
        """Feasible (node_name, score) pairs, LAZY; score-descending with
        name-ascending tie-break when ``scored`` (SortNodes semantics,
        scheduler_helper.go:174-185), name-ascending otherwise (the
        reclaim walk order).  Returns None when the task is outside the
        snapshot's candidate set.  Laziness matters: the eviction
        actions stop at the first workable node, so materializing all
        ~N feasible pairs per preemptor dominated the preempt storm.
        ``admissible``: optional bool[N] pre-filter (VictimIndex mask)
        ANDed into feasibility — one vector op instead of a per-node
        Python check over the walk."""
        s = self.scores(task)
        if s is None:
            return None
        ok = s > SCORE_NEG_INF
        if admissible is not None:
            ok = ok & admissible[:len(s)]
        names = self.snap.node_names
        if not scored:
            return ((names[i], int(s[i])) for i in np.nonzero(ok)[0])

        def ranked():
            # Repeated argmax for the first few nodes — the walk almost
            # always stops within a handful — then one full sort for the
            # (rare) long tail.  Sequence is IDENTICAL to the stable
            # descending argsort: np.argmax returns the lowest index
            # among equal maxima, the same index-ascending tie-break.
            masked = np.where(ok, s, np.int64(SCORE_NEG_INF))
            if masked.size == 0:  # zero-node snapshot: nothing to rank
                return
            for _ in range(8):
                i = int(np.argmax(masked))
                if masked[i] == SCORE_NEG_INF:
                    return
                yield names[i], int(s[i])
                masked[i] = SCORE_NEG_INF
            feas = np.nonzero(masked > SCORE_NEG_INF)[0]
            order = feas[np.argsort(-masked[feas], kind="stable")]
            for i in order:
                yield names[i], int(s[i])
        return ranked()
