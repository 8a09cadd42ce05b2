"""tpu-allocate: the allocate action solved as one device program.

Counterpart of kube_batch_tpu/actions/tpu_allocate.py.  Tensorize the
session snapshot (models/tensor_snapshot.py), ship it to the device
through the resident shipper, solve it there (ops/solver.py: one launch
of the hand-written CUDA kernel on the card, its plain PyTorch version on
the CPU), then apply the placements back through the session so plugins,
gang dispatch and binders observe exactly the same sequence of events as
the host allocate action.  Only the tensorizer's expressiveness gaps
(``snap.needs_fallback``) run the host allocate action.

The action owns its device and float key type: CUDA unless the caller
asks for the CPU, float32 unless it asks for float64.  Unlike the
reference it never degrades to the host path on a device failure: a
failing ship, dispatch, fetch or validation raises out of ``execute``
(the breaker and degradation come with ROADMAP queue 1 item 11).

Steady state: a byte-clean ship at an unchanged shipper generation
reuses the previous validated result (models/incremental.py), and a
micro session solves only the prefiltered candidate node rows
(ops/prefilter.py) — one launch of the same kernel on the gathered
inputs.  ``KUBE_BATCH_TPU_INCREMENTAL=0`` and
``KUBE_BATCH_TPU_CANDIDATE_SOLVE=0`` are the controls.  The reference's
fused one-dispatch program is not ported yet; this action runs its
control arm (FUSED=0), which the reference proves bind-identical to its
default.
"""

from __future__ import annotations

import logging
import time
from typing import NamedTuple

import torch

from ..device import check_float_dtype, resolve_device
from ..framework import Action
from ..metrics import metrics
from ..trace import spans as trace

log = logging.getLogger(__name__)


class SessionRecord(NamedTuple):
    """What the last ``execute`` staged, shipped and solved, and the
    host seconds of each stage (tensorize, ship, prefilter,
    dispatch_fetch, apply).  ``candidates`` is the prefilter's
    CandidateSet when the solve ran on gathered rows, else None;
    ``reused`` says the result came from the generation-keyed cache (no
    launch)."""
    route: str
    snap: object
    inputs: object          # the shipped SolverInputs, on the device
    assignment: object      # numpy [P], full-space node rows
    kind: object
    order: object
    ordered: object         # placed task ids in placement order
    stages: dict
    candidates: object = None
    reused: bool = False


class TpuAllocateAction(Action):

    def __init__(self, device=None, dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.dtype = check_float_dtype(dtype)
        self._fallback_action = None
        # The last session's record (None until a session solved).
        self.last: SessionRecord | None = None

    def name(self) -> str:
        return "tpu-allocate"

    def _run_host_fallback(self, ssn) -> None:
        """The host allocate oracle: placement-identical to the device
        path by the parity suite, only the engine differs."""
        if self._fallback_action is None:
            from .allocate import AllocateAction
            self._fallback_action = AllocateAction()
        self._fallback_action.execute(ssn)

    @staticmethod
    def _validate_result(snap, assignment, kind, order, ordered) -> None:
        """Reject a malformed device result BEFORE it touches the session:
        a poisoned readback (wrong row count, out-of-range indices) must
        never corrupt placements."""
        import numpy as np

        p = int(snap.inputs.task_req.shape[0])
        shapes = (assignment.shape, kind.shape, order.shape)
        if shapes != ((p,), (p,), (p,)):
            raise RuntimeError(
                f"malformed device solve result: expected [P={p}] "
                f"vectors, got {shapes}")
        if ordered.size:
            if int(ordered.min()) < 0 or int(ordered.max()) >= p:
                raise RuntimeError(
                    "malformed device solve result: placement "
                    "permutation out of range")
            sel = assignment[ordered]
            if (int(sel.min()) < 0
                    or int(sel.max()) >= len(snap.node_names)):
                raise RuntimeError(
                    "malformed device solve result: node index out of "
                    "range")
            if np.any(kind[ordered] <= 0):
                raise RuntimeError(
                    "malformed device solve result: permutation selects "
                    "unplaced tasks")

    def execute(self, ssn) -> None:
        from ..models.shipping import resident_shipper
        from ..models.tensor_snapshot import (build_apply_aggregates,
                                              prepare_apply_scaffold,
                                              tensorize_session)
        from ..ops.solver import (choose_solver_mesh, discard_solve,
                                  dispatch_solve, fetch_solve)

        stages = {}
        start = time.time()
        t0 = time.perf_counter()
        with trace.span("tensorize"):
            snap = tensorize_session(ssn, self.dtype)
        stages["tensorize"] = time.perf_counter() - t0
        if snap.needs_fallback:
            # A tensorization GAP, not a device failure: the reference's
            # expressiveness boundary, where the host oracle serves.
            self._run_host_fallback(ssn)
            return
        metrics.observe_tpu_transfer_latency(time.time() - start)

        # Backfill pre-scan: the tensorizer already collected every
        # BestEffort pending task (snap.tasks_extra), so the backfill
        # action's O(all pending) discovery walk is answered here for
        # free.  A negative answer is only trustworthy when the
        # tensorizer saw EVERY job (allocate.go:52-56).
        if snap.tasks_extra:
            ssn.prescan["has_best_effort"] = True
        elif len(snap.job_uids) == len(ssn.jobs):
            ssn.prescan["has_best_effort"] = False

        if not snap.tasks:
            return

        # Ship -> dispatch -> fetch -> validate mutates no session state;
        # a failure there raises out of the action (no host fallback).
        pending = None
        try:
            ship_start = time.time()
            t0 = time.perf_counter()
            shipper = resident_shipper(ssn.cache, self.device)
            with trace.span("ship"):
                inputs = shipper.ship(snap.inputs, snap.config, self.dtype)
            if inputs.node_idle.is_cuda:
                torch.cuda.current_stream(inputs.node_idle.device) \
                    .synchronize()
            stages["ship"] = time.perf_counter() - t0
            metrics.observe_tpu_transfer_latency(time.time() - ship_start)

            route, _mesh = choose_solver_mesh(inputs)
            trace.set_meta(solver_route=route, mesh_devices=1)

            # Generation-keyed solve reuse (models/incremental.py,
            # doc/INCREMENTAL.md): a CLEAN ship at an unchanged shipper
            # generation proves the inputs are byte-identical to the
            # previous dispatch, and the solver is deterministic — so the
            # cached result IS this session's result, no device
            # round-trip needed.  KUBE_BATCH_TPU_INCREMENTAL=0 (or any
            # byte change, or an invalidated shipper) disables reuse.
            from ..models import incremental
            inc_state = (incremental.state_for(ssn.cache, create=False)
                         if incremental.incremental_enabled() else None)
            cached_solve = None
            if (inc_state is not None
                    and shipper.last_mode == "clean"
                    and inc_state.solve_gen == shipper.generation
                    and inc_state.solve_cfg == snap.config
                    and inc_state.solve_result is not None):
                cached_solve = inc_state.solve_result
            # Candidate-row solve prefilter (ops/prefilter.py,
            # doc/INCREMENTAL.md "floors"): on a micro build the host
            # derives the provably-sufficient candidate node set from
            # the staged start tensors, and the dispatch gathers only
            # those rows out of the resident inputs — the per-placement
            # device scan drops from O(N) to O(C).  Full sessions (and
            # the INCREMENTAL=0 / CANDIDATE_SOLVE=0 controls) keep the
            # whole node bucket.
            candidates = None
            t0 = time.perf_counter()
            if (cached_solve is None and inc_state is not None
                    and inc_state.last_kind == "micro"):
                from ..ops.prefilter import derive_candidates
                with trace.span("prefilter"):
                    candidates = derive_candidates(snap, route)
                if candidates is not None:
                    trace.set_meta(candidate_rows=candidates.count)
            stages["prefilter"] = time.perf_counter() - t0

            solve_start = time.perf_counter()
            if cached_solve is not None:
                with trace.span("solve.reuse",
                                generation=shipper.generation,
                                route=inc_state.solve_route):
                    assignment, kind, order, ordered = cached_solve
                    scaffold = prepare_apply_scaffold(snap)
                metrics.note_generation_reuse(True)
                metrics.set_cycle_floor("solve_wait", 0.0)
                stages["dispatch_fetch"] = time.perf_counter() - solve_start
            else:
                # Dispatch, overlap the result-independent apply
                # preparation with the executing device program, then
                # block only when the result is consumed.  No fused
                # program holds this solve: the reference's FUSED=0 arm
                # (ROADMAP queue 1 item 4).
                with trace.span("dispatch"):
                    pending = dispatch_solve(inputs, snap.config,
                                             candidates=candidates)
                metrics.note_candidate_solve(
                    candidates is not None,
                    candidates.count if candidates is not None else 0)
                overlap_start = time.perf_counter()
                with trace.span("host_overlap"):
                    scaffold = prepare_apply_scaffold(snap)
                metrics.observe_host_overlap_latency(
                    time.perf_counter() - overlap_start)
                wait_start = time.perf_counter()
                with trace.span("device_wait"):
                    fetching, pending = pending, None
                    assignment, kind, order, ordered = fetch_solve(fetching)
                wait_elapsed = time.perf_counter() - wait_start
                stages["dispatch_fetch"] = time.perf_counter() - solve_start
                metrics.observe_device_wait_latency(wait_elapsed)
                metrics.set_cycle_floor("solve_wait", wait_elapsed)
                metrics.observe_tpu_solve_latency(stages["dispatch_fetch"])
            self._validate_result(snap, assignment, kind, order, ordered)
            if inc_state is not None and cached_solve is None:
                # Cache AFTER validation only: a poisoned readback must
                # never become a reusable "known-good" result.
                inc_state.solve_gen = shipper.generation
                inc_state.solve_cfg = snap.config
                inc_state.solve_result = (assignment, kind, order, ordered)
                inc_state.solve_route = route
                metrics.note_generation_reuse(False)
        except BaseException:
            if pending is not None:
                # The dispatch landed before the failure: retire the
                # handle from the in-flight ledger — nothing will fetch it.
                discard_solve(pending)
            raise

        # Apply placements in device-solve order through the columnar
        # batched path: end state (status indexes, node accounting,
        # plugin shares, gang dispatch) is identical to per-task
        # ssn.allocate/pipeline calls (Session.batch_apply_solved).
        apply_start = time.perf_counter()
        with trace.span("apply", placed=int(ordered.size)):
            agg = build_apply_aggregates(snap, assignment, kind, ordered,
                                         scaffold=scaffold)
            from ..framework.commit import batch_commit_enabled
            from ..trace.lineage import lineage as pod_lineage
            pod_lineage.cycle_context = f"via {self.name()}/{route}"
            try:
                if batch_commit_enabled():
                    ssn.batch_apply_solved(
                        scaffold.tasks_arr, scaffold.node_names_arr,
                        assignment, kind, ordered, snap.task_job,
                        snap.job_uids, agg)
                else:
                    # KUBE_BATCH_TPU_BATCH_COMMIT=0: the pre-columnar
                    # tuple fan-out — the bit-parity control for the
                    # whole commit/apply tail.
                    kinds = kind[ordered].tolist()
                    hostnames = scaffold.node_names_arr[
                        assignment[ordered]].tolist()
                    ssn.batch_apply(
                        zip(scaffold.tasks_arr[ordered].tolist(),
                            hostnames, kinds),
                        agg=agg)
            finally:
                pod_lineage.cycle_context = ""
        ssn._floor_apply += time.perf_counter() - apply_start
        with trace.span("fit_deltas"):
            self._record_fit_deltas(ssn, snap, kind, assignment, order,
                                    scaffold=scaffold)
        stages["apply"] = time.perf_counter() - apply_start
        metrics.observe_tpu_apply_latency(stages["apply"])
        if trace.current_session_id() is not None:
            self._record_why_tallies(ssn, snap, kind)
        self.last = SessionRecord(route, snap, inputs, assignment, kind,
                                  order, ordered, stages, candidates,
                                  cached_solve is not None)

    @staticmethod
    def _record_why_tallies(ssn, snap, kind) -> None:
        """Why-pending tallies from the solver's own outputs: per job with
        unplaced candidates, how many tasks allocated/pipelined/stalled,
        and — from the static [S, N] predicate mask — whether ANY node
        passed the first stalled task's static predicates."""
        import numpy as np

        inp = snap.inputs
        nj = len(snap.job_uids)
        job_start = np.asarray(inp.job_start)[:nj].astype(np.int64)
        job_count = np.asarray(inp.job_count)[:nj].astype(np.int64)
        # Vectorized per-job kind counts via cumulative sums (job blocks
        # are contiguous): O(P + J) host work, then a Python iteration
        # over STALLED jobs only.
        ends = job_start + job_count
        cum0 = np.concatenate(([0], np.cumsum(kind == 0)))
        cum1 = np.concatenate(([0], np.cumsum(kind == 1)))
        cum2 = np.concatenate(([0], np.cumsum(kind == 2)))
        unplaced_per_job = cum0[ends] - cum0[job_start]
        stalled = np.nonzero((job_count > 0) & (unplaced_per_job > 0))[0]
        if stalled.size == 0:
            return
        task_sig = np.asarray(inp.task_sig)
        node_exists = np.asarray(inp.node_exists)
        sig_feasible = np.count_nonzero(
            np.asarray(inp.sig_mask) & node_exists[None, :], axis=1)
        for ji in (int(j) for j in stalled):
            job = ssn.jobs.get(snap.job_uids[ji])
            if job is None:
                continue
            start, end = job_start[ji], ends[ji]
            first = start + int(np.argmax(kind[start:end] == 0))
            feasible = int(sig_feasible[int(task_sig[first])])
            trace.note_tally(
                f"{job.namespace}/{job.name}",
                candidates=int(job_count[ji]),
                allocated=int(cum1[end] - cum1[start]),
                pipelined=int(cum2[end] - cum2[start]),
                unplaced=int(unplaced_per_job[ji]),
                static_feasible_nodes=feasible,
                reason=("PredicateMismatch" if feasible == 0
                        else "NoFeasibleNode"))

    @staticmethod
    def _record_fit_deltas(ssn, snap, kind, assignment, order,
                           scaffold=None) -> None:
        """Fit-error diagnostics (allocate.go:139-141, job_info.go:348-380).

        The host path records NodesFitDelta when the selected node fails
        the idle fit (the task is then pipelined onto releasing), and the
        entry SURVIVES the action only when that was the job's last
        processed task.  Mirror: per job, a delta survives iff the final
        candidate task was pipelined (kind 2) and actually applied; the
        node idle is reconstructed AT THE RECORD POINT by adding back
        allocations that landed on the node later in solve order."""
        import numpy as np

        from ..api import TaskStatus, allocated_status
        from ..models.tensor_snapshot import _res_from_vec

        names = snap.node_names
        inp = snap.inputs
        if scaffold is not None:
            job_start, job_count = scaffold.job_start, scaffold.job_count
        else:
            job_start = np.asarray(inp.job_start)
            job_count = np.asarray(inp.job_count)
        for ji, uid in enumerate(snap.job_uids):
            count = int(job_count[ji])
            if not count:
                continue
            last = int(job_start[ji]) + count - 1
            if kind[last] != 2:
                continue
            task = snap.tasks[last]
            if task.status != TaskStatus.Pipelined:
                continue  # batch_apply skipped this placement
            job = ssn.jobs.get(uid)
            nix = int(assignment[last])
            node = ssn.nodes.get(names[nix])
            if job is None or node is None:
                continue
            later = ((kind == 1) & (assignment == nix)
                     & (order > order[last]))
            rows = [int(i) for i in np.nonzero(later)[0]
                    if allocated_status(snap.tasks[int(i)].status)]
            delta = node.idle.clone()
            if rows:
                delta.add(_res_from_vec(
                    snap.task_res_f64[rows].sum(axis=0),
                    snap.resource_names))
            delta.fit_delta(task.init_resreq)
            ssn._dirty_job(job.uid)
            job.nodes_fit_delta[node.name] = delta


def new(device=None, dtype: torch.dtype = torch.float32) -> TpuAllocateAction:
    return TpuAllocateAction(device, dtype)
