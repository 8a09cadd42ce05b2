"""tpu-allocate: the allocate action solved as one device program.

Counterpart of kube_batch_tpu/actions/tpu_allocate.py.  Tensorize the
session snapshot (models/tensor_snapshot.py), ship it to the device
through the resident shipper, solve it there (ops/solver.py: one launch
of the hand-written CUDA kernel on the card, its plain PyTorch version on
the CPU), then apply the placements back through the session so plugins,
gang dispatch and binders observe exactly the same sequence of events as
the host allocate action.  The tensorizer's expressiveness gaps
(``snap.needs_fallback``) run the host allocate action, as in the
reference, on the card too; each such session is counted in
``kube_batch_tensorize_limit_total{reason, site}``, noted on its trace
and logged (the reference gives no signal).

The action owns its device and float key type: CUDA unless the caller
asks for the CPU, float32 unless it asks for float64.  A device failure
at any stage — tensorize, ship, dispatch, fetch or validation — feeds
the shared device breaker (chaos/breaker.feed_failure), lands in
``kube_batch_device_solve_failures_total{stage}``, in the session
trace's ``degraded`` meta and in a warning, and drops the resident ship
image.  Then, on the CPU, that one session degrades to the host allocate
action, placement-identical by the parity suite, as the reference does;
on a CUDA device it raises ``DeviceFailure`` before anything is
mutated, and the card's work never moves to the host.  An open breaker
does the same to whole sessions until its half-open probe; a solve over
``KUBE_BATCH_TPU_SOLVE_DEADLINE_MS`` is applied but counts as a breaker
failure.  The shard pipeline's stale session (``ssn._pipeline_stale``)
is the one exception: its failed fetch raises ``StaleSessionAbort``,
before any mutation, so the pipeline reruns the shard fresh
(tenancy/pipeline.py).  ``KUBE_BATCH_TPU_PROFILE=<dir>`` writes a
``torch.profiler`` Chrome trace of each session into that directory.

``execute`` is ``execute_begin`` (tensorize, ship, dispatch) followed by
the continuation it returns (fetch, validate, apply); the concurrent
shard pipeline runs other shards' begin halves between the two.

Steady state: a byte-clean ship at an unchanged shipper generation
reuses the previous validated result (models/incremental.py), and a
micro session solves only the prefiltered candidate node rows
(ops/prefilter.py) — one launch of the same kernel on the gathered
inputs.  ``KUBE_BATCH_TPU_INCREMENTAL=0`` and
``KUBE_BATCH_TPU_CANDIDATE_SOLVE=0`` are the controls.  Under the fused
one-dispatch program (ops/fused_solver.py, on by default) an eviction-led
session's solve was already enqueued by the eviction scanner: the begin
half consumes it (``take_alloc``) when its own ship proves the inputs
unchanged, and a commit flush an earlier action deferred into this
action's window egresses first in ``finish``.
``KUBE_BATCH_TPU_PIPELINE=0`` runs the sequential solve: one launch read
back in one transfer, no host-overlap window and no prefilter,
placement-identical to the pipelined default.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import NamedTuple

import torch

from .. import knobs
from ..device import check_float_dtype, resolve_device
from ..framework import Action
from ..metrics import metrics
from ..trace import spans as trace

log = logging.getLogger(__name__)

# Set to a directory to capture a torch.profiler trace of each session's
# tpu-allocate (the sidecar profiling hook, SURVEY.md §5).
PROFILE_ENV = knobs.PROFILE.env
# =0 runs the sequential path (solve barrier, then apply preparation):
# the A/B control and parity oracle for the pipelined engine.
PIPELINE_ENV = knobs.PIPELINE.env


# Whether a profile is open: ``execute``'s covers both of its halves.
_profile_open = [False]


@contextlib.contextmanager
def _profile_session(path: str):
    """Profile the block with CPU and CUDA activities and write one
    Chrome trace to ``path``.  Every flight-recorder span opened inside
    the block is mirrored into the profile as a ``record_function``
    range (trace/spans.py).  A profiler that cannot start (no CUPTI,
    refused) raises with its own message: there is no silent CPU-only
    fallback."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..trace import spans as trace_spans
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with profile(activities=activities) as prof:
        _profile_open[0] = True
        trace_spans.set_profiler_range(record_function)
        try:
            yield
        finally:
            trace_spans.set_profiler_range(None)
            _profile_open[0] = False
    prof.export_chrome_trace(path)
    log.info("tpu-allocate profile written to %s", path)


def _maybe_profile(ssn, half: str = ""):
    """The profile of one session (``session-<uid>.json``) or, for a
    session whose halves the shard pipeline runs apart, of one half
    (``session-<uid>-begin.json``, ``-retire.json``): one profiler runs
    at a time in a process, and other shards' halves run between them.
    Nothing when the knob is unset or a profile is already open."""
    profile_dir = knobs.PROFILE.raw()
    if not profile_dir or _profile_open[0]:
        return contextlib.nullcontext()
    name = f"session-{ssn.uid}" + (f"-{half}" if half else "")
    return _profile_session(os.path.join(profile_dir, name + ".json"))


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

    def _fallback_on_failure(self, ssn, breaker, stage: str, exc) -> None:
        """A device-pipeline failure BEFORE any session mutation: feed
        the breaker (repeated failures trip it open — doc/CHAOS.md
        "Breaker semantics"), drop the resident ship image (a partial
        ship must not serve as the next delta baseline) and surface the
        failure; then run the host path on the CPU, or raise
        ``DeviceFailure`` on the card.  Nothing here launches or waits
        on the device."""
        from ..chaos.breaker import feed_failure
        feed_failure(stage, f"device {stage} failed ({type(exc).__name__}: "
                     f"{exc}); host allocate fallback", exc,
                     owner=ssn.cache, breaker=breaker, what="tpu-allocate",
                     device=self.device)
        self._run_host_fallback(ssn)

    def _run_host_fallback(self, ssn) -> None:
        """The host allocate oracle: placement-identical to the device
        path by the parity suite, only the engine differs."""
        # A commit flush deferred into this action's dispatch window
        # (framework/commit.py) must land BEFORE the fallback mutates and
        # binds — evict events precede binds on every path.
        from ..ops import fused_solver
        fused_solver.flush_deferred(ssn)
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
        with _maybe_profile(ssn):
            finish = self.execute_begin(ssn)
            if finish is not None:
                finish()

    def execute_begin(self, ssn):
        """The begin half (``_execute_begin``), each half profiled under
        ``KUBE_BATCH_TPU_PROFILE`` when ``execute`` is not profiling the
        whole session."""
        with _maybe_profile(ssn, "begin"):
            finish = self._execute_begin(ssn)
        if finish is None or not knobs.PROFILE.raw():
            return finish

        def profiled_finish():
            with _maybe_profile(ssn, "retire"):
                finish()
        profiled_finish.pending = getattr(finish, "pending", None)
        return profiled_finish

    def _execute_begin(self, ssn):
        """The HOST half of the action — tensorize, ship, async solve
        dispatch, device-wait-window apply preparation — with every
        cluster-mutating step deferred into the returned continuation.

        Returns None when the action fully completed (nothing to solve),
        else a zero-argument continuation that finishes it: device fetch,
        result validation, placement apply, fit deltas — or the host
        allocate action where the tensorizer cannot express the session.
        The split is what the concurrent shard pipeline overlaps
        (tenancy/pipeline.py): shard K+1 runs this begin half while shard
        K's kernel runs on the card, and the continuations retire in
        shard order so binds and events stay sequential-identical.
        ``execute`` composes the halves back to back.  The continuation
        carries ``pending``, the dispatched solve it will fetch (None
        when it fetches nothing), so the pipeline can retire an
        abandoned one.

        The device breaker gates the whole device half: while it is open
        the continuation runs the host path (on the card it raises), and
        a failing tensorize, ship or dispatch returns a continuation that
        feeds the breaker and then degrades or raises
        (``_fallback_on_failure``)."""
        import numpy as np

        from ..chaos.breaker import device_breaker, refuse_open
        from ..models.shipping import resident_shipper
        from ..models.tensor_snapshot import (prepare_apply_scaffold,
                                              tensorize_session)
        from ..ops.solver import (best_solve_allocate, choose_solver_mesh,
                                  discard_solve, dispatch_solve,
                                  fetch_result)

        breaker = device_breaker()
        if not breaker.allow():
            # OPEN within cooldown: the device path is quarantined.  On
            # the CPU the host oracle serves this cycle; on the card the
            # continuation raises DeviceFailure.  Once the cooldown
            # elapses, allow() turns the breaker half-open and the next
            # cycle probes the device path again.  The fallback mutates
            # the session and binds, so it is retire-phase work.
            def finish_breaker_open():
                refuse_open("tpu-allocate", self.device,
                            "device breaker open: tpu-allocate ran the "
                            "host path")
                self._run_host_fallback(ssn)
            ssn._pipeline_reads_all = True
            return finish_breaker_open

        stages = {}
        start = time.time()
        t0 = time.perf_counter()
        try:
            with trace.span("tensorize"):
                snap = tensorize_session(ssn, self.dtype)
        except Exception as exc:
            ssn._pipeline_reads_all = True
            # Bind via default: `exc` is unbound once the except block
            # exits, and the continuation runs later.
            return lambda err=exc: self._fallback_on_failure(
                ssn, breaker, "tensorize", err)
        stages["tensorize"] = time.perf_counter() - t0
        if snap.needs_fallback:
            # A tensorization GAP, not a device failure: the reference's
            # expressiveness boundary, where the host oracle serves, on
            # the card too — counted, noted and logged.  The fallback
            # mutates the session and binds: retire-phase work.
            from ..models.tensor_snapshot import note_tensorize_limit
            note_tensorize_limit(snap, "tpu-allocate",
                                 "the host allocate action")
            ssn._pipeline_reads_all = True
            return lambda: self._run_host_fallback(ssn)
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
            # No finish continuation will run: flush any commit sink
            # deferred into this action's window now (an earlier action
            # may have pipelined away every pending task), so later
            # actions' binds cannot precede the deferred evict events.
            from ..ops import fused_solver
            fused_solver.flush_deferred(ssn)
            self._publish_read_fence(ssn, snap, empty=True)
            return None

        # Ship -> dispatch -> fetch -> validate is the degradation
        # boundary: no session state is mutated inside it, so any failure
        # (device error, poisoned readback) feeds the breaker and safely
        # degrades this cycle to the host path (on the card: raises
        # before any mutation).  From the apply phase on,
        # failures propagate — the session is mutated and a re-run would
        # double-place.  The begin half stops at the async dispatch;
        # fetch, validation and apply live in the returned continuation.
        pending = None
        assignment = kind = order = ordered = None
        try:
            ship_start = time.time()
            t0 = time.perf_counter()
            shipper = resident_shipper(ssn.cache, self.device)
            with trace.span("ship"):
                inputs = shipper.ship(snap.inputs, snap.config, self.dtype)
            if inputs.node_idle.is_cuda and shipper.last_mode != "clean":
                # The session's own stream (a shard view's, or the
                # current one for the global engine): never the device.
                # A clean ship enqueued nothing, and the stream may hold
                # a fused solve still running, which this would wait for.
                # On the mesh, the current stream of each shard's device.
                from ..parallel.mesh import shard_mesh
                mesh = shard_mesh(inputs)
                for dev in (set(mesh.devices) if mesh is not None
                            else {inputs.node_idle.device}):
                    torch.cuda.current_stream(dev).synchronize()
            stages["ship"] = time.perf_counter() - t0
            metrics.observe_tpu_transfer_latency(time.time() - ship_start)

            route, mesh = choose_solver_mesh(inputs)
            trace.set_meta(solver_route=route,
                           mesh_devices=mesh.size if mesh else 1)

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
            pipelined = knobs.PIPELINE.enabled()
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
            if (pipelined and cached_solve is None
                    and inc_state is not None
                    and inc_state.last_kind == "micro"):
                from ..ops.prefilter import derive_candidates
                with trace.span("prefilter"):
                    candidates = derive_candidates(snap, route, mesh)
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
            elif pipelined:
                # Dispatch, overlap the result-independent apply
                # preparation with the executing device program, then
                # block only when the result is consumed (the
                # continuation below).  A fused session dispatch
                # (ops/fused_solver.py) may already hold this solve:
                # consume it iff the ship above came back CLEAN at the
                # fused generation with the same config and candidate
                # gather (or the storm proof holds) — else the
                # per-family dispatch.
                with trace.span("dispatch"):
                    from ..ops import fused_solver
                    pending = fused_solver.take_alloc(
                        ssn, shipper, snap, route, candidates)
                    if pending is not None:
                        trace.annotate(fused=True)
                    else:
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
            else:
                # KUBE_BATCH_TPU_PIPELINE=0: the sequential solve, one
                # launch read back in one transfer; the scaffold is built
                # after it, at apply.
                with trace.span("solve"):
                    result = best_solve_allocate(inputs, snap.config)
                    assignment, kind, order = fetch_result(result)
                metrics.note_candidate_solve(False, 0)
                metrics.set_cycle_floor("solve_wait",
                                        time.perf_counter() - solve_start)
                placed = np.nonzero(kind > 0)[0]
                ordered = placed[np.argsort(order[placed], kind="stable")]
                scaffold = None
            begin_solve_elapsed = time.perf_counter() - solve_start
        except Exception as exc:
            if pending is not None:
                # The dispatch landed before the failure: retire the
                # handle from the in-flight ledger — nothing will fetch it.
                discard_solve(pending)
            ssn._pipeline_reads_all = True
            return lambda err=exc: self._fallback_on_failure(
                ssn, breaker, "solve", err)

        # Publish the successor-conflict read fence BEFORE pausing: the
        # pipeline compares predecessors' mutated nodes against this
        # session's statically-feasible node union (doc/TENANCY.md
        # "Concurrent micro-sessions" — the solve's outcome provably
        # depends on node state only inside sig-feasible columns).
        self._publish_read_fence(ssn, snap)

        def finish():
            nonlocal scaffold, assignment, kind, order, ordered
            from ..chaos.breaker import solve_deadline_s
            from ..models.tensor_snapshot import build_apply_aggregates
            from ..ops import fused_solver
            from ..ops.solver import fetch_solve
            # Storm half (doc/FUSED.md): a commit flush deferred from an
            # earlier action rides this window — egress the evicts FIRST
            # so the cluster call overlaps the device wait below, and the
            # event stream keeps evicts before this session's binds on
            # the served and invalidated paths alike.
            fused_solver.flush_deferred(ssn)
            try:
                if pending is not None:
                    wait_start = time.perf_counter()
                    with trace.span("device_wait"):
                        assignment, kind, order, ordered = \
                            fetch_solve(pending)
                    wait_elapsed = time.perf_counter() - wait_start
                    metrics.observe_device_wait_latency(wait_elapsed)
                    metrics.set_cycle_floor("solve_wait", wait_elapsed)
                    solve_elapsed = begin_solve_elapsed + wait_elapsed
                else:
                    solve_elapsed = begin_solve_elapsed
                stages["dispatch_fetch"] = solve_elapsed
                metrics.observe_tpu_solve_latency(solve_elapsed)
                self._validate_result(snap, assignment, kind, order,
                                      ordered)
            except Exception as exc:
                if ssn._pipeline_stale:
                    # A predecessor committed after this session's
                    # snapshot, and the conflict fence only cleared the
                    # NARROW solve footprint: the host fallback would
                    # read arbitrary (stale) node state.  Nothing has
                    # been mutated yet, so abort for the pipeline's
                    # fresh sequential rerun instead of degrading here
                    # (tenancy/pipeline.StaleSessionAbort).  The breaker
                    # still sees the device failure.
                    from ..tenancy.pipeline import StaleSessionAbort
                    breaker.failure()
                    metrics.note_device_failure("solve")
                    raise StaleSessionAbort(
                        f"device solve failed mid-pipeline over a stale "
                        f"snapshot ({type(exc).__name__}: {exc})") from exc
                self._fallback_on_failure(ssn, breaker, "solve", exc)
                return

            if inc_state is not None and cached_solve is None:
                # Cache AFTER validation only: a poisoned readback must
                # never become a reusable "known-good" result.
                inc_state.solve_gen = shipper.generation
                inc_state.solve_cfg = snap.config
                inc_state.solve_result = (assignment, kind, order, ordered)
                inc_state.solve_route = route
                metrics.note_generation_reuse(False)

            deadline = solve_deadline_s()
            if cached_solve is not None:
                # A reused result is no device health evidence either
                # way: the breaker and the solve deadline see nothing.
                pass
            elif deadline and solve_elapsed > deadline:
                # Detective, not preemptive: the (valid) late result is
                # still applied, but a repeatedly slow device opens the
                # breaker exactly like a failing one.
                # (Pipelined pause time is excluded: solve_elapsed is the
                # dispatch half plus the fetch's wall time, never the
                # window a successor shard's begin half ran in.)
                breaker.failure()
                metrics.note_solve_deadline()
                trace.note_degraded(
                    f"session solve exceeded deadline "
                    f"({solve_elapsed * 1e3:.0f} ms > "
                    f"{deadline * 1e3:.0f} ms)")
                log.warning("tpu-allocate solve took %.0f ms, over the "
                            "%.0f ms deadline", solve_elapsed * 1e3,
                            deadline * 1e3)
            else:
                breaker.success()

            # Apply placements in device-solve order through the columnar
            # batched path: end state (status indexes, node accounting,
            # plugin shares, gang dispatch) is identical to per-task
            # ssn.allocate/pipeline calls (Session.batch_apply_solved).
            apply_start = time.perf_counter()
            with trace.span("apply", placed=int(ordered.size)):
                if scaffold is None:
                    scaffold = prepare_apply_scaffold(snap)
                agg = build_apply_aggregates(snap, assignment, kind,
                                             ordered, scaffold=scaffold)
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

        finish.pending = pending
        return finish

    @staticmethod
    def _publish_read_fence(ssn, snap, empty: bool = False) -> None:
        """Stash this session's retire-phase node READ footprint for the
        shard pipeline's conflict fence: the union over pending task
        signatures of statically-feasible nodes.  Infeasible nodes can
        carry any state without changing the solve (their score is
        masked to -inf and they can never be the argmax), so a
        predecessor mutation outside this union provably leaves the
        optimistic result identical to the sequential arm's.  Sessions
        whose retire can read arbitrary node state — volumed tasks
        (global binder state), an unanswered BestEffort prescan (the
        backfill walk), any fallback — publish reads-all instead.

        Only pipelined sessions pay for this: outside the shard
        pipeline (the global engine, the CONCURRENT_SHARDS=0 control, a
        single dirty shard) nothing reads the fence, and the control
        arm must keep its exact per-session work profile."""
        import numpy as np
        if not ssn._pipeline_active:
            return
        if ssn._pipeline_fence is not None:
            # A begin-half footprint (tenancy/footprint.py) already
            # published the whole conf's bound — it is a superset of
            # this action's tasks-only union; keep it.
            return
        if empty:
            # No candidate tasks: the retire phase touches nodes only if
            # backfill places BestEffort work.
            if ssn.prescan.get("has_best_effort") is False:
                ssn._pipeline_fence = ((), None)
            else:
                ssn._pipeline_reads_all = True
            return
        try:
            if ssn.prescan.get("has_best_effort") is not False or any(
                    t.pod.spec.volumes for t in snap.tasks):
                ssn._pipeline_reads_all = True
                return
            p = len(snap.tasks)
            sigs = np.unique(np.asarray(snap.inputs.task_sig)[:p])
            mask = np.logical_or.reduce(
                np.asarray(snap.inputs.sig_mask)[sigs], axis=0)
            mask = mask & np.asarray(snap.inputs.node_exists)
            n = len(snap.node_names)
            ssn._pipeline_fence = (snap.node_names, mask[:n])
        except Exception:  # lint: allow-swallow(fence derivation is an optimization gate: an unknown footprint degrades to reads-all, which only forces a sequential rerun — counted, never wrong)
            metrics.note_swallowed("pipeline_fence")
            ssn._pipeline_reads_all = True

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
