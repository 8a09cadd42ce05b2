"""ShardPipeline: concurrent shard micro-sessions through the async
dispatch window (doc/TENANCY.md "Concurrent micro-sessions").

The tenancy engine used to pipeline dirty shards SEQUENTIALLY: a storm
dirtying M shards paid M back-to-back snapshot -> tensorize -> ship ->
dispatch -> device_wait -> fetch -> apply -> commit chains, even though
each shard owns its own persistent tensors, delta-ship image, and solver
state, and the device sits idle through every host phase.  This module
overlaps them: while shard K's solve executes on device, shard K+1 runs
its HOST half (ShardView snapshot, incremental tensorize, delta ship,
async dispatch) on the loop thread, bounded by
``KUBE_BATCH_TPU_SHARD_INFLIGHT`` (default 2) — so M dirty shards cost
~max(host, device) per shard instead of the sum.
``KUBE_BATCH_TPU_CONCURRENT_SHARDS=0`` is the bit-parity sequential
control.

Correctness contract (every clause pinned by the port's
tests/test_torch_concurrent_shards.py and chip_smoke's tenancy phase):

* **Retire order.**  Only the retire half (fetch -> validate -> apply ->
  commit flush -> remaining actions -> close) mutates the cluster, and
  retire halves run in ascending shard order — binds, events, victim
  order, and lineage samples sequence exactly as the sequential arm's.
  Events a begin half can emit (the snapshot's no-spec FailedScheduling
  replay) are captured in a thread-scoped defer window and flushed at
  that shard's retire slot.

* **Clone de-aliasing.**  Sessions share the cache's snapshot pool, so
  two in-flight sessions can hold THE SAME clone object for an unchanged
  node.  Every session mutation path dirties the node before touching it
  (``Session._dirty_node`` / ``_predeclare_nodes``), and the retiring
  session carries a hook that hands each still-in-flight successor a
  private ``snapshot_clone()`` of any aliased node first — a successor's
  session state stays bit-identical to its own snapshot no matter what
  its predecessors commit.

* **Conflict fence.**  A successor's snapshot predates its predecessors'
  commits; the sequential arm's snapshot would not.  The solve's outcome
  provably depends on node state only inside the union of its pending
  signatures' statically-feasible columns (infeasible nodes score -inf
  and can never be the argmax; fit/count/occupancy reads are masked the
  same way), so a predecessor mutation OUTSIDE a successor's feasible
  union leaves its optimistic result exactly the sequential one.  A
  mutation inside it — or any unbounded-footprint session (host
  fallback, BestEffort backfill, volumed tasks, non-default action
  lists) — marks the successor CONFLICTED: its dispatch is discarded and
  the shard reruns a fresh, fully-sequential session at its retire slot.
  Never wrong, only occasionally un-overlapped.

* **Lease fence.**  The retire half's egress goes through the same
  ShardView write fence as always: a lease lost mid-pipeline aborts that
  shard's egress at the first write and feeds the engine's per-shard
  backoff, exactly as the sequential arm does.

* **Drain.**  ``Scheduler.stop()`` requests a drain; the pipeline stops
  beginning new shards, abandons in-flight stages (dropping the device
  handle, re-marking the shard dirty), and stop() invalidates the
  resident images of anything still registered after the join — multiple
  outstanding device handles are part of the stop contract now.

Counterpart of kube_batch_tpu/tenancy/pipeline.py, copied whole.  On the
card the overlap is real on the device too: each shard's halves run on
its view's own CUDA stream (scheduler.py), so a successor's ship and
dispatch return while its predecessor's kernel still runs, and a
discarded dispatch finishes on its own stream with nothing waiting for
it.
"""

from __future__ import annotations

import logging
import threading
import time
from bisect import bisect_left
from typing import Dict, List, Optional

from .. import knobs
from ..metrics import metrics

log = logging.getLogger(__name__)

CONCURRENT_ENV = knobs.CONCURRENT_SHARDS.env
INFLIGHT_ENV = knobs.SHARD_INFLIGHT.env
DEFAULT_INFLIGHT = knobs.SHARD_INFLIGHT.default

# Actions whose retire-phase node reads are bounded by a published read
# fence: tpu-allocate publishes the sig-union from its own begin half,
# and confs led by an eviction or topology action get theirs from
# tenancy/footprint.py (candidate sig-union, plus the valid-coordinate
# mask for the box scan).  A conf is bounded only when EVERY action in
# it is on this list — one unfenced action walking arbitrary node state
# at retire makes the whole stage's footprint unbounded (still correct:
# any predecessor mutation then forces the sequential rerun).
_BOUNDED_ACTIONS = frozenset({"tpu-allocate", "backfill", "reclaim",
                              "preempt", "topo-allocate"})


class StaleSessionAbort(Exception):
    """Raised by a retire half that would have to degrade to the host
    fallback over a STALE snapshot: a predecessor committed mutations
    after this session's begin half snapshotted, the conflict fence let
    the session through because its solve provably could not observe
    them — but a fetch/validate failure now wants the unbounded-footprint
    host oracle, which CAN observe them.  Nothing has been mutated yet
    at the raise point, so the pipeline discards the session and reruns
    the shard fresh (sequential semantics), instead of letting the
    fallback place pods from pre-predecessor state."""


def concurrent_shards_enabled() -> bool:
    return knobs.CONCURRENT_SHARDS.enabled()


def shard_inflight_depth() -> int:
    """Pipeline depth from the environment — validated the shard_knobs
    way: a malformed value warns loudly and pins the default."""
    return knobs.SHARD_INFLIGHT.value()


class _Stage:
    """One shard micro-session between its begin and retire halves."""

    __slots__ = ("shard", "view", "handle", "deferred_events",
                 "fence_names", "fence_mask", "reads_all", "conflict",
                 "has_pending")

    def __init__(self, shard, view, handle):
        self.shard = shard
        self.view = view
        self.handle = handle
        self.deferred_events: list = []
        self.fence_names = None
        self.fence_mask = None
        self.reads_all = True
        self.conflict = False
        self.has_pending = False


class ShardPipeline:
    """Bounded-depth begin/retire pipeline over one engine's dirty
    shards.  All session work runs on the scheduler loop thread; the
    only concurrency is the device's own async dispatch — so no session
    state needs locking.  The in-flight registry is lock-guarded solely
    for Scheduler.stop()'s cross-thread drain inspection."""

    def __init__(self, engine, depth: Optional[int] = None):
        self.engine = engine
        self.scheduler = engine.scheduler
        self.depth = max(1, depth if depth is not None
                         else shard_inflight_depth())
        self._inflight: List[_Stage] = []  # scheduler loop thread only
        self._drain = threading.Event()
        self._registry_lock = threading.Lock()
        self._registry: Dict[int, _Stage] = {}  # guarded-by: _registry_lock
        names = tuple(a.name() for a in self.scheduler.actions)
        self._bounded_conf = bool(names) and all(
            n in _BOUNDED_ACTIONS for n in names)
        self._cycle_overlap = 0.0

    # -- stop()/drain coordination (any thread) --------------------------

    def request_drain(self) -> None:
        self._drain.set()

    def abandon_inflight(self) -> List[int]:
        """Cross-thread abandon for Scheduler.stop(): drop every
        registered device handle and invalidate the shard's resident
        ship image (a half-consumed dispatch must never seed a later
        delta baseline).  Returns the stuck shard ids.  Only touches
        registry state — the wedged loop thread owns the traces."""
        from ..models.shipping import resident_shipper
        with self._registry_lock:
            stages = list(self._registry.values())
            self._registry.clear()
        stuck = []
        for stage in stages:
            stuck.append(stage.shard)
            self._discard_handle(stage)
            try:
                resident_shipper(stage.view,
                                 self.scheduler.device).invalidate()
            except Exception:  # lint: allow-swallow(shutdown best-effort: a failed invalidate only forfeits the next delta ship's reuse; counted)
                metrics.note_swallowed("pipeline_abandon")
            metrics.note_shard_pipeline("abandoned")
            self.engine.churn.note_shard(stage.shard)
        return sorted(stuck)

    @staticmethod
    def _discard_handle(stage: _Stage) -> None:
        """Retire an unconsumed device handle from the in-flight ledger
        and drop the reference (the device completes the work on its
        own; the buffer is garbage)."""
        pending = getattr(stage.handle.cont, "pending", None)
        stage.handle.cont = None
        if pending is not None:
            from ..ops.solver import discard_solve
            discard_solve(pending)

    def _register(self, stage: _Stage) -> None:
        with self._registry_lock:
            self._registry[stage.shard] = stage

    def _unregister(self, stage: _Stage) -> Optional[_Stage]:
        with self._registry_lock:
            return self._registry.pop(stage.shard, None)

    # -- one loop iteration ----------------------------------------------

    def run(self, shards: List[int]) -> None:
        """Pipeline one iteration's shard set.  Failure isolation is the
        engine's per-shard backoff, exactly as the sequential arm; this
        method never raises."""
        import gc
        engine = self.engine
        self._cycle_overlap = 0.0
        high_water = 1
        begun = set()
        gc_was_enabled = gc.isenabled()
        if gc_was_enabled:
            gc.disable()
        try:
            for shard in shards:
                if self._drain.is_set():
                    break
                while len(self._inflight) >= self.depth:
                    self._retire_next()
                begun.add(shard)
                stage = self._begin(shard)
                if stage is not None:
                    self._inflight.append(stage)
                    self._register(stage)
                    high_water = max(high_water, len(self._inflight))
            while self._inflight:
                if self._drain.is_set():
                    self._abandon_rest("drain")
                    break
                self._retire_next()
        finally:
            if self._inflight:
                # Defensive: a bug escaping _retire_next must not leak
                # suspended traces or device handles into the next
                # iteration.
                self._abandon_rest("pipeline_error")
            if gc_was_enabled:
                gc.enable()
            metrics.set_shard_cycle_stats(self._cycle_overlap, high_water)
        if self._drain.is_set():
            # Shards the drain cut off stay dirty for the next start.
            for shard in shards:
                if shard not in begun:
                    engine.churn.note_shard(shard)

    # -- begin half --------------------------------------------------------

    def _begin(self, shard: int) -> Optional[_Stage]:
        engine = self.engine
        view = engine.views[shard]
        engine._last_run[shard] = time.time()
        overlapping = any(s.has_pending for s in self._inflight)
        events = getattr(view, "events", None)
        defer = getattr(events, "begin_defer", None)
        if defer is not None:
            defer()
        begin_start = time.perf_counter()
        try:
            handle = self.scheduler.begin_shard_session(view, shard=shard)
        except Exception:  # per-shard failure isolation, begin half
            engine._note_shard_failure(shard)
            deferred = (events.end_defer() if defer is not None else [])
            if deferred:
                # The partial snapshot's events must not vanish: the
                # sequential arm's failed session leaves them in the
                # stream too.  (Their slot can lead a predecessor's
                # commit events — on the failure path the retry cadence
                # already diverges from the control.)
                events.extend(deferred)
            return None
        finally:
            deferred = (events.end_defer() if defer is not None else [])
        elapsed = time.perf_counter() - begin_start
        stage = _Stage(shard, view, handle)
        stage.deferred_events = deferred
        stage.has_pending = getattr(handle.cont, "pending", None) is not None
        ssn = handle.ssn
        if self._bounded_conf and not ssn._pipeline_reads_all \
                and ssn._pipeline_fence is not None:
            stage.fence_names, stage.fence_mask = ssn._pipeline_fence
            stage.reads_all = False
        metrics.note_shard_pipeline("begun")
        if overlapping:
            # The whole begin half ran inside a predecessor's in-flight
            # dispatch window: the host time the tentpole reclaims.
            self._cycle_overlap += elapsed
            metrics.note_shard_overlap(elapsed)
            metrics.note_shard_pipeline("overlapped")
        # Pipeline meta on the (suspended) session trace: /debug/sessions
        # shows whether this session's begin half overlapped a
        # predecessor's dispatch window and at what in-flight depth.
        if handle.trace_obj is not None:
            handle.trace_obj.meta["pipeline"] = {
                "overlapped": bool(overlapping),
                "inflight": len(self._inflight) + 1,
                "begin_ms": round(elapsed * 1e3, 3)}
        return stage

    # -- retire half -------------------------------------------------------

    def _retire_next(self) -> None:
        stage = self._inflight.pop(0)
        self._unregister(stage)
        engine = self.engine
        if stage.conflict:
            # The rerun's fresh snapshot re-emits everything the
            # discarded begin half's snapshot emitted (the no-spec
            # replay fires on EVERY walk), so the deferred copies must
            # be DROPPED — replaying them would double the events
            # versus the sequential arm.
            stage.deferred_events = []
            self._rerun(stage)
            return
        events = getattr(stage.view, "events", None)
        if stage.deferred_events and events is not None:
            # Replay the begin half's captured events at this retire
            # slot: the sequence now matches the sequential arm's
            # (predecessors' commit events first, then this shard's
            # snapshot events, then its own commit events).
            events.extend(stage.deferred_events)
            stage.deferred_events = []
        ssn = stage.handle.ssn
        ssn._dirty_node_hook = self._dealias_guard(ssn)
        try:
            self.scheduler.finish_shard_session(stage.handle)
        except StaleSessionAbort:
            # The retire half would have run the host fallback over a
            # stale snapshot: nothing was mutated (the abort fires
            # before any session mutation) and the device handle was
            # already consumed by the failed fetch — rerun the shard
            # fresh, exactly like a fence conflict.  The begin half's
            # deferred events were already flushed above, so the rerun
            # must DROP its own snapshot's duplicates (the mirror image
            # of the conflict path, which drops the deferred copies and
            # keeps the rerun's).
            ssn._dirty_node_hook = None
            stage.handle.cont = None  # consumed: no discard
            metrics.note_shard_pipeline("conflict_rerun")
            self._run_fresh(stage, drop_begin_events=True)
            return
        except Exception:  # per-shard failure isolation, retire half
            engine._note_shard_failure(stage.shard)
        else:
            engine._note_shard_ok(stage.shard, stage.view)
        finally:
            ssn._dirty_node_hook = None
        self._fence_successors(ssn)

    def _rerun(self, stage: _Stage) -> None:
        """A predecessor's commit invalidated this stage's optimistic
        work: discard the begun session (fetch-and-discard — the device
        handle is simply dropped; the resident image is still the valid
        post-ship baseline) and rerun the shard as ONE fresh sequential
        session at its retire slot.  Every predecessor has retired, so
        the fresh snapshot sees exactly the state the sequential arm
        would — parity by construction."""
        metrics.note_shard_pipeline("conflict_rerun")
        self._discard_handle(stage)
        self.scheduler.abandon_shard_session(stage.handle,
                                             "predecessor_conflict")
        self._run_fresh(stage)

    def _run_fresh(self, stage: _Stage,
                   drop_begin_events: bool = False) -> None:
        """One fresh, fully-sequential session for a discarded stage's
        shard, at its retire slot — every predecessor has retired, so
        the new snapshot sees exactly the sequential arm's state.
        ``drop_begin_events``: the discarded session's snapshot events
        were already flushed into the stream (the stale-abort path), so
        the rerun's identical re-emissions are captured and dropped."""
        engine = self.engine
        events = getattr(stage.view, "events", None)
        defer = (getattr(events, "begin_defer", None)
                 if drop_begin_events else None)
        if defer is not None:
            defer()
        try:
            handle = self.scheduler.begin_shard_session(stage.view,
                                                        shard=stage.shard)
        except Exception:
            engine._note_shard_failure(stage.shard)
            return
        finally:
            if defer is not None:
                events.end_defer()  # discard the duplicates
        ssn = handle.ssn
        ssn._dirty_node_hook = self._dealias_guard(ssn)
        try:
            self.scheduler.finish_shard_session(handle)
        except Exception:
            engine._note_shard_failure(stage.shard)
        else:
            engine._note_shard_ok(stage.shard, stage.view)
        finally:
            ssn._dirty_node_hook = None
        self._fence_successors(ssn)

    def _abandon_rest(self, reason: str) -> None:
        for stage in self._inflight:
            self._unregister(stage)
            self._discard_handle(stage)
            try:
                self.scheduler.abandon_shard_session(stage.handle, reason)
            except Exception:  # lint: allow-swallow(abandon is last-resort cleanup on the error/drain path; a failed trace finalize must not mask the original failure; counted)
                metrics.note_swallowed("pipeline_abandon")
            metrics.note_shard_pipeline("abandoned")
            # The churn that asked for this session is not absorbed.
            self.engine.churn.note_shard(stage.shard)
        self._inflight = []

    # -- successor protection ---------------------------------------------

    def _dealias_guard(self, ssn):
        """The retiring session's pre-mutation hook: before it first
        touches node ``name``, hand an in-flight successor holding THE
        SAME pooled clone a private bit-identical copy IF the
        successor's read fence covers the node — so the successor's
        retire half still reads its own snapshot's state.

        Fence-scoped on purpose: a mutation OUTSIDE a successor's fence
        is unobservable by its retire half (the fence IS the complete
        enumeration of its node reads — a successor only ever resolves
        nodes it places on or fit-checks, all inside its feasible
        union), and a mutation INSIDE the fence flags the successor for
        the sequential rerun, which discards its session outright.
        Cloning only fence-covered names keeps the object-integrity
        invariant airtight for the case that matters (the flagged
        successor's state stays pristine until its discard) without
        paying one snapshot_clone per placed node per successor on the
        common no-conflict path.  reads_all successors are skipped for
        the same reason: ANY mutation flags them, so their session
        state is never consumed."""
        inflight = self._inflight  # live list: successors only

        def on_dirty(names):
            mine_nodes = ssn.nodes
            for name in names:
                mine = mine_nodes.get(name)
                if mine is None:
                    continue
                for stage in inflight:
                    if stage.reads_all or stage.conflict:
                        continue
                    if not self._fence_hit(stage, (name,)):
                        continue
                    succ_nodes = stage.handle.ssn.nodes
                    if succ_nodes.get(name) is mine:
                        succ_nodes[name] = mine.snapshot_clone()

        return on_dirty

    def _fence_successors(self, ssn) -> None:
        """Compare what the retired session mutated against every
        in-flight successor's read fence; a hit (or an unbounded
        successor footprint) flags the successor for the sequential
        rerun.  ``ssn.mutated_nodes`` over-approximates the truth
        mutations (session-only pipelines are included) — an
        over-approximation only costs an extra rerun, never parity."""
        mutated = ssn.mutated_nodes
        if not mutated:
            return
        for stage in self._inflight:
            # STALE regardless of the fence verdict: if this successor's
            # retire half unexpectedly degrades to the host fallback
            # (fetch/validate failure), its unbounded footprint could
            # observe these mutations — tpu-allocate checks the flag at
            # that point and aborts for the sequential rerun instead.
            stage.handle.ssn._pipeline_stale = True
            if stage.conflict:
                continue
            if stage.reads_all or self._fence_hit(stage, mutated):
                stage.conflict = True

    @staticmethod
    def _fence_hit(stage: _Stage, mutated) -> bool:
        names = stage.fence_names
        mask = stage.fence_mask
        if not names or mask is None:
            return False  # empty footprint: nothing the retire reads
        n = len(names)
        for name in mutated:
            ix = bisect_left(names, name)  # node_names is sorted
            if ix < n and names[ix] == name and mask[ix]:
                return True
        return False
