"""Scheduler: the periodic session loop (L5) and its configuration.

Counterpart of kube_batch_tpu/scheduler.py (kube-batch's
pkg/scheduler/scheduler.go Run/runOnce every schedule-period, and util.go
YAML conf loading).  ``Scheduler`` runs one session per cycle over the
whole cache, or, with ``KUBE_BATCH_TPU_TENANCY`` set, one micro-session
per dirty queue-shard through the tenancy engine (tenancy/), pipelined
through each other's device windows under
``KUBE_BATCH_TPU_CONCURRENT_SHARDS``.

The scheduler owns its device and float key type, as the actions do:
CUDA unless the caller asks for the CPU (``Scheduler(cache)`` raises
without CUDA), float32 unless it asks for float64; it registers the
default actions with them.  On the card every session over a shard view
runs its device work on that view's own CUDA stream (tenancy/view.py,
given by the tenancy engine): ``session_once`` with a shard and the
three halves ``begin_shard_session``, ``finish_shard_session`` and
``abandon_shard_session``.  The global engine's sessions work on the
current stream.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import List, Optional, Tuple

import torch

from . import knobs
from .chaos import plan as chaos_plan
from .conf import (SchedulerConfiguration, Tier, apply_plugin_conf_defaults,
                   configuration_from_dict)
from .device import check_float_dtype, resolve_device
from .framework import Action, close_session, get_action, open_session
from .metrics import metrics
from .trace import spans as trace

log = logging.getLogger(__name__)

# Crash-loop backoff cap (seconds): consecutive failing cycles double the
# loop delay up to this bound, so a persistently bad cycle (dead
# apiserver, wedged device) cannot hot-loop at schedule_period.
MAX_CYCLE_BACKOFF_ENV = knobs.MAX_CYCLE_BACKOFF_S.env
_DEF_MAX_CYCLE_BACKOFF_S = knobs.MAX_CYCLE_BACKOFF_S.default

# Event-driven micro-sessions (doc/INCREMENTAL.md): cache churn wakes the
# loop early; a woken loop sleeps this coalescing window first so one
# informer burst becomes one micro-session instead of N.  Milliseconds.
COALESCE_MS_ENV = knobs.COALESCE_MS.env
_DEF_COALESCE_MS = knobs.COALESCE_MS.default

# The shipped default pipeline puts the device action first: tpu-allocate
# solves the allocate loop on the CUDA card and runs the host allocate
# path only where the session can't be tensorized
# (actions/tpu_allocate.py).  The reference's default is the host pair
# ``allocate, backfill`` (util.go:31-42); behavior is identical by the
# parity suite — only the engine differs.
DEFAULT_SCHEDULER_CONF = """
actions: "tpu-allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


def parse_scheduler_conf(conf_str: str) -> SchedulerConfiguration:
    """The YAML conf as a SchedulerConfiguration, plugin enable flags
    defaulted, actions not yet resolved (the first half of
    ``load_scheduler_conf``)."""
    try:
        import yaml
        data = yaml.safe_load(conf_str) or {}
    except ImportError:  # fall back to a micro-parser for the default shape
        data = _mini_yaml(conf_str)

    conf = configuration_from_dict(data)
    for tier in conf.tiers:
        for option in tier.plugins:
            apply_plugin_conf_defaults(option)
    return conf


def load_scheduler_conf(conf_str: str) -> Tuple[List[Action], List[Tier]]:
    """Parse the YAML conf into (actions, tiers) (reference
    scheduler/util.go:44-73).  Every action must be registered
    (actions/factory.py registers allocate, preempt, reclaim, backfill
    and tpu-allocate); an unknown name raises KeyError.  The default conf
    loads whole, and so does the shipped four-action conf
    (config/kube-batch-conf.yaml) with tpu-allocate in place of
    allocate."""
    conf = parse_scheduler_conf(conf_str)
    actions = []
    for name in conf.actions.split(","):
        action = get_action(name.strip())
        if action is None:
            raise KeyError(f"failed to find Action {name.strip()}")
        actions.append(action)
    return actions, conf.tiers


def _mini_yaml(conf_str: str) -> dict:
    """Tiny parser for the conf subset (actions + tiers/plugins/name).

    Only the default conf shape is representable without PyYAML.  Any other
    construct (``arguments:``, ``enabled*`` flags, nested maps...) would
    silently degrade to bare plugin names — a scheduler quietly running a
    different policy than configured — so anything unrecognized raises
    instead (the reference always has yaml.v2; this fallback must never be
    *less* strict than it)."""
    data: dict = {"actions": "", "tiers": []}
    tier = None
    for raw in conf_str.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("actions:"):
            data["actions"] = line.split(":", 1)[1].strip().strip('"')
        elif line == "tiers:":
            continue
        elif line.startswith("- plugins:"):
            tier = {"plugins": []}
            data["tiers"].append(tier)
        elif line.startswith("- name:") and tier is not None:
            tier["plugins"].append({"name": line.split(":", 1)[1].strip()})
        else:
            raise ValueError(
                "scheduler conf uses constructs beyond the default shape "
                f"(line {raw!r}); install PyYAML to parse it — refusing to "
                "silently drop configuration")
    return data


class _ShardSessionHandle:
    """One shard micro-session paused between its host half and its
    retire half (doc/TENANCY.md "Concurrent micro-sessions")."""

    __slots__ = ("ssn", "shard", "cont", "resume_idx", "action_elapsed",
                 "start", "trace_obj")

    def __init__(self, ssn, shard, cont, resume_idx, action_elapsed,
                 start):
        self.ssn = ssn
        self.shard = shard
        self.cont = cont
        self.resume_idx = resume_idx
        self.action_elapsed = action_elapsed
        self.start = start
        self.trace_obj = None


class Scheduler:
    """Periodic runner (scheduler.go:33-102).  ``device`` and ``dtype``
    are the device and float key type of the default actions it
    registers (CUDA unless the caller passes the CPU; raises without
    CUDA)."""

    def __init__(self, cache, scheduler_conf: Optional[str] = None,
                 schedule_period: float = 1.0, device=None,
                 dtype: torch.dtype = torch.float32):
        from .actions.factory import register_default_actions
        from .plugins.factory import register_default_plugins
        self.device = resolve_device(device)
        self.dtype = check_float_dtype(dtype)
        register_default_actions(device=self.device, dtype=self.dtype)
        register_default_plugins()

        self.cache = cache
        self.schedule_period = schedule_period
        self.actions, self.tiers = load_scheduler_conf(
            scheduler_conf or DEFAULT_SCHEDULER_CONF)
        self._stop = threading.Event()
        # Churn wakeup (event-driven micro-sessions, doc/INCREMENTAL.md):
        # the cache's external ingestion paths set this; the loop then
        # runs its next cycle immediately instead of sleeping out the
        # remaining schedule_period.  stop() also sets it so shutdown
        # never waits out a sleeping loop.
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seen_errors: set = set()
        # Crash-loop backoff state (loop thread only): consecutive failed
        # run_once calls; resets to 0 on the first healthy cycle.
        self._consecutive_failures = 0
        # Periodic full-session floor: every K cycles the loop forces a
        # full (non-incremental) rebuild so micro-session drift cannot
        # accumulate unrevalidated (models/incremental.py).
        self._cycles_since_full = 0
        self._force_full_pending = False  # consumed by the tenancy engine
        self._max_backoff = knobs.MAX_CYCLE_BACKOFF_S.value()
        self._coalesce_s = knobs.COALESCE_MS.value() / 1e3
        # Periodic memory-ledger audit (doc/OBSERVABILITY.md "Memory
        # ledger"): every N cycles reconcile the byte ledgers against
        # their stores — tolerant (log, don't raise): the audit races
        # reflector threads, and a leak must not kill the loop.
        self._mem_audit_every = knobs.MEM_AUDIT_EVERY.value()
        self._cycles_since_mem_audit = 0
        # Log<->trace correlation: every loop record carries [s=<id>]
        # while a traced session is active (doc/OBSERVABILITY.md).
        trace.install_log_correlation()
        # Queue-shard tenancy engine (kube_batch_tpu/tenancy/,
        # doc/TENANCY.md): when KUBE_BATCH_TPU_TENANCY asks for shards,
        # run_once pipelines one shard-scoped micro-session per dirty
        # shard instead of one global cycle.  None = the single global
        # engine (the bit-parity control arm).  Embedders (ServerRuntime
        # federation wiring, the replica soak) may replace it with an
        # engine carrying a ShardLeaseManager.
        from .tenancy import engine_from_env
        self.tenancy = engine_from_env(self)

    def _log_cycle_error(self, stage: str) -> None:
        """Count and log a swallowed loop exception.  The counter moves on
        every occurrence (a persistently failing cycle is visible on
        /metrics); the traceback is logged once per DISTINCT error —
        (stage, type, message, raise site) — so a wedged dependency can't
        flood the log at one line per schedule period."""
        import sys
        import traceback

        metrics.inc_scheduler_loop_error(stage)
        etype, exc, tb = sys.exc_info()
        frames = traceback.extract_tb(tb)
        site = (frames[-1].filename, frames[-1].lineno) if frames else None
        key = (stage, getattr(etype, "__name__", ""), str(exc), site)
        if key in self._seen_errors:
            return
        if len(self._seen_errors) >= 128:
            # Messages can embed per-occurrence data (pod names, ids); a
            # flapping dependency must not grow the dedup set — or the
            # log — without bound.  The counter keeps moving regardless.
            return
        self._seen_errors.add(key)
        log.error("scheduler %s failed (repeats of this error are counted "
                  "but not re-logged):\n%s", stage, traceback.format_exc())

    def run_once(self) -> None:
        """One scheduling cycle (scheduler.go:88-102): the global
        session, or — with the tenancy engine active — one shard-scoped
        micro-session per dirty shard (doc/TENANCY.md)."""
        if self.tenancy is not None:
            force_full, self._force_full_pending = \
                self._force_full_pending, False
            self.tenancy.run_cycle(force_full=force_full)
            return
        self.session_once(self.cache)

    def _device_stream(self, cache, shard):
        """The stream context a session's device work runs in: a shard
        view's own CUDA stream (``ShardView.stream``) on the card, else
        the current stream (the global engine, the CPU).
        Entering it never synchronizes: the ship, the candidate gather,
        the kernel launch, the pinned readback and its event, the
        eviction scanner and the box scan all go to that stream, so a
        shard's begin half never queues behind another shard's kernel."""
        stream = getattr(cache, "stream", None) if shard is not None \
            else None
        if stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(stream)

    def session_once(self, cache, shard=None) -> None:
        """One scheduling session over ``cache`` (the whole cluster, or
        a tenancy ShardView scoping it to one queue-shard).

        The cyclic GC pauses while a cycle runs: a 50k-task session creates
        millions of (acyclic — refcount-freed) objects, and collector scans
        mid-cycle add hundreds of ms of jitter at kubemark scale.  Python's
        analog of tuning the Go GC for the scheduling loop."""
        import gc
        gc_was_enabled = gc.isenabled()
        if gc_was_enabled:
            gc.disable()
        start = time.time()
        trace.begin_session(actions=[a.name() for a in self.actions])
        try:
            with self._device_stream(cache, shard):
                with trace.span("open_session"):
                    ssn = open_session(cache, self.tiers)
                # The reference's fused session dispatch reads the conf's
                # action ladder from here (ROADMAP queue 1 item 4).
                ssn._conf_actions = tuple(a.name() for a in self.actions)
                trace.set_uid(ssn.uid)
                trace.set_meta(jobs=len(ssn.jobs), nodes=len(ssn.nodes),
                               queues=len(ssn.queues))
                if shard is not None:
                    trace.set_meta(shard=shard)
                try:
                    for action in self.actions:
                        action_start = time.time()
                        with trace.span("action." + action.name()):
                            action.execute(ssn)
                        metrics.observe_action_latency(
                            action.name(), time.time() - action_start)
                finally:
                    with trace.span("close_session"):
                        close_session(ssn)
                    # Residual-floor attribution on /debug/sessions: what
                    # this cycle paid per formerly-O(N) stage, plus the
                    # O(N)-work counters (doc/INCREMENTAL.md "floors").
                    trace.set_meta(floors=metrics.cycle_floor_values(),
                                   onwork=metrics.onwork_values(),
                                   dispatches=metrics.take_cycle_dispatches())
        finally:
            trace.end_session()
            if gc_was_enabled:
                gc.enable()
        metrics.observe_e2e_latency(time.time() - start)

    # ------------------------------------------------------------------
    # Split session halves for the concurrent shard pipeline
    # (tenancy/pipeline.py, doc/TENANCY.md "Concurrent micro-sessions").
    # session_once stays the exact sequential composition — the
    # KUBE_BATCH_TPU_CONCURRENT_SHARDS=0 control arm never touches these.

    def begin_shard_session(self, cache, shard=None):
        """First half of a shard micro-session: open + the leading
        action's host phases (snapshot, tensorize, ship, async dispatch).
        Suspends the session's trace so other shards' halves can
        interleave on this thread; ``finish_shard_session`` retires it.
        GC posture is the caller's (the pipeline disables collection
        around the whole pipelined iteration).  Raises like session_once
        would — the caller owns failure isolation."""
        with self._device_stream(cache, shard):
            handle = None
            start = time.time()
            trace.begin_session(actions=[a.name() for a in self.actions])
            try:
                with trace.span("open_session"):
                    ssn = open_session(cache, self.tiers)
                # Fence derivation and stale tracking apply to pipelined
                # sessions only (tpu_allocate._publish_read_fence gates on
                # this, keeping the sequential control's work profile
                # exact).
                ssn._pipeline_active = True
                ssn._conf_actions = tuple(a.name() for a in self.actions)
                trace.set_uid(ssn.uid)
                trace.set_meta(jobs=len(ssn.jobs), nodes=len(ssn.nodes),
                               queues=len(ssn.queues))
                if shard is not None:
                    trace.set_meta(shard=shard)
                try:
                    cont = None
                    resume_idx = 0
                    action_elapsed = 0.0
                    if self.actions:
                        action = self.actions[0]
                        begin = getattr(action, "execute_begin", None)
                        if begin is not None:
                            action_start = time.time()
                            with trace.span("action." + action.name()):
                                cont = begin(ssn)
                            action_elapsed = time.time() - action_start
                            resume_idx = 1
                    # Confs whose leading action has no begin half still
                    # publish a bounded read fence (tenancy/footprint.py);
                    # an eviction-led conf builds its shared scanner here,
                    # on this shard's stream.
                    from .tenancy.footprint import publish_begin_footprint
                    publish_begin_footprint(ssn, ssn._conf_actions,
                                            self.device, self.dtype)
                except Exception:
                    # Mirror session_once's finally: an action exception
                    # after a successful open still closes the session
                    # (plugin closes, status writeback, incremental close
                    # bookkeeping) before the failure reaches the caller's
                    # per-shard isolation — the control arm's failure path.
                    with trace.span("close_session"):
                        close_session(ssn)
                    raise
                handle = _ShardSessionHandle(ssn, shard, cont, resume_idx,
                                             action_elapsed, start)
                return handle
            finally:
                suspended = trace.suspend_session()
                if handle is not None:
                    handle.trace_obj = suspended
                else:
                    # The begin half died: finalize the trace here so the
                    # recorder still sees the partial session, then let the
                    # exception reach the caller's failure isolation.
                    trace.resume_session(suspended)
                    trace.end_session()

    def finish_shard_session(self, handle) -> None:
        """Retire half: device fetch + validate + apply/commit (the
        begin half's continuation), the remaining actions, and
        close_session — the only part of a micro-session that mutates
        the cluster, so the pipeline runs it in deterministic shard
        order."""
        with self._device_stream(handle.ssn.cache, handle.shard):
            from .tenancy.pipeline import StaleSessionAbort
            trace.resume_session(handle.trace_obj)
            handle.trace_obj = None
            ssn = handle.ssn
            stale_abort = False
            try:
                try:
                    if handle.resume_idx:
                        action = self.actions[0]
                        if handle.cont is not None:
                            action_start = time.time()
                            with trace.span("action." + action.name()):
                                handle.cont()
                            handle.action_elapsed += time.time() - action_start
                        metrics.observe_action_latency(action.name(),
                                                       handle.action_elapsed)
                    for action in self.actions[handle.resume_idx:]:
                        action_start = time.time()
                        with trace.span("action." + action.name()):
                            action.execute(ssn)
                        metrics.observe_action_latency(
                            action.name(), time.time() - action_start)
                except StaleSessionAbort:
                    # The retire half aborted BEFORE mutating anything (see
                    # tenancy/pipeline.StaleSessionAbort): the pipeline
                    # reruns the shard fresh, so this session must NOT run
                    # its remaining actions or close (a close would emit
                    # events/status writes the rerun emits again).
                    stale_abort = True
                    # The reference finalizes its fused session dispatch
                    # here (fused_solver.finalize_session); the port has
                    # none until ROADMAP queue 1 item 4.  The stale fetch
                    # already consumed the session's pending dispatch.
                    trace.set_meta(pipeline_discarded="stale_fallback")
                    raise
                finally:
                    if not stale_abort:
                        with trace.span("close_session"):
                            close_session(ssn)
                        trace.set_meta(
                            floors=metrics.cycle_floor_values(),
                            onwork=metrics.onwork_values(),
                            dispatches=metrics.take_cycle_dispatches())
            finally:
                trace.end_session()
            metrics.observe_e2e_latency(time.time() - handle.start)

    def abandon_shard_session(self, handle, reason: str) -> None:
        """Discard a begun-but-not-retired micro-session (conflict
        rerun, drain, shutdown): finalize its trace with the discard
        reason and drop the device handle WITHOUT applying anything —
        the session never reached its mutating half, so nothing needs
        rolling back."""
        with self._device_stream(handle.ssn.cache, handle.shard):
            trace.resume_session(handle.trace_obj)
            handle.trace_obj = None
            # The reference finalizes its fused session dispatch here
            # (fused_solver.finalize_session; ROADMAP queue 1 item 4).
            # The session's own pending solve is retired by the
            # pipeline's _discard_handle before it calls this.
            trace.note_degraded(f"shard pipeline discarded session: {reason}")
            trace.set_meta(pipeline_discarded=reason)
            trace.end_session()

    def cycle(self, force_full: bool = False) -> bool:
        """One protected loop iteration: run_once + the repair workers,
        never raising — the loop-survival contract (scheduler.go:63-86),
        driven directly by the loop thread and by tools/chaos_soak.py.
        Returns False when the scheduling cycle itself failed; consecutive
        failures drive the crash-loop backoff (_cycle_delay).

        ``force_full``: request a full (non-incremental) tensorize for
        this cycle — the loop's periodic full-session floor; micro
        cycles run the incremental path, full cycles revalidate it."""
        ok = True
        try:
            # Drain lazily-deferred remote mirror frames before the
            # cycle observes the cache: the tenancy engine's shard walk
            # reads mirror state outside snapshot(), so the flush must
            # happen at the cycle top, not just inside snapshot().
            flush = getattr(self.cache, "mirror_flush", None)
            if flush is not None:
                flush()
            if force_full:
                from .models import incremental
                incremental.request_full(self.cache)
                # The tenancy engine reads (and clears) this flag to run
                # its full pass; a flag instead of a run_once kwarg so
                # test doubles that replace run_once with a bare
                # callable keep working.
                self._force_full_pending = True
            self.run_once()
        except Exception:  # loop must survive a bad cycle
            ok = False
            metrics.register_schedule_attempt("error")
            metrics.note_cycle_failure("cycle")
            self._log_cycle_error("cycle")
        # Repair workers (cache.go:357-378: resync + cleanup run
        # alongside the scheduling loop).
        try:
            self.cache.process_cleanup_jobs()
            self.cache.process_resync_tasks(
                getattr(self.cache.binder, "cluster", None))
        except Exception:  # repair must survive too — but visibly
            metrics.note_cycle_failure("repair")
            self._log_cycle_error("repair")
        if ok:
            if self._consecutive_failures:
                self._consecutive_failures = 0
                metrics.set_degraded("cycle_backoff", False)
        else:
            self._consecutive_failures += 1
            metrics.set_degraded("cycle_backoff", True)
        if chaos_plan.PLAN is not None:
            # The soak's survival ledger: this cycle completed (healthy
            # or degraded) with a fault plan active.
            metrics.note_chaos_survived()
        if self._mem_audit_every > 0:
            self._cycles_since_mem_audit += 1
            if self._cycles_since_mem_audit >= self._mem_audit_every:
                self._cycles_since_mem_audit = 0
                from .metrics import memledger
                report = memledger.audit_mem_ledgers(raise_on_drift=False)
                drift = report.get("_drift")
                if drift:
                    log.error("memory ledger drift: %s",
                              "; ".join(drift["failures"]))
        return ok

    def _cycle_delay(self, elapsed: float) -> float:
        """Delay before the next cycle: schedule_period normally; doubled
        per consecutive failed cycle, capped at MAX_CYCLE_BACKOFF (and
        never below schedule_period), reset by the next success."""
        period = self.schedule_period
        if self._consecutive_failures:
            cap = max(self._max_backoff, period)
            # Exponent clamped: 2.0**n raises OverflowError past ~1024,
            # and an unbounded counter WOULD get there (~9 h of a dead
            # apiserver at the 30 s cap) — killing the loop thread from
            # inside the backoff calculation would break the exact
            # loop-survival contract this path exists for.
            doubling = 2.0 ** min(self._consecutive_failures, 32)
            period = min(period * doubling, cap)
        return period - elapsed

    def run(self) -> None:
        """Start the wait.Until-style loop in a background thread
        (scheduler.go:63-86).  The loop is event-driven: cache churn
        (informer ingestion) wakes it early for a micro-session instead
        of waiting out schedule_period; a short coalescing window turns
        an informer burst into one cycle; and every
        ``KUBE_BATCH_TPU_FULL_EVERY`` cycles a full session revalidates
        the incremental state (doc/INCREMENTAL.md)."""
        self.cache.run()
        self.cache.wait_for_cache_sync()
        # Install the churn wakeup on caches that support it (the
        # SchedulerCache's external ingestion paths set it; foreign cache
        # implementations without the attribute keep the fixed period).
        try:
            self.cache.churn_event = self._wake
        except AttributeError:  # lint: allow-swallow(read-only cache object: the loop degrades to the fixed schedule_period, which is the pre-incremental behavior)
            pass
        # Move the synced long-lived cache out of the collector's scan set
        # (see run_once's GC note).
        import gc
        gc.collect()
        gc.freeze()

        from .models.incremental import full_session_every
        full_every = full_session_every()

        def loop():
            while not self._stop.is_set():
                cycle_start = time.time()
                # Clear BEFORE the cycle: churn arriving while it runs
                # re-sets the event and the next wait returns at once,
                # so no delta is ever silently absorbed into a sleep.
                self._wake.clear()
                force_full = bool(full_every) and \
                    self._cycles_since_full + 1 >= full_every
                self.cycle(force_full=force_full)
                self._cycles_since_full = \
                    0 if force_full else self._cycles_since_full + 1
                delay = self._cycle_delay(time.time() - cycle_start)
                if delay <= 0:
                    continue
                if self._consecutive_failures:
                    # Crash-loop backoff must not be bypassed by churn:
                    # a dead apiserver plus a watch storm would
                    # otherwise hot-loop the failing cycle.
                    self._stop.wait(delay)
                elif self._wake.wait(delay) and not self._stop.is_set():
                    # Churn wakeup: coalesce the burst, then run the
                    # micro-session.  schedule_period expiry (False)
                    # falls through to the periodic revalidation cycle.
                    if self._coalesce_s > 0:
                        self._stop.wait(self._coalesce_s)

        # Start BEFORE publishing: run() may execute on an elector
        # callback thread while stop() runs on the main thread (HA
        # shutdown), and joining a created-but-unstarted thread raises.
        # A stop() that misses the publish is still safe — _stop is set,
        # so the (daemon) loop exits at its first check.
        thread = threading.Thread(target=loop, daemon=True)
        thread.start()
        self._thread = thread

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        # Wake a sleeping loop immediately: without this, stop() blocks
        # until the remaining schedule_period (or the full crash-loop
        # backoff delay) elapses before the loop re-checks _stop.
        self._wake.set()
        # Concurrent shard pipeline: ask the loop thread to stop issuing
        # new shard dispatches and drain what is in flight before it
        # exits (the pipeline checks this between stages) — the stop
        # contract now covers multiple outstanding device handles
        # (doc/TENANCY.md "Concurrent micro-sessions").
        tenancy = getattr(self, "tenancy", None)
        if tenancy is not None:
            tenancy.request_drain()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout)
            if thread.is_alive():
                # A wedged mid-cycle call (device tunnel, binder RPC)
                # cannot be interrupted from here; the daemon thread
                # won't block process exit, but a silent return would
                # leave the wedge undiagnosable.
                log.warning(
                    "scheduler loop thread still running %.1fs after "
                    "stop(); a cycle is wedged — the daemon thread will "
                    "be abandoned at process exit", timeout)
        if tenancy is not None:
            # Anything still registered in flight means the loop never
            # reached its own drain (wedged mid-pipeline): abandon each
            # stage — drop the device handle, invalidate that shard's
            # resident ship image so a half-consumed dispatch can never
            # seed a future delta baseline — and name the stuck shards.
            stuck = tenancy.abandon_inflight()
            if stuck:
                log.warning(
                    "scheduler stop(): abandoned %d in-flight shard "
                    "dispatch(es) with resident images invalidated — "
                    "stuck shard id(s): %s",
                    len(stuck), ", ".join(str(s) for s in stuck))
