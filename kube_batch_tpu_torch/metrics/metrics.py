"""Scheduler metrics: a small dependency-free Prometheus-style registry.

Keeps the reference's collector set and names
(kube-batch pkg/scheduler/metrics/metrics.go:27-121, subsystem
``kube_batch``): e2e/plugin/action/task latency histograms,
schedule_attempts_total, preemption victims/attempts, unschedule task/job
counts, job_retry_counts.  Exposition-format text is served by
``kube_batch_tpu.cli.server``.
"""

from __future__ import annotations

import logging
import threading
from collections import defaultdict
from typing import Dict, List, Tuple

from .. import knobs

SUBSYSTEM = "kube_batch"

log = logging.getLogger(__name__)

# ----------------------------------------------------------------------
# Label-cardinality bound (doc/OBSERVABILITY.md "SLO metrics"): metrics
# labeled by USER-INFLUENCED names (queue / namespace) cap their distinct
# series; past the cap, new label values collapse into one ``other``
# series and the rerouted observations count in
# ``kube_batch_metric_series_dropped_total{metric}`` — a namespace storm
# can no longer grow the Prometheus scrape without bound.  The cap env
# is validated like ops/solver.shard_knobs: a malformed value warns
# loudly exactly once and pins the default.

SERIES_CAP_ENV = knobs.METRIC_SERIES_CAP.env
DEFAULT_SERIES_CAP = knobs.METRIC_SERIES_CAP.default

_series_lock = threading.Lock()
_series_seen: Dict[str, set] = {}       # guarded-by: _series_lock
_series_cap = None                      # guarded-by: _series_lock
OTHER_LABEL = "other"


def _resolve_series_cap() -> int:
    return knobs.METRIC_SERIES_CAP.value()


def refresh_series_cap() -> int:
    """Re-resolve the series cap from the current environment — the
    deliberate test hook (mirror of ops.solver.refresh_shard_knobs).
    Forgets which label values were already admitted."""
    global _series_cap
    with _series_lock:
        _series_cap = None
        _series_seen.clear()
    return series_cap()


def series_cap() -> int:
    global _series_cap
    with _series_lock:
        if _series_cap is None:
            _series_cap = _resolve_series_cap()
        return _series_cap


def bounded_label(metric: str, value: str) -> str:
    """Admit ``value`` as a label for ``metric``, or reroute it to the
    shared ``other`` bucket once the metric's distinct-series cap is
    reached (counting the reroute).  The seen-set is itself bounded by
    the cap, so adversarial cardinality cannot grow THIS state either."""
    value = str(value) if value else "none"
    global _series_cap
    with _series_lock:
        if _series_cap is None:
            _series_cap = _resolve_series_cap()
        seen = _series_seen.get(metric)
        if seen is None:
            seen = _series_seen[metric] = set()
        if value in seen:
            return value
        if len(seen) >= _series_cap:
            dropped = True
        else:
            seen.add(value)
            dropped = False
    if dropped:
        series_dropped.inc(1.0, metric)
        return OTHER_LABEL
    return value


def _exp_buckets(start: float, factor: float, count: int) -> List[float]:
    out, v = [], start
    for _ in range(count):
        out.append(v)
        v *= factor
    return out


def _escape_label(value) -> str:
    """Prometheus text-format label-value escaping (backslash, double
    quote, newline).  Label values here are user-influenced — job names
    and error-site strings flow in verbatim — so raw interpolation would
    let one adversarial name break the whole scrape."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP-line escaping (backslash and newline; quotes are legal)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(names, values) -> str:
    return ",".join(f'{n}="{_escape_label(v)}"'
                    for n, v in zip(names, values))


class Histogram:
    def __init__(self, name: str, help_: str, buckets: List[float],
                 label_names: Tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.buckets = buckets
        self.label_names = label_names
        self._lock = threading.Lock()
        self._counts: Dict[tuple, List[int]] = defaultdict(
            lambda: [0] * (len(buckets) + 1))        # guarded-by: _lock
        self._sums: Dict[tuple, float] = defaultdict(float)    # guarded-by: _lock
        self._totals: Dict[tuple, int] = defaultdict(int)      # guarded-by: _lock

    def observe(self, value: float, *labels: str) -> None:
        with self._lock:
            counts = self._counts[labels]
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[labels] += value
            self._totals[labels] += 1

    def observe_many(self, values, *labels: str) -> None:
        """Bulk observation (one lock + vectorized bucketing): the batched
        dispatch path records 50k task latencies per session."""
        import numpy as np
        arr = np.asarray(values, dtype=np.float64)
        if arr.size == 0:
            return
        idx = np.searchsorted(np.asarray(self.buckets), arr, side="left")
        bincounts = np.bincount(idx, minlength=len(self.buckets) + 1)
        with self._lock:
            counts = self._counts[labels]
            for i, c in enumerate(bincounts):
                if c:
                    counts[i] += int(c)
            self._sums[labels] += float(arr.sum())
            self._totals[labels] += int(arr.size)

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            for labels, counts in self._counts.items():
                label_str = _label_str(self.label_names, labels)
                cumulative = 0
                for bound, c in zip(self.buckets, counts):
                    cumulative += c
                    le = f'le="{bound}"'
                    sep = "," if label_str else ""
                    lines.append(
                        f"{self.name}_bucket{{{label_str}{sep}{le}}} {cumulative}")
                cumulative += counts[-1]
                sep = "," if label_str else ""
                lines.append(
                    f'{self.name}_bucket{{{label_str}{sep}le="+Inf"}} {cumulative}')
                braces = f"{{{label_str}}}" if label_str else ""
                lines.append(f"{self.name}_sum{braces} {self._sums[labels]}")
                lines.append(f"{self.name}_count{braces} {self._totals[labels]}")
        return "\n".join(lines)


class Counter:
    # The exposition TYPE keyword; Gauge overrides it.  A class attribute
    # (not string surgery on the rendered output) so a HELP text that
    # happens to contain the word "counter" cannot corrupt the format.
    TYPE = "counter"

    def __init__(self, name: str, help_: str, label_names: Tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._lock = threading.Lock()
        self._values: Dict[tuple, float] = defaultdict(float)  # guarded-by: _lock

    def inc(self, amount: float = 1.0, *labels: str) -> None:
        with self._lock:
            self._values[labels] += amount

    def value(self, *labels: str) -> float:
        with self._lock:
            return self._values.get(labels, 0.0)

    def values(self) -> Dict[tuple, float]:
        """Snapshot of every labeled value (bench/debug readers)."""
        with self._lock:
            return dict(self._values)

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.TYPE}"]
        with self._lock:
            if not self._values:
                lines.append(f"{self.name} 0")
            for labels, v in self._values.items():
                label_str = _label_str(self.label_names, labels)
                braces = f"{{{label_str}}}" if label_str else ""
                lines.append(f"{self.name}{braces} {_number(v)}")
        return "\n".join(lines)


def _number(v: float) -> str:
    """A sample value in plain decimals where Python would write a
    negative exponent (seconds of a few microseconds)."""
    text = f"{v}"
    if "e-" in text:
        text = f"{v:.12f}".rstrip("0").rstrip(".")
    return text


class Gauge(Counter):
    TYPE = "gauge"

    def set(self, value: float, *labels: str) -> None:
        with self._lock:
            self._values[labels] = value


class Registry:
    def __init__(self):
        self.collectors: List = []
        # Called before each exposition: counters whose writers keep
        # their own totals (the collector hook's) are brought up to date
        # there.
        self.samplers: List = []

    def register(self, collector):
        self.collectors.append(collector)
        return collector

    def expose(self) -> str:
        for sample in self.samplers:
            sample()
        return "\n".join(c.expose() for c in self.collectors) + "\n"


registry = Registry()

# Latency buckets: 5ms * 2^k (metrics.go:38-45) and 5us * 2^k (:47-63).
_MS_BUCKETS = _exp_buckets(5.0, 2.0, 10)
_US_BUCKETS = _exp_buckets(5.0, 2.0, 10)

e2e_scheduling_latency = registry.register(Histogram(
    f"{SUBSYSTEM}_e2e_scheduling_latency_milliseconds",
    "E2e scheduling latency in milliseconds (scheduling algorithm + binding)",
    _MS_BUCKETS))
plugin_scheduling_latency = registry.register(Histogram(
    f"{SUBSYSTEM}_plugin_scheduling_latency_microseconds",
    "Plugin scheduling latency in microseconds", _US_BUCKETS,
    ("plugin", "on_session")))
action_scheduling_latency = registry.register(Histogram(
    f"{SUBSYSTEM}_action_scheduling_latency_microseconds",
    "Action scheduling latency in microseconds", _US_BUCKETS, ("action",)))
task_scheduling_latency = registry.register(Histogram(
    f"{SUBSYSTEM}_task_scheduling_latency_microseconds",
    "Task scheduling latency in microseconds", _US_BUCKETS))
schedule_attempts = registry.register(Counter(
    f"{SUBSYSTEM}_schedule_attempts_total",
    "Number of attempts to schedule pods, by result.", ("result",)))
preemption_victims = registry.register(Gauge(
    f"{SUBSYSTEM}_pod_preemption_victims",
    "Number of selected preemption victims"))
preemption_attempts = registry.register(Counter(
    f"{SUBSYSTEM}_total_preemption_attempts",
    "Total preemption attempts in the cluster till now"))
unschedule_task_count = registry.register(Gauge(
    f"{SUBSYSTEM}_unschedule_task_count",
    "Number of tasks could not be scheduled", ("job",)))
unschedule_job_count = registry.register(Gauge(
    f"{SUBSYSTEM}_unschedule_job_count",
    "Number of jobs could not be scheduled"))
job_retry_counts = registry.register(Counter(
    f"{SUBSYSTEM}_job_retry_counts",
    "Number of retry counts for one job", ("job",)))
# TPU sidecar extras (no reference counterpart): device solve time and
# transfer time for the tensorized sessions.
tpu_solve_latency = registry.register(Histogram(
    f"{SUBSYSTEM}_tpu_solve_latency_milliseconds",
    "On-device batch solve latency in milliseconds", _MS_BUCKETS))
tpu_transfer_latency = registry.register(Histogram(
    f"{SUBSYSTEM}_tpu_transfer_latency_milliseconds",
    "Host<->device snapshot transfer latency in milliseconds", _MS_BUCKETS))
tpu_apply_latency = registry.register(Histogram(
    f"{SUBSYSTEM}_tpu_apply_latency_milliseconds",
    "Host-side batched placement apply latency in milliseconds",
    _MS_BUCKETS))
# Compile-ahead subsystem (ops/compile_cache.py): a session solve whose
# (solver, bucket, cfg) signature was pre-compiled (warmup or an earlier
# solve) is a hit; a miss paid a fresh in-process XLA compile.
compile_cache_hits = registry.register(Counter(
    f"{SUBSYSTEM}_compile_cache_hits_total",
    "Session solves served by an already-compiled solver executable"))
compile_cache_misses = registry.register(Counter(
    f"{SUBSYSTEM}_compile_cache_misses_total",
    "Session solves that triggered a fresh in-process XLA compile"))
compile_cache_inflight = registry.register(Gauge(
    f"{SUBSYSTEM}_compile_cache_inflight",
    "Warmup bucket compiles currently pending or in flight"))
bucket_pad_waste = registry.register(Gauge(
    f"{SUBSYSTEM}_bucket_pad_waste_ratio",
    "Fraction of the padded bucket unused by real rows, per axis",
    ("axis",)))
# Pipelined session engine (actions/tpu_allocate.py, models/shipping.py):
# the solve dispatch/fetch split exposes how much host-side apply
# preparation actually overlapped the device solve, and how long the
# action then blocked waiting on the device; the ship counters record
# full vs dirty-row-delta input shipments and the bytes each moved.
tpu_host_overlap_latency = registry.register(Histogram(
    f"{SUBSYSTEM}_tpu_host_overlap_latency_milliseconds",
    "Host-side apply preparation overlapped with the device solve, ms",
    _MS_BUCKETS))
tpu_device_wait_latency = registry.register(Histogram(
    f"{SUBSYSTEM}_tpu_device_wait_latency_milliseconds",
    "Time the action blocked on the device result after overlap work, ms",
    _MS_BUCKETS))
ship_total = registry.register(Counter(
    f"{SUBSYSTEM}_tpu_ship_total",
    "SolverInputs shipments by mode (full | delta | clean)", ("mode",)))
ship_bytes = registry.register(Counter(
    f"{SUBSYSTEM}_tpu_ship_bytes_total",
    "Bytes moved host->device by SolverInputs shipments, by mode",
    ("mode",)))
# Sharded steady state (doc/SHARDING.md): per-device delta traffic of the
# mesh-sharded resident buffer (which shards' node rows went dirty and
# how many bytes each received — clean shards stay at ~0), and the route
# every solver-family dispatch took at the choose_solver_mesh /
# eviction-scan chokepoints.
ship_shard_bytes = registry.register(Counter(
    f"{SUBSYSTEM}_tpu_ship_shard_bytes_total",
    "Delta bytes shipped to each mesh device's node-shard region",
    ("shard",)))
solver_route = registry.register(Counter(
    f"{SUBSYSTEM}_solver_route_total",
    "Solver-family dispatches by routing family and chosen engine",
    ("family", "choice")))
# Scheduler loop health (scheduler.py): a persistently failing cycle or
# repair worker is visible on /metrics instead of vanishing into a bare
# ``except Exception``.
scheduler_loop_errors = registry.register(Counter(
    f"{SUBSYSTEM}_scheduler_loop_errors_total",
    "Exceptions swallowed by the scheduling loop, by stage", ("stage",)))
# Per-session mutation footprint (framework/session.py close_session):
# the dirty-set sizes that drive the delta-shipping and block-reuse
# paths — how much of the cluster each cycle actually churns.
session_mutated_jobs = registry.register(Gauge(
    f"{SUBSYSTEM}_session_mutated_jobs",
    "Job clones mutated by the last scheduling session"))
session_mutated_nodes = registry.register(Gauge(
    f"{SUBSYSTEM}_session_mutated_nodes",
    "Node clones mutated by the last scheduling session"))
# Reviewed-swallow visibility (graftlint exception-policy, doc/LINT.md):
# broad handlers that neither re-raise nor have a dedicated counter count
# here by site, so a permanently failing best-effort path shows up on
# /metrics instead of disappearing into `except Exception: pass`.
swallowed_exceptions = registry.register(Counter(
    f"{SUBSYSTEM}_swallowed_exceptions_total",
    "Exceptions swallowed by reviewed best-effort paths, by site",
    ("site",)))
# Batched eviction engine (doc/EVICTION.md): cluster-committed evictions
# split by the action that decided them (the bench artifact's opaque
# ``pipeline_evictions`` total, made attributable), and the VictimIndex's
# life-cycle events (matrix rebuilds, live evict/restore invalidations).
evictions_total = registry.register(Counter(
    f"{SUBSYSTEM}_evictions_total",
    "Cluster-committed evictions, by deciding action", ("action",)))
victim_index_events = registry.register(Counter(
    f"{SUBSYSTEM}_victim_index_events_total",
    "VictimIndex life-cycle events (rebuild | evict | restore)",
    ("kind",)))
# Batched statement commit (doc/EVICTION.md "Batched commit"): the
# per-action effect flushes — how many flushed cleanly vs degraded to
# the per-task sequential path, and how many effects each flush carried
# (the batch-size distribution a storm regression shows up in).
commit_flushes = registry.register(Counter(
    "kube_batch_commit_flushes_total",
    "Per-action commit flushes, by outcome (batched = one fused bulk "
    "egress; degraded = mid-batch failure re-driven per task)",
    ("action", "mode")))
commit_batch_size = registry.register(Histogram(
    "kube_batch_commit_batch_size",
    "Effects carried per commit flush (evicts accumulated by one "
    "action before its single bulk egress)",
    _exp_buckets(1.0, 2.0, 14)))
# Chaos engine + graceful degradation (doc/CHAOS.md): the injected-fault
# ledger, the degraded-mode surface (which degradation source is active
# and what the device-solve breaker is doing), and the failure counters
# that drive backoff — a cluster limping through faults is fully visible
# on /metrics instead of just slower.
chaos_injected = registry.register(Counter(
    f"{SUBSYSTEM}_chaos_injected_total",
    "Faults injected by the chaos engine, by site", ("site",)))
chaos_cycles_survived = registry.register(Counter(
    f"{SUBSYSTEM}_chaos_cycles_survived_total",
    "Scheduling cycles completed while a chaos fault plan was active"))
degraded_mode = registry.register(Gauge(
    f"{SUBSYSTEM}_degraded_mode",
    "1 while the named degradation source is active (0 = healthy)",
    ("source",)))
breaker_state = registry.register(Gauge(
    f"{SUBSYSTEM}_breaker_state",
    "Circuit-breaker state (0 closed | 1 half-open | 2 open)",
    ("breaker",)))
breaker_transitions = registry.register(Counter(
    f"{SUBSYSTEM}_breaker_transitions_total",
    "Circuit-breaker state transitions, by target state",
    ("breaker", "to")))
cycle_failures = registry.register(Counter(
    f"{SUBSYSTEM}_cycle_failures_total",
    "Failed scheduler-loop stages (consecutive cycle failures drive the "
    "crash-loop backoff)", ("stage",)))
device_solve_failures = registry.register(Counter(
    f"{SUBSYSTEM}_device_solve_failures_total",
    "Device-path failures degraded to the host path, by stage",
    ("stage",)))
# The port's own (the reference has none): sessions the tensorizer could
# not stage (more than 64 host-port keys or 32 affinity selectors, a
# fractional pod-affinity weight, an int32 overflow, or a conf it does
# not express), which the host path then ran — the reference's
# expressiveness boundary, made visible (models/tensor_snapshot.py
# ``note_tensorize_limit``).
tensorize_limits = registry.register(Counter(
    f"{SUBSYSTEM}_tensorize_limit_total",
    "Sessions the tensorizer could not stage and the host path ran, by "
    "reason and call site", ("reason", "site")))
bind_ambiguous = registry.register(Counter(
    f"{SUBSYSTEM}_bind_ambiguous_total",
    "Binds whose POST was delivered but whose outcome needed proof, by "
    "resolution (landed = read-back proved it; unproven = routed to "
    "resync)", ("outcome",)))
bind_retries = registry.register(Counter(
    f"{SUBSYSTEM}_bind_retries_total",
    "Bind-egress retry waves after transient, unambiguous failures"))
# The port's own: the path each bound task took into cache truth ahead
# of its watch echo (cache/cache.py ``_assume_bound_many``).
assume_mirrored = registry.register(Counter(
    f"{SUBSYSTEM}_assume_mirrored_total",
    "Bound tasks mirrored into cache truth ahead of the watch echo, by "
    "path (batched = node and job vectors moved once by their sums; "
    "per_task = a task-by-task step; skipped = the echo landed first or "
    "the task is gone)", ("path",)))
watch_reconnects = registry.register(Counter(
    f"{SUBSYSTEM}_watch_reconnects_total",
    "Reflector watch-stream reconnects, by resource and cause "
    "(disconnect | malformed)", ("resource", "cause")))
# Wire-to-tensor fast path (edge/codec decode_delta, doc/INCREMENTAL.md
# "Wire fast path"): how each reflector frame decoded (delta = changed
# fields only against the cached baseline; full = first sight / control
# arm / no baseline), and why a delta attempt degraded to a full decode.
# Degradation is counted, never fatal — a malformed or surprising frame
# must not kill the reflector thread (tests/test_wire_fast.py fuzzes).
wire_fast_decode = registry.register(Counter(
    "kube_batch_wire_fast_decode_total",
    "Reflector frames by decode mode (delta = columnar fast path; "
    "full = complete materialization)", ("mode",)))
wire_fast_fallback = registry.register(Counter(
    "kube_batch_wire_fast_fallback_total",
    "Delta-decode attempts that degraded to a full decode, by reason "
    "(error = delta raised unexpectedly; baseline = no/mismatched "
    "cached doc; kind = resource kind outside the delta plans; "
    "evicted = baseline dropped by the byte budget; selector = a "
    "shard selector failed to compile and the stream degraded to an "
    "unfiltered watch)", ("reason",)))
# Shard-scoped ingest (edge/wire_shard.py, doc/INGEST.md): watch frames
# the client-side scope check refused to mirror — scope = a frame for a
# foreign queue the server's over-approximating selector still sent;
# handover = a frame that raced a lease loss (the `ingest.handover_race`
# chaos site pins this window open deterministically).
ingest_dropped = registry.register(Counter(
    "kube_batch_ingest_dropped_total",
    "Watch frames dropped by the client-side shard-scope check, by "
    "resource and reason (scope | handover)", ("resource", "reason")))
# Lazy mirror materialization (edge/client.flush_pending): MODIFIED pod
# frames deferred at receipt (deferred), follow-up frames folded into an
# existing deferral (coalesced), deferred frames materialized at the
# session/debug chokepoint (flushed), and deferred docs the flush could
# not decode (error — the mirror keeps the prior materialization until
# the next frame or relist heals it).
lazy_mirror = registry.register(Counter(
    "kube_batch_lazy_mirror_total",
    "Lazy-mirror deferral events (deferred | coalesced | flushed | "
    "error)", ("event",)))
# Baseline byte-budget enforcement (edge/baseline.py): cold baselines
# compressed in place, then evicted when compression alone cannot meet
# the budget.
baseline_budget_ops = registry.register(Counter(
    "kube_batch_wire_baseline_budget_total",
    "Baseline-budget enforcement actions by kind (compress | evict)",
    ("kind", "op")))
solve_deadline_exceeded = registry.register(Counter(
    f"{SUBSYSTEM}_solve_deadline_exceeded_total",
    "Session solves that overran the per-session deadline (counted as "
    "breaker failures; the late result is still applied)"))
# O(churn) incremental sessions (models/incremental.py,
# doc/INCREMENTAL.md): how each session classified (micro = persistent
# state patched, full = periodic floor / first build, fallback = a micro
# attempt invalidated by a layout/cfg change or >50% dirty), the dirty
# footprint the micro path actually restaged, and whether the device
# solve was served from the generation-keyed result cache (a byte-clean
# ship reuses the previous deterministic solve without a round-trip).
incremental_sessions = registry.register(Counter(
    f"{SUBSYSTEM}_incremental_sessions_total",
    "Scheduling sessions by incremental kind (micro | full | fallback)",
    ("kind",)))
incremental_dirty = registry.register(Gauge(
    f"{SUBSYSTEM}_incremental_dirty_rows",
    "Dirty rows the last incremental session restaged, per axis",
    ("axis",)))
incremental_generation_reuse = registry.register(Counter(
    f"{SUBSYSTEM}_incremental_generation_reuse_total",
    "Device solves served from (hit) or missing (miss) the "
    "generation-keyed result cache", ("result",)))
# Residual per-cycle floors (doc/INCREMENTAL.md "Killing the per-cycle
# floors"): what the last cycle actually paid for each formerly-O(N)
# stage, so a residual floor is attributable from /metrics without a
# profiler, and the O(N)-work counters the `make bench-churn` gate
# asserts scale with dirty objects (a regression that silently
# re-introduces a full walk fails CI, not just a latency graph).
cycle_floor_ms = registry.register(Gauge(
    f"{SUBSYSTEM}_tpu_cycle_floor_ms",
    "Last cycle's cost of each residual floor stage "
    "(solve_wait | snapshot | close | occupancy | decode | stage | "
    "plugin_close), milliseconds", ("floor",)))
candidate_solve = registry.register(Counter(
    f"{SUBSYSTEM}_candidate_solve_total",
    "Allocate solves by node-axis scope (fired = candidate-row "
    "prefiltered program; full = whole node bucket)", ("result",)))
# One-dispatch sessions (ops/fused_solver.py, doc/FUSED.md): every
# solve-family device dispatch is counted at its chokepoint, so "one
# dispatch per session" is a measured claim — the per-cycle ledger below
# rides /debug/sessions meta the same way cycle floors do.
session_dispatches = registry.register(Counter(
    f"{SUBSYSTEM}_tpu_session_dispatches_total",
    "Solve-family device dispatches by family (solve | evict | topo = "
    "per-family programs; fused = the one-dispatch super-program "
    "serving several families from a single round trip)", ("family",)))
fused_legs = registry.register(Counter(
    f"{SUBSYSTEM}_tpu_fused_legs_total",
    "Fused super-program legs by consumption outcome (served = the "
    "family's action consumed the precomputed tensors; invalidated = a "
    "host decision moved state after the fused dispatch and the family "
    "re-dispatched per-action)", ("family", "outcome")))
candidate_rows = registry.register(Gauge(
    f"{SUBSYSTEM}_candidate_solve_rows",
    "Candidate node rows the last prefiltered solve actually scanned"))
snapshot_objects = registry.register(Gauge(
    f"{SUBSYSTEM}_snapshot_objects",
    "Objects the last cache.snapshot() individually processed (walked) "
    "vs served from the generation-keyed snapshot map (reused)",
    ("mode",)))
close_objects_walked = registry.register(Gauge(
    f"{SUBSYSTEM}_close_objects_walked",
    "Jobs the last close_session individually processed (the remainder "
    "was provably quiet and skipped)"))
occupancy_rows_rebuilt = registry.register(Gauge(
    f"{SUBSYSTEM}_occupancy_rows_rebuilt",
    "Node occupancy (host-port/selector) rows rebuilt by the last "
    "tensorize; -1 = feature inactive this session"))
stage_rows_staged = registry.register(Gauge(
    f"{SUBSYSTEM}_stage_rows_staged",
    "Candidate-task rows the last tensorize rewrote into the persistent "
    "staging buffers (wire fast path); -1 = full concatenation path "
    "(control arm / non-persistent cache)"))
# Scheduling-SLO layer (trace/lineage.py, doc/OBSERVABILITY.md): the
# quantity the scheduler actually promises users — how long a pod waits
# from cluster arrival (edge-decode ingest stamp) to bind — plus where
# that wait went (before the scheduler first considered it vs inside
# scheduling/egress) and the per-tenant fairness surface computed from
# the proportion/drf session opens.  Queue labels are user-influenced,
# so every one passes through bounded_label above.
_SLO_BUCKETS = [0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0, 1800.0]
slo_time_to_bind = registry.register(Histogram(
    f"{SUBSYSTEM}_slo_time_to_bind_seconds",
    "Pod wall time from cluster-arrival ingest to the first successful "
    "bind, by queue", _SLO_BUCKETS, ("queue",)))
slo_first_consider = registry.register(Histogram(
    f"{SUBSYSTEM}_slo_time_to_first_consider_seconds",
    "Pod wall time from ingest to the first scheduling session opened "
    "after it (the scheduler's first look), by queue", _SLO_BUCKETS,
    ("queue",)))
slo_queue_wait = registry.register(Histogram(
    f"{SUBSYSTEM}_slo_queue_wait_seconds",
    "Where the pod's wait went: segment pre_consider (ingest -> first "
    "session open) vs scheduling (first session open -> bind)",
    _SLO_BUCKETS, ("queue", "segment")))
slo_samples_dropped = registry.register(Counter(
    f"{SUBSYSTEM}_slo_samples_dropped_total",
    "SLO samples not recorded, by reason (negative | ledger_evicted | "
    "ring_evicted)", ("reason",)))
series_dropped = registry.register(Counter(
    f"{SUBSYSTEM}_metric_series_dropped_total",
    "Observations rerouted to the shared 'other' series after the "
    "per-metric label-cardinality cap (KUBE_BATCH_TPU_METRIC_SERIES_CAP)"
    " was reached, by metric", ("metric",)))
# Per-tenant fairness accounting (plugins/proportion.py + plugins/drf.py
# session opens; /debug/tenants serves the same table as JSON).  Shares
# are dominant-resource fractions so allocated vs deserved is directly
# comparable per queue.
tenant_share = registry.register(Gauge(
    f"{SUBSYSTEM}_tenant_share",
    "Dominant-resource allocated/deserved ratio per queue (>1 = the "
    "queue holds more than its fair share)", ("queue",)))
tenant_deserved_share = registry.register(Gauge(
    f"{SUBSYSTEM}_tenant_deserved_share",
    "Deserved fraction of the cluster per queue (proportion "
    "water-filling outcome, dominant resource)", ("queue",)))
tenant_allocated_share = registry.register(Gauge(
    f"{SUBSYSTEM}_tenant_allocated_share",
    "Allocated fraction of the cluster per queue (dominant resource)",
    ("queue",)))
tenant_pending_jobs = registry.register(Gauge(
    f"{SUBSYSTEM}_tenant_pending_jobs",
    "Jobs with Pending tasks per queue at the last session open",
    ("queue",)))
tenant_starvation = registry.register(Gauge(
    f"{SUBSYSTEM}_tenant_starvation_seconds",
    "Age of the oldest job still holding Pending tasks per queue "
    "(0 = no pending work)", ("queue",)))
tenant_starved_sessions = registry.register(Counter(
    f"{SUBSYSTEM}_tenant_starved_sessions_total",
    "Sessions that opened with the queue under its deserved share while "
    "it still had pending demand", ("queue",)))
tenant_max_job_share = registry.register(Gauge(
    f"{SUBSYSTEM}_tenant_max_job_share",
    "Largest drf job share inside each queue at the last session open",
    ("queue",)))
# Queue-shard tenancy engine + replica federation (kube_batch_tpu/
# tenancy/, doc/TENANCY.md): which replica owns each queue-shard, how
# old its lease is, every lease transition (claim | steal | release |
# renew loss | fenced write), per-shard micro-session outcomes, bind
# egress stamped with the owning replica, and the federation's
# rebalance ledger (the bench artifact's shard_rebalances counter).
shard_owner_info = registry.register(Gauge(
    f"{SUBSYSTEM}_shard_owner_info",
    "1 while the labeled replica owns the queue-shard (0 after it loses "
    "or releases the lease)", ("shard", "replica")))
shard_lease_age = registry.register(Gauge(
    f"{SUBSYSTEM}_shard_lease_age_seconds",
    "Seconds since the shard's lease record was last renewed at the "
    "store (any holder)", ("shard",)))
shard_lease_transitions = registry.register(Counter(
    f"{SUBSYSTEM}_shard_lease_transitions_total",
    "Shard lease state transitions (claim | steal | release | shed | "
    "renew_timeout | stolen_from | clock_skew | fenced_write)",
    ("shard", "kind")))
shard_sessions = registry.register(Counter(
    f"{SUBSYSTEM}_shard_sessions_total",
    "Shard-scoped micro-sessions run, by outcome (ok | error)",
    ("shard", "result")))
shard_binds = registry.register(Counter(
    f"{SUBSYSTEM}_shard_binds_total",
    "Bind egress per shard, stamped with the owning replica",
    ("shard", "replica")))
shard_rebalance = registry.register(Counter(
    f"{SUBSYSTEM}_shard_rebalance_total",
    "Shard ownership rebalances across the federation (claim | steal | "
    "release | shed | lost)", ("kind",)))
# Concurrent shard micro-sessions (doc/TENANCY.md "Concurrent
# micro-sessions"): the bounded-depth shard pipeline's ledger — how many
# stages entered/retired, how often a predecessor's retire invalidated a
# successor's optimistic work (conflict_rerun), and how much host time
# ran inside a predecessor's device-dispatch window (the overlap the
# tentpole exists to create).
shard_pipeline = registry.register(Counter(
    f"{SUBSYSTEM}_shard_pipeline_total",
    "Shard-pipeline stage events (begun | retired | conflict_rerun | "
    "abandoned | overlapped)", ("event",)))
shard_overlap_seconds = registry.register(Counter(
    f"{SUBSYSTEM}_shard_overlap_seconds_total",
    "Host wall time spent running a successor shard's begin phases "
    "inside a predecessor's in-flight device-dispatch window"))
shard_overlap_last_ms = registry.register(Gauge(
    "kube_batch_tpu_shard_overlap_ms",
    "Overlapped host time of the last pipelined loop iteration (ms)"))
shard_inflight = registry.register(Gauge(
    "kube_batch_tpu_shard_inflight",
    "High-water in-flight shard micro-sessions of the last pipelined "
    "loop iteration (1 = sequential)"))
shard_load = registry.register(Gauge(
    "kube_batch_tpu_shard_load",
    "Per-shard load EWMA (pod count + churn rate) feeding the "
    "federation's load-weighted claim targets", ("shard",)))
solver_inflight = registry.register(Gauge(
    "kube_batch_tpu_solver_inflight",
    "Device solve dispatches issued but not yet fetched or discarded"))
# Wire-edge memory accounting (ROADMAP item 1, doc/INCREMENTAL.md "Wire
# fast path"): raw-doc delta baselines (`_wire_doc`) retained by the
# mirror stores, per resource kind — the measurable target of the
# 1M-pod memory-budget work.
wire_baseline = registry.register(Gauge(
    "kube_batch_wire_baseline_bytes",
    "Approximate bytes of raw wire-doc delta baselines retained by the "
    "mirror stores, per resource kind", ("kind",)))
# Fleet memory ledger (metrics/memledger.py, doc/OBSERVABILITY.md
# "Memory ledger"): per-subsystem byte accounting for every growable
# store, with a high-watermark series attributing the peak to the
# session that set it.  Written ONLY through memledger's publish path
# (lint rule 11, ledger-discipline).
mem_bytes = registry.register(Gauge(
    "kube_batch_tpu_mem_bytes",
    "Current accounted bytes per memory ledger (mirror, pending, "
    "baseline, tensor_cache, stage, resident, incremental, "
    "compile_cache, trace_ring, lineage_ring, event_ring, "
    "snapshot_pool)", ("ledger",)))
mem_watermark = registry.register(Gauge(
    "kube_batch_tpu_mem_watermark_bytes",
    "High-watermark of accounted bytes per memory ledger since process "
    "start (or the last ledger reset)", ("ledger",)))
# Topology / fragmentation SLO (models/topology.py, doc/TOPOLOGY.md):
# per-pool fragmentation computed in the topo action's occupancy walk
# and surfaced on /debug/topology + the bench-topo artifact.
topo_frag_ratio = registry.register(Gauge(
    f"{SUBSYSTEM}_topo_frag_ratio",
    "Fragmentation of each pool's free nodes: 1 - largest contiguous "
    "free block / free nodes (0 = one solid block or no free nodes)",
    ("pool",)))
topo_largest_free_block = registry.register(Gauge(
    f"{SUBSYSTEM}_topo_largest_free_block",
    "Largest contiguous free block (torus-connected nodes) per pool",
    ("pool",)))
topo_slices = registry.register(Counter(
    f"{SUBSYSTEM}_topo_slices_total",
    "Slice placement outcomes (placed | defrag_placed | pending | "
    "too_few_tasks | bad_shape | degraded)", ("outcome",)))
topo_bad_coords = registry.register(Counter(
    f"{SUBSYSTEM}_topo_bad_coords_total",
    "Nodes degraded to flat-list placement by malformed/missing/"
    "duplicate coordinate labels (incl. chaos topology.bad_coords)"))

# Host time the trace already reads (trace/spans.py), summed for
# operators: the external SchedulerCache handler calls, timed under the
# mutex they hold (a handler's stretches of back-to-back calls, added
# when the cache's next run opens), and each pass of the cyclic
# collector by generation (the hook a Scheduler holds, brought up to date
# at exposition).  Both stay at 0 under KUBE_BATCH_TPU_TRACE=0, where
# nothing is timed.
cache_handler_seconds = registry.register(Counter(
    f"{SUBSYSTEM}_cache_handler_seconds_total",
    "Seconds of the cache's informer handler calls under the cache "
    "mutex, back-to-back calls timed together", ("handler",)))
gc_pause_seconds = registry.register(Counter(
    f"{SUBSYSTEM}_gc_pause_seconds_total",
    "Seconds the cyclic garbage collector paused the process, by "
    "generation", ("generation",)))
_gc_sampled = [0.0, 0.0, 0.0]  # guarded-by: _gc_sampled_lock
_gc_sampled_lock = threading.Lock()


def note_handler_seconds(seconds: Dict[str, float]) -> None:
    """Add one handler run's {handler: seconds} to
    ``cache_handler_seconds``."""
    for handler, s in seconds.items():
        cache_handler_seconds.inc(s, handler)


def sample_gc_pauses() -> None:
    """Add what the collector hook's totals grew by since the last
    sample to ``gc_pause_seconds`` (the hook takes no lock, so it cannot
    add them itself)."""
    from ..trace import spans
    with _gc_sampled_lock:
        for generation, total in enumerate(spans.gc_pause_seconds()):
            gc_pause_seconds.inc(total - _gc_sampled[generation],
                                 str(generation))
            _gc_sampled[generation] = total


registry.samplers.append(sample_gc_pauses)


# Helper API (metrics.go:123-191).

def observe_e2e_latency(seconds: float) -> None:
    e2e_scheduling_latency.observe(seconds * 1e3)


def observe_plugin_latency(plugin: str, on_session: str, seconds: float) -> None:
    plugin_scheduling_latency.observe(seconds * 1e6, plugin, on_session)


def observe_action_latency(action: str, seconds: float) -> None:
    action_scheduling_latency.observe(seconds * 1e6, action)


def observe_task_schedule_latency(seconds: float) -> None:
    task_scheduling_latency.observe(seconds * 1e6)


def observe_task_schedule_latencies(seconds_array) -> None:
    """Bulk form for the batched dispatch path."""
    import numpy as np
    task_scheduling_latency.observe_many(
        np.asarray(seconds_array, dtype=np.float64) * 1e6)


def register_schedule_attempt(result: str) -> None:
    schedule_attempts.inc(1.0, result)


def update_preemption_victims_count(count: int) -> None:
    preemption_victims.set(float(count))


def register_preemption_attempt() -> None:
    preemption_attempts.inc()


def update_unschedule_task_count(job: str, count: int) -> None:
    unschedule_task_count.set(float(count), job)


def update_unschedule_job_count(count: int) -> None:
    unschedule_job_count.set(float(count))


def register_job_retries(job: str) -> None:
    job_retry_counts.inc(1.0, job)


def observe_tpu_solve_latency(seconds: float) -> None:
    tpu_solve_latency.observe(seconds * 1e3)


def observe_tpu_transfer_latency(seconds: float) -> None:
    tpu_transfer_latency.observe(seconds * 1e3)


def observe_tpu_apply_latency(seconds: float) -> None:
    tpu_apply_latency.observe(seconds * 1e3)


def note_compile_cache(hit: bool) -> None:
    (compile_cache_hits if hit else compile_cache_misses).inc()


def compile_cache_counts() -> tuple:
    """(hits, misses) so far — bench.py's artifact split."""
    return (int(compile_cache_hits.value()),
            int(compile_cache_misses.value()))


def set_compile_inflight(count: int) -> None:
    compile_cache_inflight.set(float(count))


def observe_host_overlap_latency(seconds: float) -> None:
    tpu_host_overlap_latency.observe(seconds * 1e3)


def observe_device_wait_latency(seconds: float) -> None:
    tpu_device_wait_latency.observe(seconds * 1e3)


def overlap_split_totals() -> tuple:
    """(host_overlap_ms_sum, device_wait_ms_sum, sessions): bench.py reads
    per-session values as deltas of these running sums (one observation of
    each per pipelined session)."""
    with tpu_host_overlap_latency._lock:
        host = tpu_host_overlap_latency._sums.get((), 0.0)
        n = tpu_host_overlap_latency._totals.get((), 0)
    with tpu_device_wait_latency._lock:
        wait = tpu_device_wait_latency._sums.get((), 0.0)
    return host, wait, n


def note_ship(mode: str, nbytes: int) -> None:
    ship_total.inc(1.0, mode)
    ship_bytes.inc(float(nbytes), mode)


def ship_counts() -> dict:
    """{mode: (shipments, bytes)} so far — bench.py's artifact split."""
    out = {}
    for mode in ("full", "delta", "clean"):
        out[mode] = (int(ship_total.value(mode)),
                     int(ship_bytes.value(mode)))
    return out


def note_ship_shard(shard: int, nbytes: int) -> None:
    """Count node-shard-region bytes shipped to mesh device ``shard``
    (the per-device ledger the O(dirty-blocks) steady-state contract is
    proven against — doc/SHARDING.md)."""
    ship_shard_bytes.inc(float(nbytes), str(shard))


def ship_shard_counts() -> Dict[str, int]:
    """{shard: bytes} so far — bench artifact + check_shard_ab."""
    return {labels[0]: int(v)
            for labels, v in ship_shard_bytes.values().items() if labels}


def note_route(family: str, choice: str) -> None:
    """Count one solver-family dispatch routed at the
    choose_solver_mesh / eviction-scan chokepoints (family is
    allocate | evict | scan | topo | fused; the port's allocate
    choices are cuda | torch | candidates)."""
    solver_route.inc(1.0, family, choice)


def route_counts() -> Dict[str, int]:
    """{"family/choice": count} so far — bench artifact + /debug meta."""
    return {f"{labels[0]}/{labels[1]}": int(v)
            for labels, v in solver_route.values().items()
            if len(labels) == 2}


def inc_scheduler_loop_error(stage: str) -> None:
    scheduler_loop_errors.inc(1.0, stage)


def note_swallowed(site: str) -> None:
    """Count one reviewed exception swallow at ``site`` (the
    exception-policy counter route — see doc/LINT.md rule 5)."""
    swallowed_exceptions.inc(1.0, site)


def note_eviction(action: str) -> None:
    """Count one cluster-committed eviction for ``action`` ("preempt" |
    "reclaim" — the reason string every evict path already carries)."""
    evictions_total.inc(1.0, action)


def note_evictions(action: str, count: int) -> None:
    """Bulk form for the batched commit flush: ``count`` committed
    evictions decided by ``action`` in one counter update."""
    if count:
        evictions_total.inc(float(count), action)


def note_commit_flush(action: str, mode: str, size: int) -> None:
    """Record one per-action commit flush: ``mode`` is "batched" (the
    fused bulk egress landed every effect) or "degraded" (a mid-batch
    failure re-drove the remainder through the per-task sequential
    path); ``size`` is the effect count the flush carried."""
    commit_flushes.inc(1.0, action, mode)
    commit_batch_size.observe(float(size))


def commit_flush_counts() -> Dict[str, int]:
    """{"action/mode": count} so far — the bench-commit vacuous-gate
    guard (a commit A/B whose batched arm never flushed compared
    nothing) and the /debug surfaces."""
    return {f"{labels[0]}/{labels[1]}": int(v)
            for labels, v in commit_flushes.values().items()
            if len(labels) == 2}


def evictions_by_action() -> Dict[str, int]:
    """{action: count} so far — bench artifact + /debug/sessions."""
    return {labels[0]: int(v)
            for labels, v in evictions_total.values().items() if labels}


def note_victim_index(kind: str) -> None:
    victim_index_events.inc(1.0, kind)


def set_session_mutations(jobs: int, nodes: int) -> None:
    session_mutated_jobs.set(float(jobs))
    session_mutated_nodes.set(float(nodes))


def set_bucket_pad_waste(axis: str, ratio: float) -> None:
    bucket_pad_waste.set(round(float(ratio), 4), axis)


def note_chaos_injected(site: str) -> None:
    chaos_injected.inc(1.0, site)


def note_chaos_survived() -> None:
    chaos_cycles_survived.inc()


def set_degraded(source: str, active: bool) -> None:
    degraded_mode.set(1.0 if active else 0.0, source)


def set_breaker_state(breaker: str, code: float) -> None:
    breaker_state.set(code, breaker)


def note_breaker_transition(breaker: str, to: str) -> None:
    breaker_transitions.inc(1.0, breaker, to)


def note_cycle_failure(stage: str) -> None:
    cycle_failures.inc(1.0, stage)


def note_device_failure(stage: str) -> None:
    """Count one device-path failure degraded to the host path (the
    breaker's feed — stage is tensorize | solve | evict_solve)."""
    device_solve_failures.inc(1.0, stage)


def note_tensorize_limit(reason: str, site: str) -> None:
    """Count one session a tensorizer limit sent to the host path."""
    tensorize_limits.inc(1.0, reason, site)


def tensorize_limit_counts() -> Dict[str, int]:
    """{"reason/site": count} so far."""
    return {f"{labels[0]}/{labels[1]}": int(v)
            for labels, v in tensorize_limits.values().items()
            if len(labels) == 2}


def note_bind_ambiguous(outcome: str) -> None:
    """Count one delivered-but-needed-proof bind ("landed" when the
    read-back proved it; "unproven" when it was routed to resync)."""
    bind_ambiguous.inc(1.0, outcome)


def note_bind_retry() -> None:
    bind_retries.inc()


def note_assume_mirrored(batched: int, per_task: int, skipped: int) -> None:
    """Count one bind batch's truth mirror: one update per path."""
    for path, n in (("batched", batched), ("per_task", per_task),
                    ("skipped", skipped)):
        if n:
            assume_mirrored.inc(float(n), path)


def note_watch_reconnect(resource: str, cause: str) -> None:
    watch_reconnects.inc(1.0, resource, cause)


def note_wire_decode(mode: str) -> None:
    """Count one reflector frame's decode mode (delta | full)."""
    wire_fast_decode.inc(1.0, mode)


def note_wire_fast_fallback(reason: str) -> None:
    """Count one delta-decode attempt degrading to a full decode."""
    wire_fast_fallback.inc(1.0, reason)


def wire_fast_counts() -> Dict[str, int]:
    """{mode/reason: count} — the `make bench-wire` vacuous-gate guard
    (a wire A/B whose fast arm never delta-decoded compared nothing)."""
    out = {f"decode_{labels[0]}": int(v)
           for labels, v in wire_fast_decode.values().items() if labels}
    for labels, v in wire_fast_fallback.values().items():
        if labels:
            out[f"fallback_{labels[0]}"] = int(v)
    return out


def note_ingest_drop(resource: str, reason: str) -> None:
    """Count one watch frame the shard-scope check refused to mirror
    (scope = steady over-approximation; handover = raced a lease
    loss)."""
    ingest_dropped.inc(1.0, resource, reason)


def ingest_drop_counts() -> Dict[str, int]:
    """{"resource/reason": count} — soak + handover-race assertions."""
    return {f"{labels[0]}/{labels[1]}": int(v)
            for labels, v in ingest_dropped.values().items()
            if len(labels) == 2}


def note_lazy_mirror(event: str) -> None:
    """Count one lazy-mirror deferral event (deferred | coalesced |
    flushed | error)."""
    lazy_mirror.inc(1.0, event)


def lazy_mirror_counts() -> Dict[str, int]:
    """{event: count} — the lazy-parity tests' non-vacuity guard."""
    return {labels[0]: int(v)
            for labels, v in lazy_mirror.values().items() if labels}


def note_baseline_budget(kind: str, op: str) -> None:
    """Count one baseline-budget enforcement action (compress |
    evict)."""
    baseline_budget_ops.inc(1.0, kind, op)


def baseline_budget_counts() -> Dict[str, int]:
    """{"kind/op": count} — eviction-recovery test assertions."""
    return {f"{labels[0]}/{labels[1]}": int(v)
            for labels, v in baseline_budget_ops.values().items()
            if len(labels) == 2}


# Wall time the reflector threads spent decoding watch frames since the
# scheduling thread last collected it (the per-cycle ``decode`` floor:
# open_session takes-and-resets, so the floor attributes asynchronous
# edge decode to the cycle that absorbed its churn).
_decode_time_lock = threading.Lock()
_decode_seconds_acc = 0.0  # guarded-by: _decode_time_lock


def note_decode_seconds(seconds: float) -> None:
    global _decode_seconds_acc
    with _decode_time_lock:
        _decode_seconds_acc += seconds


def take_decode_seconds() -> float:
    """Drain the accumulated decode wall time (scheduling thread only)."""
    global _decode_seconds_acc
    with _decode_time_lock:
        out = _decode_seconds_acc
        _decode_seconds_acc = 0.0
    return out


def note_solve_deadline() -> None:
    solve_deadline_exceeded.inc()


def note_incremental_session(kind: str) -> None:
    """Count one session by incremental kind (micro | full | fallback;
    classified once per session by the first tensorize build)."""
    incremental_sessions.inc(1.0, kind)


def set_incremental_dirty(nodes: int, jobs: int) -> None:
    incremental_dirty.set(float(nodes), "nodes")
    incremental_dirty.set(float(jobs), "jobs")


def note_generation_reuse(hit: bool) -> None:
    incremental_generation_reuse.inc(1.0, "hit" if hit else "miss")


def incremental_session_counts() -> Dict[str, int]:
    """{kind: count} so far — bench churn-sweep artifact."""
    return {labels[0]: int(v)
            for labels, v in incremental_sessions.values().items()
            if labels}


def generation_reuse_counts() -> Dict[str, int]:
    return {labels[0]: int(v)
            for labels, v in incremental_generation_reuse.values().items()
            if labels}


def set_cycle_floor(floor: str, seconds: float) -> None:
    """Record what the current cycle paid for one residual floor stage
    (solve_wait | snapshot | close | occupancy | decode | stage |
    plugin_close | commit | apply | fused)."""
    cycle_floor_ms.set(round(seconds * 1e3, 3), floor)


def cycle_floor_values() -> Dict[str, float]:
    """{floor: ms} of the last cycle — bench churn artifact + /debug."""
    return {labels[0]: v for labels, v in cycle_floor_ms.values().items()
            if labels}


_dispatch_cycle_lock = threading.Lock()
_dispatch_cycle: Dict[str, int] = {}  # guarded-by: _dispatch_cycle_lock


def note_session_dispatch(family: str) -> None:
    """Count one solve-family device dispatch at the family's chokepoint
    (dispatch_solve | dispatch_evict_batch_solve | dispatch_box_scan |
    the fused super-program) — the process-total counter plus the
    per-cycle ledger /debug/sessions reads back at close."""
    session_dispatches.inc(1.0, family)
    with _dispatch_cycle_lock:
        _dispatch_cycle[family] = _dispatch_cycle.get(family, 0) + 1


def session_dispatch_counts() -> Dict[str, int]:
    """{family: count} so far — bench artifact + check_fused_ab."""
    return {labels[0]: int(v)
            for labels, v in session_dispatches.values().items()
            if labels}


def take_cycle_dispatches() -> Dict[str, int]:
    """Drain the per-cycle dispatch ledger (session close -> /debug
    sessions meta).  Pipelined shard halves interleave on one thread, so
    like cycle floors the attribution is per retire, not per overlap."""
    with _dispatch_cycle_lock:
        out = dict(_dispatch_cycle)
        _dispatch_cycle.clear()
    return out


def note_fused_leg(family: str, outcome: str) -> None:
    """Count one fused-leg outcome (family solve | evict | topo |
    postevict — the storm half's post-eviction placements, served only
    when the host's committed victim order bit-matches the device's
    prediction, doc/FUSED.md "Storm half"; outcome served |
    invalidated)."""
    fused_legs.inc(1.0, family, outcome)


def fused_leg_counts() -> Dict[str, int]:
    """{"family/outcome": count} so far — tests + bench artifact."""
    return {f"{labels[0]}/{labels[1]}": int(v)
            for labels, v in fused_legs.values().items()
            if len(labels) == 2}


def note_candidate_solve(fired: bool, rows: int = 0) -> None:
    candidate_solve.inc(1.0, "fired" if fired else "full")
    # Gauge always moves (0 on full solves) so per-cycle readers never
    # see a stale candidate count from an earlier micro cycle.
    candidate_rows.set(float(rows))


def candidate_solve_counts() -> Dict[str, int]:
    """{result: count} so far — the check_churn_ab vacuous-gate guard."""
    return {labels[0]: int(v)
            for labels, v in candidate_solve.values().items() if labels}


def set_snapshot_objects(walked: int, reused: int) -> None:
    snapshot_objects.set(float(walked), "walked")
    snapshot_objects.set(float(reused), "reused")


def set_close_objects_walked(count: int) -> None:
    close_objects_walked.set(float(count))


def set_occupancy_rows_rebuilt(count: int) -> None:
    occupancy_rows_rebuilt.set(float(count))


def set_stage_rows(count: int) -> None:
    """Candidate-task rows the last tensorize restaged (-1 = the full
    concatenation path ran — control arm or non-persistent cache)."""
    stage_rows_staged.set(float(count))


def observe_time_to_bind(queue: str, seconds: float) -> None:
    """One pod's ingest->bind SLO sample (trace/lineage.py emits exactly
    one per pod lifetime; queue label cardinality-capped)."""
    slo_time_to_bind.observe(seconds, bounded_label("slo", queue))


def observe_first_consider(queue: str, seconds: float) -> None:
    slo_first_consider.observe(seconds, bounded_label("slo", queue))


def observe_queue_wait(queue: str, segment: str, seconds: float) -> None:
    slo_queue_wait.observe(seconds, bounded_label("slo", queue), segment)


def note_slo_dropped(reason: str) -> None:
    slo_samples_dropped.inc(1.0, reason)


def set_tenant_stats(queue: str, share: float, deserved_share: float,
                     allocated_share: float, pending_jobs: int,
                     starvation_s: float, starved: bool) -> None:
    """Publish one queue's fairness row (proportion's session open).
    The queue label is cardinality-capped under ONE shared 'tenant'
    budget, so all tenant gauges collapse the same overflow queues."""
    q = bounded_label("tenant", queue)
    tenant_share.set(round(float(share), 4), q)
    tenant_deserved_share.set(round(float(deserved_share), 4), q)
    tenant_allocated_share.set(round(float(allocated_share), 4), q)
    tenant_pending_jobs.set(float(pending_jobs), q)
    tenant_starvation.set(round(float(starvation_s), 3), q)
    if starved:
        tenant_starved_sessions.inc(1.0, q)


def set_tenant_max_job_share(queue: str, share: float) -> None:
    tenant_max_job_share.set(round(float(share), 4),
                             bounded_label("tenant", queue))


def clear_tenant_gauges(queues) -> None:
    """Zero the gauges of queues that left the cluster so /metrics does
    not keep reporting a departed tenant's last shares forever."""
    for queue in queues:
        q = bounded_label("tenant", queue)
        for gauge in (tenant_share, tenant_deserved_share,
                      tenant_allocated_share, tenant_pending_jobs,
                      tenant_starvation, tenant_max_job_share):
            gauge.set(0.0, q)


def onwork_values() -> Dict[str, float]:
    """The last cycle's O(N)-work counters in one dict — the bench churn
    artifact embeds these per round so `make bench-churn` can assert
    they scale with dirty objects, not cluster size."""
    out: Dict[str, float] = {}
    for labels, v in snapshot_objects.values().items():
        if labels:
            out[f"snapshot_{labels[0]}"] = v
    out["close_walked"] = close_objects_walked.value()
    out["occupancy_rebuilt"] = occupancy_rows_rebuilt.value()
    out["candidate_rows"] = candidate_rows.value()
    out["stage_rows"] = stage_rows_staged.value()
    return out


# Shard ownership gauge bookkeeping: set_shard_owner flips the previous
# holder's info row to 0 so exactly one (shard, replica) pair reads 1.
# Multiple writers (each replica's lease thread in the in-process soak),
# so the last-owner map takes a lock.
_shard_owner_lock = threading.Lock()
_shard_owner_last: Dict[str, str] = {}  # guarded-by: _shard_owner_lock


def set_shard_owner(shard: int, replica: str) -> None:
    s = str(shard)
    # Gauge writes INSIDE the lock: concurrent publishers (every
    # replica's lease thread reports store-observed ownership in the
    # in-process soak) must see zero-the-old + one-the-new as a unit,
    # or an interleaving leaves two replicas' rows at 1 — the lock is
    # what makes "exactly one (shard, replica) pair reads 1" true.
    with _shard_owner_lock:
        prev = _shard_owner_last.get(s)
        _shard_owner_last[s] = replica
        if prev is not None and prev != replica:
            shard_owner_info.set(0.0, s, prev)
        shard_owner_info.set(1.0, s, replica)


def clear_shard_owner(shard: int, replica: str) -> None:
    """The replica lost/released the shard; zero its info row (the next
    owner's set_shard_owner publishes the replacement)."""
    s = str(shard)
    with _shard_owner_lock:
        if _shard_owner_last.get(s) == replica:
            _shard_owner_last.pop(s, None)
        shard_owner_info.set(0.0, s, replica)


def set_shard_lease_age(shard: int, age_s: float) -> None:
    shard_lease_age.set(round(float(age_s), 3), str(shard))


def note_shard_lease(shard: int, kind: str) -> None:
    shard_lease_transitions.inc(1.0, str(shard), kind)


def note_shard_rebalance(kind: str) -> None:
    shard_rebalance.inc(1.0, kind)


def shard_rebalance_counts() -> Dict[str, int]:
    """{kind: count} so far — bench artifact + replica soak."""
    return {labels[0]: int(v)
            for labels, v in shard_rebalance.values().items() if labels}


def note_shard_session(shard: int, result: str) -> None:
    shard_sessions.inc(1.0, str(shard), result)


def shard_session_counts() -> Dict[str, int]:
    """{"shard/result": count} so far — soak + tests."""
    return {f"{labels[0]}/{labels[1]}": int(v)
            for labels, v in shard_sessions.values().items()
            if len(labels) == 2}


def note_shard_binds(shard: int, replica: str, count: int) -> None:
    if count:
        shard_binds.inc(float(count), str(shard), replica)


def note_shard_pipeline(event: str, count: int = 1) -> None:
    if count:
        shard_pipeline.inc(float(count), event)


def shard_pipeline_counts() -> Dict[str, int]:
    """{event: count} so far — bench artifact + the tenancy A/B's
    vacuous-overlap guard."""
    return {labels[0]: int(v)
            for labels, v in shard_pipeline.values().items() if labels}


def note_shard_overlap(seconds: float) -> None:
    if seconds > 0:
        shard_overlap_seconds.inc(float(seconds))


def shard_overlap_total_ms() -> float:
    """Running overlapped-host-time sum in ms (bench reads deltas)."""
    return float(shard_overlap_seconds.value()) * 1e3


def set_shard_cycle_stats(overlap_s: float, inflight_hw: int) -> None:
    """Last pipelined loop iteration's overlap + in-flight high water."""
    shard_overlap_last_ms.set(round(overlap_s * 1e3, 3))
    shard_inflight.set(float(inflight_hw))


def shard_cycle_stats() -> tuple:
    """(overlap_ms, inflight high-water) of the last pipelined loop
    iteration — bench artifact keys."""
    return (float(shard_overlap_last_ms.value()),
            int(shard_inflight.value()))


def set_shard_load(shard: int, load: float) -> None:
    shard_load.set(round(float(load), 3), str(shard))


def set_solver_inflight(count: int) -> None:
    solver_inflight.set(float(count))


def shard_bind_counts() -> Dict[str, int]:
    """{"shard/replica": binds} so far — the replica soak's stamped
    bind-egress ledger."""
    return {f"{labels[0]}/{labels[1]}": int(v)
            for labels, v in shard_binds.values().items()
            if len(labels) == 2}


def set_wire_baseline(kind: str, nbytes: int) -> None:
    wire_baseline.set(float(max(0, nbytes)), kind)


def wire_baseline_totals() -> Dict[str, int]:
    """{kind: retained baseline bytes} — /debug/sessions meta + the
    bench wire artifact (ROADMAP item 1's memory-budget target)."""
    return {labels[0]: int(v)
            for labels, v in wire_baseline.values().items() if labels}


def set_mem_bytes(ledger: str, nbytes: int) -> None:
    """memledger's ONLY gauge sink (lint rule 11): publish one ledger's
    current accounted bytes."""
    mem_bytes.set(float(max(0, nbytes)), ledger)


def set_mem_watermark(ledger: str, nbytes: int) -> None:
    mem_watermark.set(float(max(0, nbytes)), ledger)


_topo_pools_seen: set = set()  # single writer: the scheduling thread's topo action


def set_topo_frag(pool: str, frag_ratio: float, largest_block: int) -> None:
    """Publish one pool's fragmentation row (the topo action's
    occupancy walk; same shared cardinality budget as tenants)."""
    p = bounded_label("topo_pool", pool)
    topo_frag_ratio.set(round(float(frag_ratio), 4), p)
    topo_largest_free_block.set(float(largest_block), p)


def publish_topo_frag(pools: "Dict[str, dict]") -> None:
    """Replace the fragmentation table wholesale: pools that left the
    view (decommissioned / mislabeled nodes) have their gauges zeroed
    so /metrics does not report a departed pool's last fragmentation
    forever — the tenants-table staleness discipline."""
    global _topo_pools_seen
    for pool, row in pools.items():
        set_topo_frag(pool, row["frag_ratio"], row["largest_block"])
    for gone in _topo_pools_seen - set(pools):
        set_topo_frag(gone, 0.0, 0)
    _topo_pools_seen = set(pools)


def note_topo_slice(outcome: str) -> None:
    topo_slices.inc(1.0, outcome)


def topo_slice_counts() -> Dict[str, int]:
    """{outcome: count} so far — bench-topo artifact + tests."""
    return {labels[0]: int(v)
            for labels, v in topo_slices.values().items() if labels}


def note_topo_bad_coords() -> None:
    topo_bad_coords.inc()
