"""Central registry for every ``KUBE_BATCH_TPU_*`` tuning flag.

Every environment knob the scheduler reads is declared here exactly once
— name, kind, default, validation bound, owning doc section, and whether
the flag gates an A/B-parity-verified engine.  Call sites route through
the accessors instead of touching ``os.environ`` directly; the
``knob-registry`` lint rule (tools/graftlint) flags any raw env read in
the package, any declared knob nobody reads, and any knob missing from
doc/INVENTORY.md.

Validation follows the ops/solver.shard_knobs discipline: a malformed
value warns loudly exactly once per process and pins the declared
default, instead of raising at first use and killing the daemon at boot
(or worse, being silently swallowed).  Warnings are emitted on the
*owning module's* logger so operators grep the same logger names they
always have.

This module is a stdlib-only leaf: it must not import anything from the
package (call sites everywhere, including ``native/``, import it).
Spec-valued knobs (CHAOS, TENANCY, SHARD_MAP, BASELINE_BUDGET) only
expose ``raw()`` — their owning modules keep their deliberate
raise-on-malformed parses, because a typo'd fault plan or shard map must
fail loudly, not limp along with the default.

Knob kinds:

``flag-on``     unset/empty means enabled; only ``"0"`` disables.
``flag-opt-in`` only ``"1"`` enables; anything else is off.
``flag-set``    any non-empty value enables (kill switches).
``tristate``    unset means "decide elsewhere"; else ``"1"``/other.
``int``/``float`` numeric with warn-once-pin-default on garbage;
                ``minimum`` rejects (warn+pin), ``clamp_min`` floors
                silently (documented "negative means zero" knobs).
``str``/``spec`` raw passthrough (paths, fault plans, shard maps).
"""

import logging
import os
import threading
from typing import Dict, Optional, Union

__all__ = [
    "Knob", "REGISTRY", "by_env", "reset_warnings", "warn_once",
    "inventory_rows",
]

# One warned-set for the whole process (trace/lineage aliases it as
# ``_warned_envs`` for its legacy test hooks).  Never rebound: cleared
# in place so aliases stay live.
_warned: set = set()               # guarded-by: _warned_lock
_warned_lock = threading.Lock()

_NUMERIC = ("int", "float")
_FLAGS = ("flag-on", "flag-opt-in", "flag-set")


def reset_warnings() -> None:
    """Forget which knobs already warned (test hook)."""
    with _warned_lock:
        _warned.clear()


def warn_once(env: str, raw: object, default: object, problem: str,
              owner: str = __name__) -> None:
    """Warn-once-and-pin-default, shard_knobs style.  Exposed so owning
    modules that keep their own parse (spec knobs, legacy wrappers) can
    share the one-warning-per-process budget."""
    with _warned_lock:
        if env in _warned:
            return
        _warned.add(env)
    logging.getLogger(owner).warning(
        "%s=%r %s; pinning the default %r for the life of this process "
        "(fix the env and restart)", env, raw, problem, default)


class Knob:
    """One declared environment flag.  Reads are always fresh (tests
    monkeypatch the environment); only the *warning* is once-per-process.
    Layered pins (ops/solver.shard_knobs) stay in their owning module and
    route their parses through here."""

    __slots__ = ("env", "kind", "default", "doc", "parity", "minimum",
                 "clamp_min", "owner", "help")

    def __init__(self, env: str, kind: str, default, doc: str, help: str,
                 parity: bool = False, minimum: Optional[int] = None,
                 clamp_min: Optional[int] = None,
                 owner: str = __name__):
        self.env = env
        self.kind = kind
        self.default = default
        self.doc = doc
        self.help = help
        self.parity = parity
        self.minimum = minimum
        self.clamp_min = clamp_min
        self.owner = owner

    # -- accessors ----------------------------------------------------

    def raw(self) -> Optional[str]:
        """The unparsed value, or None when unset.  The only accessor
        for str/spec knobs — their owners parse (and deliberately raise
        on malformed specs)."""
        return os.environ.get(self.env)

    def enabled(self) -> bool:
        """Boolean read for the flag kinds."""
        raw = os.environ.get(self.env)
        if self.kind == "flag-set":
            return bool(raw)
        if self.kind == "flag-on":
            if raw not in (None, "", "0", "1"):
                self._warn(raw, "is neither 0 nor 1")
            return raw != "0"
        if self.kind == "flag-opt-in":
            if raw not in (None, "", "0", "1"):
                self._warn(raw, "is neither 0 nor 1")
            return raw == "1"
        raise TypeError("%s is a %s knob, not a flag" % (self.env, self.kind))

    def tristate(self) -> Optional[bool]:
        """None when unset (caller decides elsewhere), else forced
        on/off.  An empty value forces *off* — matching the historical
        ``is not None`` routing checks."""
        if self.kind != "tristate":
            raise TypeError("%s is a %s knob, not tristate"
                            % (self.env, self.kind))
        raw = os.environ.get(self.env)
        if raw is None:
            return None
        if raw not in ("", "0", "1"):
            self._warn(raw, "is neither 0 nor 1")
        return raw == "1"

    def value(self) -> Union[int, float]:
        """Validated numeric read: malformed or below-``minimum`` values
        warn once and pin the default; ``clamp_min`` floors silently."""
        if self.kind not in _NUMERIC:
            raise TypeError("%s is a %s knob, not numeric"
                            % (self.env, self.kind))
        raw = os.environ.get(self.env)
        if not raw:
            return self.default
        cast = int if self.kind == "int" else float
        try:
            val = cast(raw)
        except ValueError:
            self._warn(raw, self._problem())
            return self.default
        if self.minimum is not None and val < self.minimum:
            self._warn(raw, self._problem())
            return self.default
        if self.clamp_min is not None and val < self.clamp_min:
            val = self.clamp_min
        return val

    # -- internals ----------------------------------------------------

    def _problem(self) -> str:
        if self.kind == "int":
            if self.minimum is not None:
                return "is not an integer >= %d" % self.minimum
            return "is not an integer"
        return "is not a number"

    def _warn(self, raw, problem: str) -> None:
        warn_once(self.env, raw, self.default, problem, owner=self.owner)

    def __repr__(self) -> str:  # debugging/inventory aid
        return "Knob(%s, %s, default=%r)" % (self.env, self.kind,
                                             self.default)


REGISTRY: Dict[str, Knob] = {}   # env name -> Knob; frozen after import


def _knob(env: str, kind: str, default, doc: str, help: str,
          parity: bool = False, minimum: Optional[int] = None,
          clamp_min: Optional[int] = None,
          owner: str = __name__) -> Knob:
    if env in REGISTRY:
        raise ValueError("duplicate knob declaration: %s" % env)
    k = Knob(env, kind, default, doc, help, parity=parity,
             minimum=minimum, clamp_min=clamp_min, owner=owner)
    REGISTRY[env] = k
    return k


def by_env(env: str) -> Knob:
    """Lookup by environment-variable name; raises KeyError on an
    undeclared flag (an undeclared read is a lint failure anyway)."""
    return REGISTRY[env]


# ---------------------------------------------------------------------
# The registry.  One declaration per KUBE_BATCH_TPU_* flag; the
# knob-registry lint rule pins this set against doc/INVENTORY.md and
# against actual reads.  Keep alphabetical-by-subsystem, not by name,
# so related flags read together.
# ---------------------------------------------------------------------

# -- tracing / observability ------------------------------------------
TRACE = _knob(
    "KUBE_BATCH_TPU_TRACE", "flag-on", True, "doc/OBSERVABILITY.md",
    "Per-session span recording (0 disables the tracer entirely)",
    owner="kube_batch_tpu_torch.trace.spans")
TRACE_RING = _knob(
    "KUBE_BATCH_TPU_TRACE_RING", "int", 64, "doc/OBSERVABILITY.md",
    "FlightRecorder capacity in completed session traces",
    minimum=1, owner="kube_batch_tpu_torch.trace.lineage")
LINEAGE = _knob(
    "KUBE_BATCH_TPU_LINEAGE", "flag-on", True, "doc/OBSERVABILITY.md",
    "Per-pod decision lineage capture (0 disables)",
    owner="kube_batch_tpu_torch.trace.lineage")
LINEAGE_RING = _knob(
    "KUBE_BATCH_TPU_LINEAGE_RING", "int", 2048, "doc/OBSERVABILITY.md",
    "Pod-lineage ring capacity in tracked pods",
    minimum=1, owner="kube_batch_tpu_torch.trace.lineage")
PROFILE = _knob(
    "KUBE_BATCH_TPU_PROFILE", "str", None, "doc/OBSERVABILITY.md",
    "Directory for on-demand torch.profiler captures (unset disables)",
    owner="kube_batch_tpu_torch.actions.tpu_allocate")
METRIC_SERIES_CAP = _knob(
    "KUBE_BATCH_TPU_METRIC_SERIES_CAP", "int", 64, "doc/OBSERVABILITY.md",
    "Per-metric label-series cardinality cap before the 'other' bucket",
    minimum=1, owner="kube_batch_tpu_torch.metrics.metrics")
MEMTRACE = _knob(
    "KUBE_BATCH_TPU_MEMTRACE", "flag-opt-in", False, "doc/OBSERVABILITY.md",
    "tracemalloc capture behind /debug/memory (1 enables; off = zero "
    "overhead)", owner="kube_batch_tpu_torch.metrics.memledger")
MEM_AUDIT_EVERY = _knob(
    "KUBE_BATCH_TPU_MEM_AUDIT_EVERY", "int", 0, "doc/OBSERVABILITY.md",
    "Run audit_mem_ledgers() every N scheduler cycles (0 disables)",
    clamp_min=0, owner="kube_batch_tpu_torch.scheduler")

# -- scheduler loop ---------------------------------------------------
MAX_CYCLE_BACKOFF_S = _knob(
    "KUBE_BATCH_TPU_MAX_CYCLE_BACKOFF_S", "float", 30.0,
    "doc/OBSERVABILITY.md",
    "Ceiling for the crash-loop exponential backoff, seconds",
    owner="kube_batch_tpu_torch.scheduler")
COALESCE_MS = _knob(
    "KUBE_BATCH_TPU_COALESCE_MS", "float", 10.0, "doc/INCREMENTAL.md",
    "Informer-wake coalescing window, milliseconds",
    owner="kube_batch_tpu_torch.scheduler")
BIND_RETRIES = _knob(
    "KUBE_BATCH_TPU_BIND_RETRIES", "int", 2, "doc/CHAOS.md",
    "Bind POST retry budget for delivery-failure errors (0 disables)",
    clamp_min=0, owner="kube_batch_tpu_torch.cache.cache")

# -- device solver ----------------------------------------------------
FUSED = _knob(
    "KUBE_BATCH_TPU_FUSED", "flag-on", True, "doc/FUSED.md",
    "One-dispatch fused session program (0 falls back to the ladder)",
    parity=True, owner="kube_batch_tpu_torch.ops.fused_solver")
FUSED_STORM = _knob(
    "KUBE_BATCH_TPU_FUSED_STORM", "flag-on", True, "doc/FUSED.md",
    "Post-eviction placements inside the fused program (0 re-dispatches "
    "per family after evictions)",
    parity=True, owner="kube_batch_tpu_torch.ops.fused_solver")
CANDIDATE_SOLVE = _knob(
    "KUBE_BATCH_TPU_CANDIDATE_SOLVE", "flag-on", True, "doc/FUSED.md",
    "Candidate-prefiltered solve (0 scores the full node set)",
    parity=True, owner="kube_batch_tpu_torch.ops.prefilter")
PIPELINE = _knob(
    "KUBE_BATCH_TPU_PIPELINE", "flag-on", True, "doc/PIPELINE.md",
    "Async dispatch window overlapping host commit with device solve",
    parity=True, owner="kube_batch_tpu_torch.actions.tpu_allocate")
SHARD_NODES = _knob(
    "KUBE_BATCH_TPU_SHARD_NODES", "int", 16384, "doc/SHARDING.md",
    "Node-count threshold that routes a session to the sharded solver",
    owner="kube_batch_tpu_torch.ops.solver")
SHARD_BYTES = _knob(
    "KUBE_BATCH_TPU_SHARD_BYTES", "int", 256 * 1024 * 1024,
    "doc/SHARDING.md",
    "Session tensor-footprint threshold for the sharded solver, bytes",
    owner="kube_batch_tpu_torch.ops.solver")
FORCE_SHARD = _knob(
    "KUBE_BATCH_TPU_FORCE_SHARD", "flag-opt-in", False, "doc/SHARDING.md",
    "Force the sharded solver regardless of thresholds (1 forces)",
    parity=True, owner="kube_batch_tpu_torch.ops.solver")
SOLVE_DEADLINE_MS = _knob(
    "KUBE_BATCH_TPU_SOLVE_DEADLINE_MS", "float", 0.0, "doc/CHAOS.md",
    "Per-session device solve deadline, milliseconds (0 disables)",
    owner="kube_batch_tpu_torch.chaos.breaker")

# -- degradation ------------------------------------------------------
CHAOS = _knob(
    "KUBE_BATCH_TPU_CHAOS", "spec", None, "doc/CHAOS.md",
    "Fault-injection plan spec (site:prob[:seed],...); malformed raises",
    owner="kube_batch_tpu_torch.chaos.plan")
BREAKER_THRESHOLD = _knob(
    "KUBE_BATCH_TPU_BREAKER_THRESHOLD", "int", 3, "doc/CHAOS.md",
    "Consecutive device failures before the circuit breaker opens",
    owner="kube_batch_tpu_torch.chaos.breaker")
BREAKER_COOLDOWN_S = _knob(
    "KUBE_BATCH_TPU_BREAKER_COOLDOWN_S", "float", 30.0, "doc/CHAOS.md",
    "Open-state cooldown before the breaker half-opens, seconds",
    owner="kube_batch_tpu_torch.chaos.breaker")

# -- edge / ingest ----------------------------------------------------
WIRE_SHARD = _knob(
    "KUBE_BATCH_TPU_WIRE_SHARD", "flag-on", True, "doc/INGEST.md",
    "Shard-scoped watch registration (0 mirrors the full cluster)",
    parity=True, owner="kube_batch_tpu_torch.edge.wire_shard")
LAZY_MIRROR = _knob(
    "KUBE_BATCH_TPU_LAZY_MIRROR", "flag-on", True, "doc/INGEST.md",
    "Lazy out-of-scope mirror hydration on the edge client",
    parity=True, owner="kube_batch_tpu_torch.edge.wire_shard")
BASELINE_BUDGET = _knob(
    "KUBE_BATCH_TPU_BASELINE_BUDGET", "spec", None, "doc/INGEST.md",
    "Bounded baseline store budget spec; malformed raises",
    owner="kube_batch_tpu_torch.edge.baseline")

# -- tenancy / federation ---------------------------------------------
TENANCY = _knob(
    "KUBE_BATCH_TPU_TENANCY", "spec", None, "doc/TENANCY.md",
    "Queue-shard tenancy spec (shard count / off); malformed raises",
    parity=True, owner="kube_batch_tpu_torch.tenancy.shards")
SHARD_MAP = _knob(
    "KUBE_BATCH_TPU_SHARD_MAP", "spec", None, "doc/TENANCY.md",
    "Explicit queue->shard assignment spec; malformed raises",
    owner="kube_batch_tpu_torch.tenancy.shards")
CONCURRENT_SHARDS = _knob(
    "KUBE_BATCH_TPU_CONCURRENT_SHARDS", "flag-on", True, "doc/TENANCY.md",
    "Pipelined dirty-shard micro-sessions (0 runs shards sequentially)",
    parity=True, owner="kube_batch_tpu_torch.tenancy.pipeline")
SHARD_INFLIGHT = _knob(
    "KUBE_BATCH_TPU_SHARD_INFLIGHT", "int", 2, "doc/TENANCY.md",
    "Concurrent shard micro-session pipeline depth",
    minimum=1, owner="kube_batch_tpu_torch.tenancy.pipeline")

# -- session engine ---------------------------------------------------
INCREMENTAL = _knob(
    "KUBE_BATCH_TPU_INCREMENTAL", "flag-on", True, "doc/INCREMENTAL.md",
    "Incremental micro-sessions (0 rebuilds the session every cycle)",
    parity=True, owner="kube_batch_tpu_torch.models.incremental")
FULL_EVERY = _knob(
    "KUBE_BATCH_TPU_FULL_EVERY", "int", 16, "doc/INCREMENTAL.md",
    "Force a full session rebuild every K cycles (0 disables the floor)",
    clamp_min=0, owner="kube_batch_tpu_torch.models.incremental")
WIRE_FAST = _knob(
    "KUBE_BATCH_TPU_WIRE_FAST", "flag-on", True, "doc/INCREMENTAL.md",
    "Wire-to-tensor fast path for small-shape churn deltas",
    parity=True, owner="kube_batch_tpu_torch.models.incremental")
LAZY_TASKS = _knob(
    "KUBE_BATCH_TPU_LAZY_TASKS", "flag-on", True, "doc/INCREMENTAL.md",
    "Lazy per-node task-list materialization in NodeInfo",
    parity=True, owner="kube_batch_tpu_torch.api.node_info")
BATCH_COMMIT = _knob(
    "KUBE_BATCH_TPU_BATCH_COMMIT", "flag-on", True, "doc/EVICTION.md",
    "Batched commit/apply flush at cycle end (0 commits per-decision)",
    parity=True, owner="kube_batch_tpu_torch.framework.commit")
DELTA_SHIP = _knob(
    "KUBE_BATCH_TPU_DELTA_SHIP", "flag-on", True, "doc/SHARDING.md",
    "Dirty-block delta shipping to device-resident session tensors",
    parity=True, owner="kube_batch_tpu_torch.models.shipping")

# -- eviction / scanner -----------------------------------------------
BATCH_EVICT = _knob(
    "KUBE_BATCH_TPU_BATCH_EVICT", "flag-on", True, "doc/EVICTION.md",
    "Batched eviction engine (0 falls back to sequential victim scans)",
    parity=True, owner="kube_batch_tpu_torch.models.scanner")
EVICT_SHIP = _knob(
    "KUBE_BATCH_TPU_EVICT_SHIP", "tristate", None, "doc/EVICTION.md",
    "Force eviction delta-shipping on (1) or off (other); unset routes",
    parity=True, owner="kube_batch_tpu_torch.models.scanner")
SCAN_MIN_NODES = _knob(
    "KUBE_BATCH_TPU_SCAN_MIN_NODES", "int", 64, "doc/EVICTION.md",
    "Minimum cluster size before the device node scanner engages",
    owner="kube_batch_tpu_torch.models.scanner")
SCAN_DEVICE = _knob(
    "KUBE_BATCH_TPU_SCAN_DEVICE", "flag-opt-in", False, "doc/EVICTION.md",
    "Force device scoring even on the CPU backend (1 forces)",
    owner="kube_batch_tpu_torch.models.scanner")
SAFE_SCORES = _knob(
    "KUBE_BATCH_TPU_SAFE_SCORES", "flag-opt-in", False, "doc/EVICTION.md",
    "Defensive copy of the live device score view (1 copies)",
    owner="kube_batch_tpu_torch.models.scanner")

# -- topology ---------------------------------------------------------
TOPOLOGY = _knob(
    "KUBE_BATCH_TPU_TOPOLOGY", "flag-on", True, "doc/TOPOLOGY.md",
    "Topology-aware slice placement (0 ignores interconnect shape)",
    parity=True, owner="kube_batch_tpu_torch.models.topology")
TOPO_BATCH = _knob(
    "KUBE_BATCH_TPU_TOPO_BATCH", "flag-on", True, "doc/TOPOLOGY.md",
    "Batched device-side slice search (0 scans hosts sequentially)",
    parity=True, owner="kube_batch_tpu_torch.models.topology")
TOPO_DEFRAG = _knob(
    "KUBE_BATCH_TPU_TOPO_DEFRAG", "flag-on", True, "doc/TOPOLOGY.md",
    "Defrag-aware eviction scoring (0 scores capacity only)",
    parity=True, owner="kube_batch_tpu_torch.models.topology")
TOPO_MAX_NODES = _knob(
    "KUBE_BATCH_TPU_TOPO_MAX_NODES", "int", 4096, "doc/TOPOLOGY.md",
    "Topology engine node-count ceiling before falling back flat",
    minimum=1, owner="kube_batch_tpu_torch.trace.lineage")

# -- native -----------------------------------------------------------
NO_NATIVE = _knob(
    "KUBE_BATCH_TPU_NO_NATIVE", "flag-set", False, "doc/INVENTORY.md",
    "Kill switch: any non-empty value disables native extensions",
    owner="kube_batch_tpu_torch.native")


# ---------------------------------------------------------------------
# Inventory emission (make lint-inventory -> doc/INVENTORY.md).
# ---------------------------------------------------------------------

def inventory_rows():
    """Markdown table rows for doc/INVENTORY.md, one per knob, sorted by
    env name — regenerated by ``python -m tools.graftlint
    --write-knob-inventory`` so the doc can never drift."""
    rows = []
    for env in sorted(REGISTRY):
        k = REGISTRY[env]
        if k.kind in _NUMERIC:
            default = repr(k.default)
        elif k.kind in _FLAGS:
            default = "on" if k.default else "off"
        elif k.kind == "tristate":
            default = "unset"
        else:
            default = "unset" if k.default is None else repr(k.default)
        parity = "yes" if k.parity else "—"
        anchor = k.doc.split("/")[-1]   # INVENTORY.md lives in doc/
        rows.append("| `%s` | %s | %s | %s | [%s](%s) | %s |"
                    % (env, k.kind, default, parity, anchor, anchor,
                       k.help))
    return rows
