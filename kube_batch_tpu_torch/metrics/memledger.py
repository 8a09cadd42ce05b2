"""Fleet memory ledger: per-subsystem byte accounting for every
growable store in the replica (doc/OBSERVABILITY.md "Memory ledger").

``kube_batch_wire_baseline_bytes`` was the ONLY byte ledger in the
system; ROADMAP item 1's residual memory wall (the unbounded dataclass
mirror, resident device buffers, tensor caches, trace rings) grew
invisibly.  This module generalizes the ``audit_baseline_bytes``
discipline: every growable store registers one or more *components*
under a named ledger and keeps the ledger current with ``add``/``set``
delta hooks at its existing mutation chokepoints; ``audit_mem_ledgers``
recomputes true sizes from the stores themselves and fails loudly on
drift, so a forgotten hook is a test failure, not a silent leak.

Design rules:

* **Lock-cheap.**  Each ledger has one small leaf mutex; hooks do a
  dict write, an int add, and a watermark compare.  Gauge publication
  (``kube_batch_tpu_mem_bytes{ledger}``) happens outside the mutex and
  can be granularity-batched for hot rings (``publish_granularity``),
  while the internal ledger stays byte-exact for /debug/memory and the
  audit.  The ledger mutex is a *leaf*: hooks may run under a store's
  own lock, but the ledger never calls back into a store while holding
  its mutex (auditor sizers run unlocked — see ``audit``).
* **Lifetime-tied.**  Components are keyed to their owning store via
  ``track(owner, subkey, sizer)``; a ``weakref.finalize`` drops the
  bytes AND the auditor when the store is garbage collected, so
  per-test / per-arm store churn cannot accrete phantom bytes.  The
  finalizer only queues the key, without a lock, and every locked
  section drains the queue first: a collection can run at any
  allocation, also one made with this ledger's mutex (or the metrics'
  lock) held by the same thread, where a finalizer that took the mutex
  would wait on itself forever.  (The reference's ledger,
  kube_batch_tpu/metrics/memledger.py, drops under the mutex from the
  finalizer and can deadlock that way.)
* **Watermarks carry provenance.**  Each ledger records its
  high-watermark and the session id (trace/spans) active when the
  watermark was set — "which session peaked the stage buffers" is a
  /debug/memory read, not a bisection.
* **Estimates are shared.**  Where a store accounts an estimate (flat
  per-object shell costs for the dataclass mirror, per-event ring
  costs), the hook and the auditor use the same sizer formula, so the
  audit checks *hook coverage*, never estimate quality.

Gauges are written ONLY through this module (graftlint rule 11,
ledger-discipline); instrumented classes carry a ``# mem-ledger:
<name>`` marker in their docstring, which the same rule pins to an
actual registration call in the owning file.
"""

from __future__ import annotations

import threading
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .. import knobs
from . import metrics

__all__ = [
    "LEDGER_CATALOGUE", "Ledger", "MemAuditError", "ledger", "ledgers",
    "totals", "watermarks", "snapshot", "debug_doc", "audit_mem_ledgers",
    "reset", "rss_bytes",
]

#: The fleet ledger catalogue.  Eagerly created at import so
#: /debug/memory always lists the full surface (a ledger at 0 bytes is
#: information: that store is empty, not unaccounted).
LEDGER_CATALOGUE: Tuple[Tuple[str, str], ...] = (
    ("mirror", "decoded dataclass mirror objects, all resource kinds "
               "(edge/client.py stores; flat per-object shell estimate)"),
    ("pending", "deferred lazy-mirror raw frames awaiting first read "
                "(edge/client.py _pending; raw wire bytes)"),
    ("baseline", "retained wire-doc delta baselines, hot + compressed "
                 "(edge/client.py; absorbs kube_batch_wire_baseline_bytes)"),
    ("tensor_cache", "persistent TensorCache job blocks + node pack "
                     "(models/tensor_snapshot.py; array nbytes)"),
    ("stage", "persistent candidate-row staging buffers "
              "(models/tensor_snapshot.py; array nbytes)"),
    ("resident", "device-resident shipper buffers, full + per-shard "
                 "(models/shipping.py; host+device array nbytes)"),
    ("incremental", "incremental session state: signature masks, bonus "
                    "and job aggregates (models/incremental.py)"),
    ("compile_cache", "warmed solve-signature keys "
                      "(ops/compile_cache.py; flat per-key estimate)"),
    ("trace_ring", "flight-recorder ring of completed session traces "
                   "(trace/recorder.py; per-span/verdict estimate)"),
    ("lineage_ring", "pod-lineage ring + session ledger "
                     "(trace/lineage.py; per-pod estimate)"),
    ("event_ring", "cache event deque (cache/cache.py; per-event "
                   "estimate)"),
    ("snapshot_pool", "pooled job/node clones reused across session "
                      "snapshots (cache/cache.py; per-clone estimate)"),
    ("fused_storm", "post-eviction storm-leg capture: victim staging "
                    "columns + proof buffers held until tpu-allocate "
                    "consumes (ops/fused_solver.py; array nbytes)"),
)


class MemAuditError(AssertionError):
    """A ledger disagrees with its store beyond tolerance: some
    mutation path is missing its hook (or double-counts)."""


class Ledger:
    """One named byte account.  Components are ``(id(owner), subkey)``
    keys whose bytes and auditors die with the owner."""

    __slots__ = ("name", "publish_granularity", "_lock", "_components",
                 "_auditors", "_total", "_watermark", "_watermark_sid",
                 "_published", "_dropped", "__weakref__")

    def __init__(self, name: str, publish_granularity: int = 0):
        self.name = name
        #: Publish the gauge only when the total moved at least this
        #: many bytes (0 = every change).  Keeps per-event ring hooks
        #: off the metrics lock; /debug/memory and audit read the exact
        #: internal total regardless.
        self.publish_granularity = int(publish_granularity)
        self._lock = threading.Lock()
        self._components: Dict[tuple, int] = {}    # guarded-by: _lock
        # key -> (weakref to owner, sizer(owner) -> int)
        self._auditors: Dict[tuple, tuple] = {}    # guarded-by: _lock
        self._total = 0                            # guarded-by: _lock
        self._watermark = 0                        # guarded-by: _lock
        self._watermark_sid: Optional[int] = None  # guarded-by: _lock
        self._published: Optional[int] = None      # guarded-by: _lock
        # Keys of owners that died, queued by their finalizers without a
        # lock (deque.append is atomic) and drained under _lock.
        self._dropped: deque = deque()

    # -- registration --------------------------------------------------

    def track(self, owner, subkey: str = "",
              sizer: Optional[Callable] = None) -> tuple:
        """Register a component tied to ``owner``'s lifetime and return
        its key for ``set``/``add``.  ``sizer(owner) -> int`` recomputes
        the component's true bytes for ``audit`` (it runs with NO ledger
        lock held, so it may take the store's own lock).  When the owner
        is garbage collected the component's bytes and auditor drop
        automatically."""
        key = (id(owner), subkey)
        ref = weakref.ref(owner)
        with self._lock:
            drained = self._drain_locked()
            self._components.setdefault(key, 0)
            if sizer is not None:
                self._auditors[key] = (ref, sizer)
            publish = self._decide_publish_locked() if drained else None
        self._publish(publish)
        weakref.finalize(owner, self._dropped.append, key)
        return key

    def drop(self, key: tuple) -> None:
        """Forget one component (store dismantled)."""
        with self._lock:
            self._drain_locked()
            self._forget_locked(key)
            publish = self._decide_publish_locked()
        self._publish(publish)

    # -- delta hooks ---------------------------------------------------

    def set(self, key: tuple, nbytes: int) -> None:
        """Pin one component to an absolute size (set-hook stores that
        recompute at a chokepoint: tensorize end, snapshot walk end)."""
        nbytes = int(nbytes)
        with self._lock:
            self._drain_locked()
            old = self._components.get(key, 0)
            self._components[key] = nbytes
            self._total += nbytes - old
            publish = self._decide_publish_locked()
        self._publish(publish)

    def add(self, key: tuple, delta: int) -> None:
        """Apply a signed byte delta (delta-hook stores: per-frame
        mirror/pending/compile-cache mutations)."""
        if not delta:
            return
        with self._lock:
            self._drain_locked()
            self._components[key] = self._components.get(key, 0) + int(delta)
            self._total += int(delta)
            publish = self._decide_publish_locked()
        self._publish(publish)

    # -- reads ---------------------------------------------------------

    def total(self) -> int:
        with self._lock:
            self._drain_locked()
            return self._total

    def watermark(self) -> Tuple[int, Optional[int]]:
        with self._lock:
            return self._watermark, self._watermark_sid

    def component_count(self) -> int:
        with self._lock:
            self._drain_locked()
            return len(self._components)

    # -- audit ---------------------------------------------------------

    def audit(self) -> Optional[Tuple[int, int]]:
        """(accounted, actual) or None when nothing registered a sizer.
        Sizers run OUTSIDE the ledger lock (they take their store's own
        lock); components whose owner died between finalize scheduling
        and now are skipped on both sides."""
        with self._lock:
            self._drain_locked()
            auditors = list(self._auditors.items())
            accounted_by_key = dict(self._components)
        accounted = 0
        actual = 0
        audited_any = False
        for key, (ref, sizer) in auditors:
            owner = ref()
            if owner is None:
                continue
            audited_any = True
            accounted += accounted_by_key.get(key, 0)
            actual += int(sizer(owner))
        if not audited_any:
            return None
        return accounted, actual

    def reset(self) -> None:
        """Test hook: zero bytes and watermark, keep registrations."""
        with self._lock:
            self._drain_locked()
            for key in self._components:
                self._components[key] = 0
            self._total = 0
            self._watermark = 0
            self._watermark_sid = None
            self._published = None
        self._publish((0, 0))

    # -- internals -----------------------------------------------------

    # holds-lock: _lock
    def _forget_locked(self, key: tuple) -> None:
        self._total -= self._components.pop(key, 0)
        self._auditors.pop(key, None)

    # holds-lock: _lock
    def _drain_locked(self) -> bool:
        """Forget the components of every owner that died since the last
        locked section; True if there was one."""
        drained = False
        while self._dropped:
            self._forget_locked(self._dropped.popleft())
            drained = True
        return drained

    # holds-lock: _lock
    def _decide_publish_locked(self) -> Optional[Tuple[int, int]]:
        """Watermark upkeep + the gauge-publication decision, returned
        so the actual metrics write happens outside the mutex."""
        grew = self._total > self._watermark
        if grew:
            self._watermark = self._total
            self._watermark_sid = _current_session_id()
        if (not grew and self._published is not None
                and self.publish_granularity > 0
                and abs(self._total - self._published)
                < self.publish_granularity and self._total != 0):
            return None
        self._published = self._total
        return self._total, self._watermark

    def _publish(self, publish: Optional[Tuple[int, int]]) -> None:
        if publish is None:
            return
        total, watermark = publish
        metrics.set_mem_bytes(self.name, total)
        metrics.set_mem_watermark(self.name, watermark)


def _current_session_id() -> Optional[int]:
    """Lazy alias for trace/spans.current_session_id — imported at
    first use so metrics stays importable before the trace package
    (and so a trace-less tool never pays the import)."""
    global _sid_fn
    if _sid_fn is None:
        from ..trace.spans import current_session_id
        _sid_fn = current_session_id
    return _sid_fn()


_sid_fn: Optional[Callable] = None

# Hot rings publish their gauges at 4 KiB granularity; everything else
# publishes every change (the baseline ledger must track
# kube_batch_wire_baseline_bytes exactly — tests pin the parity).
_GRANULARITY = {"event_ring": 4096, "lineage_ring": 4096,
                "snapshot_pool": 4096}

_LEDGERS: Dict[str, Ledger] = {
    name: Ledger(name, _GRANULARITY.get(name, 0))
    for name, _help in LEDGER_CATALOGUE}


def ledger(name: str) -> Ledger:
    """The named ledger; KeyError on a name outside the catalogue (an
    undeclared ledger is invisible to /debug/memory — declare it)."""
    return _LEDGERS[name]


def ledgers() -> List[Ledger]:
    return list(_LEDGERS.values())


def totals() -> Dict[str, int]:
    """{ledger: current bytes} — the per-session mem_delta source."""
    return {name: led.total() for name, led in _LEDGERS.items()}


def watermarks() -> Dict[str, int]:
    return {name: led.watermark()[0] for name, led in _LEDGERS.items()}


def reset() -> None:
    """Test hook: zero every ledger (registrations survive)."""
    for led in _LEDGERS.values():
        led.reset()


# ---------------------------------------------------------------------
# Audit: the generalized audit_baseline_bytes discipline.
# ---------------------------------------------------------------------

def audit_mem_ledgers(rel_tol: float = 0.01, abs_tol: int = 4096,
                      raise_on_drift: bool = True) -> Dict[str, dict]:
    """Recompute every ledger's true size from its stores and compare.

    Returns {ledger: {"accounted", "actual", "drift"}} for every ledger
    with at least one live auditor.  Drift beyond
    ``max(abs_tol, rel_tol * actual)`` raises :class:`MemAuditError`
    (``raise_on_drift=False`` returns the report for tolerant callers —
    the scheduler's periodic audit, which races reflector threads).
    Byte-exact reconciliation is only guaranteed at quiescent points;
    ``abs_tol`` absorbs in-flight frames.
    """
    report: Dict[str, dict] = {}
    bad: List[str] = []
    for name, led in _LEDGERS.items():
        pair = led.audit()
        if pair is None:
            continue
        accounted, actual = pair
        drift = accounted - actual
        report[name] = {"accounted": accounted, "actual": actual,
                        "drift": drift}
        if abs(drift) > max(abs_tol, rel_tol * max(actual, 1)):
            bad.append("%s: accounted=%d actual=%d drift=%+d"
                       % (name, accounted, actual, drift))
    if bad and raise_on_drift:
        raise MemAuditError(
            "memory ledger drift (a mutation path is missing its hook):\n"
            + "\n".join(bad))
    if bad:
        report["_drift"] = {"failures": bad}  # type: ignore[assignment]
    return report


# ---------------------------------------------------------------------
# /debug/memory
# ---------------------------------------------------------------------

def rss_bytes() -> Optional[int]:
    """Process resident set from /proc/self/status (None off-Linux)."""
    try:
        with open("/proc/self/status", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


_memtrace_lock = threading.Lock()
_memtrace_prev = None          # guarded-by: _memtrace_lock


def _tracemalloc_doc(top_k: int = 10) -> Optional[dict]:
    """Top-K allocation-diff rows when KUBE_BATCH_TPU_MEMTRACE=1; None
    (and tracemalloc never imported into action) otherwise — the
    TRACE=0 zero-overhead discipline."""
    if not knobs.MEMTRACE.enabled():
        return None
    import tracemalloc
    global _memtrace_prev
    with _memtrace_lock:
        if not tracemalloc.is_tracing():
            tracemalloc.start()
        snap = tracemalloc.take_snapshot()
        snap = snap.filter_traces((
            tracemalloc.Filter(False, tracemalloc.__file__),))
        if _memtrace_prev is None:
            stats = snap.statistics("lineno")[:top_k]
            rows = [{"site": str(s.traceback), "bytes": s.size,
                     "count": s.count} for s in stats]
            mode = "absolute"
        else:
            stats = snap.compare_to(_memtrace_prev, "lineno")[:top_k]
            rows = [{"site": str(s.traceback), "bytes_delta": s.size_diff,
                     "bytes": s.size, "count_delta": s.count_diff}
                    for s in stats]
            mode = "diff"
        _memtrace_prev = snap
        traced, traced_peak = tracemalloc.get_traced_memory()
    return {"mode": mode, "traced_bytes": traced,
            "traced_peak_bytes": traced_peak, "top": rows}


def snapshot() -> Dict[str, dict]:
    """Per-ledger table: bytes, watermark, watermark session id,
    live component count, and the catalogue help string."""
    out: Dict[str, dict] = {}
    for name, help_text in LEDGER_CATALOGUE:
        led = _LEDGERS[name]
        wm, wm_sid = led.watermark()
        out[name] = {
            "bytes": led.total(),
            "watermark_bytes": wm,
            "watermark_session": wm_sid,
            "components": led.component_count(),
            "what": help_text,
        }
    return out


def debug_doc() -> dict:
    """The /debug/memory document (cli/server.py)."""
    table = snapshot()
    return {
        "ledgers": table,
        "total_bytes": sum(row["bytes"] for row in table.values()),
        "rss_bytes": rss_bytes(),
        "tracemalloc": _tracemalloc_doc(),
    }
