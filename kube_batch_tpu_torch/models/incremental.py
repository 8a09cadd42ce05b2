"""O(churn) incremental sessions: persistent, generation-keyed solver state.

Counterpart of kube_batch_tpu/models/incremental.py, carried over line
for line.  The steady-cycle cost model this module attacks
(doc/INCREMENTAL.md): a 1% churn cycle used to pay O(cluster) four times —
the ``_resource_axis`` full-task scan, the drf/proportion plugin opens
(one Resource.add per allocated task), the [S, N] static predicate mask,
and a fresh device solve even when the shipped bytes were identical to
the previous cycle's.  The dirty set is already computed exactly (the
cache's ``mod_epoch`` stamps, the TensorCache's block/pack epochs,
``Session.mutated_nodes``); this module extends that invalidation
contract to the remaining O(cluster) stages:

* ``begin_tensorize`` — the per-session *plan*: decides micro vs full vs
  fallback from the dirty sets BEFORE any heavy work, revalidates the
  resource axis by scanning only dirty objects, and hands the
  precomputed dirty-node rows to the tensorizer so the epoch walk runs
  once.  Full-rebuild fallback mirrors the delta shipper's policy
  (models/shipping.py): layout/config change, >50% dirty, or the
  periodic full-session floor.
* persistent ``sig_mask``/``sig_bonus`` — the [S, N] static predicate
  mask survives across sessions; only dirty node COLUMNS re-enter the
  predicate chain (the per-(signature, node) evaluation is a pure
  function, so a patched column equals the profile build's bit for bit).
* generation-keyed solve reuse — ``DeviceResidentShipper.generation``
  moves whenever shipped bytes change; a *clean* ship at an unchanged
  generation means the solver inputs are byte-identical to the previous
  dispatch, so the deterministic solve result is reused without a device
  round-trip (actions/tpu_allocate.py).
* plugin-open aggregate caches — drf/proportion per-job open aggregates
  cached on the job CLONE (clone identity is the validity token: a
  session that mutates a clone discards it from the snapshot pool, so a
  reused clone is bit-unchanged).  drf reuse is exact by construction
  (the cached Resource is cloned); proportion reuse is gated on every
  contributing task value being an exact binary integer, so collapsing
  the per-task adds into one per-job add cannot reassociate floats.

Everything gates behind ``KUBE_BATCH_TPU_INCREMENTAL=0`` — the
sequential control arm whose placements/events/binds the CI churn sweep
(`make bench-churn`) pins bit-identical at every churn level.

Thread model: all state here is touched only by the scheduling thread
(session open/execute/close); no locks needed.  The chaos site
``incremental.stale_generation`` forces a mid-cycle generation mismatch
so the fallback-to-full-rebuild path stays exercised (doc/CHAOS.md).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import knobs
from ..chaos import plan as chaos_plan
from ..metrics import memledger, metrics
from ..trace import spans as trace

# =0 restores the sequential control: full tensorize scans, uncached
# plugin opens, a fresh solve every cycle, fixed-period scheduling.
INCREMENTAL_ENV = knobs.INCREMENTAL.env
# Wire-to-tensor fast path (doc/INCREMENTAL.md "Wire fast path"): =0 is
# the sequential control for the L1 columnar watch-delta decode
# (edge/codec), the persistent candidate-row staging buffers
# (tensor_snapshot), and the vectorized drf/job-valid/gang-close walks
# below — `make bench-wire` pins binds+events bit-identical across it.
WIRE_FAST_ENV = knobs.WIRE_FAST.env
# Periodic full-session floor (scheduler.py): every K cycles the loop
# requests a full rebuild so incremental drift cannot accumulate
# silently.  0 disables the floor.
FULL_EVERY_ENV = knobs.FULL_EVERY.env
DEFAULT_FULL_EVERY = knobs.FULL_EVERY.default

# Above this dirty fraction the micro patch moves more rows than a full
# rebuild saves — mirror of the delta shipper's _DELTA_MAX_FRACTION.
_DIRTY_MAX_FRACTION = 0.5

# Exactness bound for the proportion aggregate cache: integer-valued f64
# below this stays exactly representable through every partial sum a
# realistic cluster can accumulate (cluster totals stay far under 2^53).
_EXACT_LIMIT = float(2 ** 50)


def incremental_enabled() -> bool:
    return knobs.INCREMENTAL.enabled()


def wire_fast_enabled() -> bool:
    return knobs.WIRE_FAST.enabled()


def full_session_every() -> int:
    return knobs.FULL_EVERY.value()


def resource_exact(res) -> bool:
    """True when every dimension of ``res`` is an exact binary integer
    small enough that float addition of such values cannot round — the
    condition under which per-job partial sums equal the per-task add
    sequence bit for bit (see ProportionPlugin.on_session_open)."""
    mc = float(res.milli_cpu)
    mem = float(res.memory)
    if not (mc.is_integer() and mem.is_integer()):
        return False
    if abs(mc) > _EXACT_LIMIT or abs(mem) > _EXACT_LIMIT:
        return False
    if res.scalar_resources:
        for v in res.scalar_resources.values():
            fv = float(v)
            if not fv.is_integer() or abs(fv) > _EXACT_LIMIT:
                return False
    return True


def _inc_state_nbytes(st: "IncrementalState") -> int:
    """Array bytes retained across sessions: the persistent signature
    mask/bonus and the per-job aggregate columns.  Shared by the
    finish_tensorize set-hook and the memledger auditor."""
    n = 0
    for a in (st.sig_mask, st.sig_bonus):
        n += int(getattr(a, "nbytes", 0) or 0)
    agg = st.job_agg
    if agg is not None:
        for name in ("epochs", "min_avail", "ready", "valid", "alloc",
                     "shares"):
            n += int(getattr(getattr(agg, name, None), "nbytes", 0) or 0)
    return n


class IncrementalState:
    """Cross-session incremental bookkeeping, attached to an
    epoch-stamped SchedulerCache (mirror of tensor_snapshot's
    TensorCache persistence gate).  Scheduling-thread only.

    Memory accounting (metrics/memledger.py):
    # mem-ledger: incremental
    """

    def __init__(self):
        # Monotonic build counter: bumps once per COMPLETED tensorize
        # (micro or full).  Observability + test hooks; the solve cache
        # below keys on the shipper's byte-generation instead.
        self.generation: int = 0
        # Last completed build's layout facts (micro-plan validation).
        self.axis: Optional[Tuple[str, ...]] = None
        self.struct: Optional[dict] = None
        self.node_count: int = 0
        self.job_count: int = 0
        # Persistent static predicate mask: [S, n_pad] + the sig tuples
        # and node list it was built for.  Dirty node columns are
        # re-evaluated in place (micro path); anything else rebuilds.
        self.sig_tuples: Optional[tuple] = None
        self.sig_mask = None            # np.ndarray [S, n_pad] bool
        self.sig_bonus = None           # np.ndarray [S, n_pad] int64
        self.sig_examples: Dict[tuple, tuple] = {}
        # Generation-keyed solve-result cache (actions/tpu_allocate.py):
        # valid while the shipper's resident bytes are unchanged.  The
        # byte-generation contract is layout-blind on purpose: the
        # per-shard mesh layout (doc/SHARDING.md) moves the generation
        # through the same full/delta/clean discipline, so a clean ship
        # on the mesh proves byte-identical inputs exactly as on one
        # chip and the cached result stays reusable.  ``solve_route``
        # records which engine produced the cached result (cuda |
        # torch) purely for observability — the parity suite
        # makes every route placement-identical, so a route flip never
        # invalidates the cache.
        self.solve_gen: int = -1
        self.solve_cfg = None
        self.solve_result: Optional[tuple] = None
        self.solve_route: str = ""
        # One-shot full-rebuild request (the scheduler's periodic floor,
        # and the chaos stale-generation recovery path).
        self.force_full: bool = False
        # True between begin_tensorize and finish_tensorize.  Still True
        # at the NEXT begin means the previous build aborted mid-way
        # (tensorizer fallback_reason early-return, or an exception)
        # AFTER the pack refresh may have advanced node epochs but
        # BEFORE the mask was patched/stored — the persisted mask and
        # solve cache can then be stale for nodes that now look clean,
        # so both are dropped before planning (the pack itself is safe:
        # its refreshed rows were staged from live truth).
        self.build_open: bool = False
        # Accumulated churn footprint of the last closed session
        # (framework/session.py close_session) — observability.
        self.last_mutated_jobs: int = 0
        self.last_mutated_nodes: int = 0
        self.last_kind: str = ""
        self.last_reason: str = ""
        self.stats = {"micro": 0, "full": 0, "fallback": 0}
        # Persistent per-job aggregate columns (the wire-to-tensor fast
        # path's plugin-layer leg, doc/INCREMENTAL.md "Wire fast path"):
        # min_available / ready / valid task counts and the DRF open
        # allocation vectors, patched for dirty jobs only and consumed
        # as numpy column ops by plugins/drf.py's share computation, the
        # open_session job_valid gate, and plugins/gang.py's close walk.
        self.job_agg: Optional["JobAggregates"] = None
        self._mem_key = memledger.ledger("incremental").track(
            self, sizer=_inc_state_nbytes)

    def _mem_refresh(self) -> None:
        """Set-hook: re-price the incremental ledger (finish_tensorize
        — the chokepoint where the persistent arrays are rebound)."""
        memledger.ledger("incremental").set(self._mem_key,
                                            _inc_state_nbytes(self))

    def invalidate_solve(self) -> None:
        self.solve_gen = -1
        self.solve_result = None
        self.solve_cfg = None


def state_for(cache, create: bool = True) -> Optional[IncrementalState]:
    """The cache's persistent IncrementalState, or None for cache objects
    without epoch stamping (same gate as tensor_snapshot._tensor_cache:
    reuse without invalidation keys would serve stale tensors)."""
    st = getattr(cache, "_inc_state", None)
    if st is not None or not create:
        return st
    if hasattr(cache, "epoch") and isinstance(getattr(cache, "jobs", None),
                                              dict):
        st = IncrementalState()
        try:
            cache._inc_state = st
        except AttributeError:
            return None
        return st
    return None


def request_full(cache) -> None:
    """Force the next tensorize to run a full rebuild (the scheduler's
    periodic full-session floor; doc/INCREMENTAL.md 'micro vs full').
    The same floor revalidates the incremental snapshot map and the
    quiet-close bookkeeping: the next cache.snapshot() runs the full
    walk, so close_session re-walks every job too — no skip survives
    more than KUBE_BATCH_TPU_FULL_EVERY cycles unrevalidated."""
    st = state_for(cache)
    if st is not None:
        st.force_full = True
    req = getattr(cache, "request_full_snapshot", None)
    if req is not None:
        req()


def note_session_mutations(cache, mutated_jobs: int,
                           mutated_nodes: int) -> None:
    """Record the closed session's mutation footprint (close_session):
    the accumulated churn the next cycle's plan reports alongside its
    own dirty counts."""
    st = state_for(cache, create=False)
    if st is not None:
        st.last_mutated_jobs = int(mutated_jobs)
        st.last_mutated_nodes = int(mutated_nodes)


def plugin_cache_enabled(cache) -> bool:
    """Whether the plugin-open aggregate caches may be consulted.  Pure
    env gate: clone identity alone keys validity, so non-pooled caches
    simply never hit (fresh clones every cycle)."""
    return incremental_enabled()


def node_open_aggregates(ssn):
    """The snapshot map's node-open aggregates for this session —
    (total_allocatable | None, grid_cap, grid_used, shift) — or None
    when unavailable (control arm, cold map, foreign cache).  Each call
    returns PRIVATE copies: two GridUsage consumers in one session (e.g.
    nodeorder + tpu-score) mutate their ``used`` mirrors independently,
    exactly like two control-path instances (doc/INCREMENTAL.md
    "floors")."""
    if not incremental_enabled():
        return None
    fn = getattr(ssn.cache, "node_open_aggregates", None)
    if fn is None:
        return None
    return fn()


def cluster_total_allocatable(ssn):
    """Exact-integer cached sum of every session node's allocatable, or
    None (fractional dimension somewhere / aggregates unavailable): the
    O(nodes) open walk of drf and proportion, served from the snapshot
    map.  Each caller gets a private clone (plugins own their total)."""
    agg = node_open_aggregates(ssn)
    if agg is None or agg[0] is None:
        return None
    return agg[0].clone()


class SessionPlan:
    """One session's incremental decision, computed before any heavy
    tensorize work.  ``kind``:

    * ``micro``    — axis + persistent mask reused; only dirty rows
                      re-enter the staging (``axis`` is set).
    * ``full``     — no previous state, or the periodic floor forced a
                      rebuild (``axis`` None: full scans run).
    * ``fallback`` — a micro attempt was invalidated (layout/cfg change,
                      >50% dirty, injected stale generation); full
                      scans run and the reason is recorded.
    """

    __slots__ = ("state", "kind", "reason", "axis", "node_dirty",
                 "dirty_jobs", "dirty_nodes", "mask_reusable")

    def __init__(self, state: IncrementalState, kind: str, reason: str,
                 axis=None, node_dirty=None, dirty_jobs: int = 0,
                 dirty_nodes: int = 0, mask_reusable: bool = False):
        self.state = state
        self.kind = kind
        self.reason = reason
        self.axis = axis
        self.node_dirty = node_dirty    # [(ix, epoch|None)] reusable rows
        self.dirty_jobs = dirty_jobs
        self.dirty_nodes = dirty_nodes
        self.mask_reusable = mask_reusable


def _dirty_node_rows(node_names, node_objs, mutated_nodes,
                     pack) -> List[tuple]:
    """The node rows whose snapshot epoch moved past the pack's stamp
    (plus session-mutated ones) — the exact walk the tensorizer's pack
    refresh performs, extracted so plan and refresh share one pass."""
    dirty = []
    for ix, name in enumerate(node_names):
        if name in mutated_nodes:
            dirty.append((ix, None))
            continue
        ep = getattr(node_objs[ix], "snap_epoch", None)
        if ep is not None and pack.epochs[ix] == ep:
            continue
        dirty.append((ix, ep))
    return dirty


def _job_is_dirty(tc, uid, job, mutated_jobs) -> bool:
    if uid in mutated_jobs:
        return True
    snap_epoch = getattr(job, "snap_epoch", None)
    if snap_epoch is None:
        return True
    block = tc.jobs.get(uid)
    return block is None or block.epoch != snap_epoch


def _scalars_in_job(job) -> bool:
    for t in job.tasks.values():
        if t.resreq.scalar_resources or t.init_resreq.scalar_resources:
            return True
    return False


def _struct_key(struct: dict) -> tuple:
    """Hashable form of plugin_structure's output: the conf-derived
    facts the persisted mask/bonus (and the whole micro plan) are only
    valid under.  A session opened with different tiers on the same
    cache must rebuild."""
    return (tuple(struct["job_order"]), tuple(struct["queue_order"]),
            struct["has_gang"], struct["has_proportion"],
            struct["has_predicates"], struct["weights"],
            struct["w_podaff"], struct["w_nodeaff"])


def begin_tensorize(ssn, tc, node_names, node_objs,
                    mutated_jobs, mutated_nodes,
                    struct) -> Optional[SessionPlan]:
    """Plan this session's tensorize.  Returns None when incremental
    sessions are disabled or the cache cannot persist state — the
    tensorizer then runs exactly the pre-incremental path."""
    if not incremental_enabled():
        return None
    st = state_for(ssn.cache)
    if st is None or not getattr(tc, "persistent", False):
        return None

    if st.build_open:
        # The previous build never reached finish_tensorize (see the
        # field's docstring): drop everything that could be stale
        # relative to the advanced pack epochs.
        st.sig_tuples = None
        st.sig_mask = None
        st.sig_bonus = None
        st.invalidate_solve()
        st._mem_refresh()  # the dropped arrays must leave the books too
    st.build_open = True

    struct_key = _struct_key(struct)
    if st.force_full:
        st.force_full = False
        st.struct = struct_key
        return SessionPlan(st, "full", "periodic full-session floor")
    if st.axis is None:
        st.struct = struct_key
        return SessionPlan(st, "full", "first session")
    if st.struct != struct_key:
        # Conf change on a live cache: every persisted tensor (mask
        # bonus weights, predicate enablement) — and the example cache
        # the mask patcher probes the predicate chain with — is keyed
        # to the old tiers.
        st.struct = struct_key
        st.sig_examples.clear()
        st.invalidate_solve()
        return SessionPlan(st, "fallback", "plugin/tier structure changed")

    def fallback(reason: str, dirty_jobs=0, dirty_nodes=0) -> SessionPlan:
        return SessionPlan(st, "fallback", reason, dirty_jobs=dirty_jobs,
                           dirty_nodes=dirty_nodes)

    # Chaos site: forces a generation mismatch mid-cycle so the
    # degraded path (full rebuild + solve-cache invalidation) stays
    # exercised under the soak harness (doc/CHAOS.md).
    plan = chaos_plan.PLAN
    if plan is not None and plan.fire("incremental.stale_generation"):
        st.invalidate_solve()
        trace.note_degraded(
            "incremental generation stale (injected): full rebuild")
        return fallback("chaos: stale generation (injected)")

    # Layout/config-key validation (mirror of the shipper's full-reship
    # triggers): any mismatch means the persisted rows describe a
    # different tensor layout.
    if tc.axis != st.axis:
        return fallback("tensor-cache axis flushed")
    if (len(tc.sig_list) + len(tc.port_list) + len(tc.sel_list)
            > 4096):  # _MAX_GLOBAL_IDS: the tensorizer will flush tables
        return fallback("global id tables at flush threshold")
    pack = tc.pack
    if pack is None or pack.names != node_names:
        return fallback("node membership changed",
                        dirty_nodes=len(node_names))
    if set(ssn.task_order_fns) - {"priority"}:
        return fallback("non-stock task order")

    node_dirty = _dirty_node_rows(node_names, node_objs, mutated_nodes,
                                  pack)
    n_real = len(node_names)

    dirty_jobs = 0
    dirty_job_objs = []
    for uid, job in ssn.jobs.items():
        if _job_is_dirty(tc, uid, job, mutated_jobs):
            dirty_jobs += 1
            dirty_job_objs.append(job)
    j_total = max(len(ssn.jobs), 1)

    if (len(node_dirty) > _DIRTY_MAX_FRACTION * max(n_real, 1)
            or dirty_jobs > _DIRTY_MAX_FRACTION * j_total):
        return fallback(
            f"dirty fraction above {_DIRTY_MAX_FRACTION:.0%} "
            f"({len(node_dirty)}/{n_real} nodes, "
            f"{dirty_jobs}/{j_total} jobs)",
            dirty_jobs=dirty_jobs, dirty_nodes=len(node_dirty))

    # Axis revalidation by dirty-only scan: the last completed build
    # proved no scalar resource existed anywhere; clean objects are
    # bit-unchanged since, so only dirty ones can introduce one.  A
    # scalar appearing (or a previous axis that already had scalars —
    # removal could shrink it) means the axis must be re-derived from
    # the full scan.
    if st.axis != ("cpu", "memory"):
        return fallback("scalar resources present: axis not provable "
                        "from the dirty set",
                        dirty_jobs=dirty_jobs,
                        dirty_nodes=len(node_dirty))
    for ix, _ep in node_dirty:
        if node_objs[ix].allocatable.scalar_resources:
            return fallback("dirty node introduces a scalar resource",
                            dirty_jobs=dirty_jobs,
                            dirty_nodes=len(node_dirty))
    for job in dirty_job_objs:
        if _scalars_in_job(job):
            return fallback("dirty job introduces a scalar resource",
                            dirty_jobs=dirty_jobs,
                            dirty_nodes=len(node_dirty))

    return SessionPlan(st, "micro", "", axis=st.axis,
                       node_dirty=node_dirty, dirty_jobs=dirty_jobs,
                       dirty_nodes=len(node_dirty), mask_reusable=True)


def patch_sig_mask(plan: SessionPlan, ssn, sig_tuples, node_objs,
                   n_pad: int, w_nodeaff: int):
    """Serve the persistent [S, n_pad] sig_mask/sig_bonus with dirty
    node columns re-evaluated in place, or None when a full rebuild is
    required (sig set changed, shape moved, plan not micro).

    Bit parity: the per-(signature, node) evaluation below is the same
    pure function the profile build memoizes (tensor_snapshot's
    prof_mask/prof_bonus loop), so a patched column equals a rebuilt
    one exactly; clean columns cannot have drifted because every input
    of the function (node labels/taints/conditions/unschedulable,
    allocatable cap, resident count) moves the node's epoch or lands in
    Session.mutated_nodes — both enter ``node_dirty``."""
    import numpy as np

    st = plan.state
    key = tuple(sig_tuples)
    if (not plan.mask_reusable or st.sig_mask is None
            or st.sig_tuples != key
            or st.sig_mask.shape != (len(sig_tuples), n_pad)):
        return None
    if len(plan.node_dirty) * len(sig_tuples) > 4096:
        # The patch path evaluates the predicate chain per (signature,
        # dirty node) with no static-profile dedup; past this budget the
        # profile build (O(S x distinct profiles) evaluations plus one
        # vector scatter) is cheaper than the patch it would replace —
        # mirror of the pack refresh's own full-rebuild cutover.
        return None
    from ..plugins.nodeorder import node_affinity_score
    from .tensor_snapshot import _sig_example, _static_example

    sig_mask = st.sig_mask
    sig_bonus = st.sig_bonus
    examples = st.sig_examples
    for si, sig in enumerate(sig_tuples):
        cached = examples.get(sig)
        if cached is None:
            example = _sig_example(sig)
            stripped = _static_example(example)
            cached = (example, stripped)
            examples[sig] = cached
        example, stripped = cached
        # has_pref derives from the CURRENT conf's w_nodeaff, never the
        # cached tuple: a weight change must not serve zero bonuses for
        # dirty columns after the struct fallback rebuilt the mask.
        affinity = example.pod.spec.affinity
        has_pref = (w_nodeaff and affinity is not None
                    and affinity.preferred_node_terms)
        for ix, _ep in plan.node_dirty:
            node = node_objs[ix]
            bonus = 0
            if has_pref:
                bonus = w_nodeaff * node_affinity_score(example, node)
            sig_bonus[si, ix] = bonus
            ok = True
            try:
                ssn.predicate_fn(stripped, node)
            except Exception:  # lint: allow-swallow(predicate veto: any raise means infeasible, exactly like the profile build treats it)
                ok = False
            sig_mask[si, ix] = ok
    return sig_mask, sig_bonus


def store_sig_mask(plan: Optional[SessionPlan], sig_tuples, sig_mask,
                   sig_bonus) -> None:
    """Persist a freshly built mask for the next session's patch path.
    Only non-empty signature sets persist (the featureless all-True row
    is cheaper to rebuild than to key); an empty set drops any older
    persisted mask so it cannot be served after the signatures return."""
    if plan is None:
        return
    st = plan.state
    if not sig_tuples:
        st.sig_tuples = None
        st.sig_mask = None
        st.sig_bonus = None
        st.sig_examples.clear()
        return
    st.sig_tuples = tuple(sig_tuples)
    st.sig_mask = sig_mask
    st.sig_bonus = sig_bonus
    # Drop example cache entries for signatures that left the session.
    live = set(st.sig_tuples)
    for sig in [s for s in st.sig_examples if s not in live]:
        del st.sig_examples[sig]


# ---------------------------------------------------------------------------
# Per-job aggregate columns (the plugin-layer leg of the wire-to-tensor
# fast path).  The drf open used to recompute every job's dominant share
# (`_calculate_share` — a Python loop over resource names per job), the
# open_session job_valid gate re-validated every job, and the gang close
# re-derived every job's readiness — all O(jobs) Python per cycle.  The
# persistent columns below are patched for DIRTY jobs only (the same
# snap_epoch discipline as the tensor blocks; session-mutated rows are
# stamped always-dirty so the next open re-reads the fresh clone) and the
# three walks become numpy column ops plus an O(affected) Python tail.
# Everything degrades to the sequential control under
# KUBE_BATCH_TPU_WIRE_FAST=0 / KUBE_BATCH_TPU_INCREMENTAL=0.
# ---------------------------------------------------------------------------


class JobAggregates:
    """Persistent per-job columns, scheduling-thread only (the same
    thread model as the rest of this module)."""

    __slots__ = ("index", "uids", "clones", "epochs", "min_avail",
                 "ready", "valid", "alloc", "axis", "shares", "n",
                 "open_session_uid", "close_session_uid")

    def __init__(self):
        import numpy as np
        self.index: Dict[str, int] = {}
        self.uids: List[str] = []
        # Row validity is (epoch, CLONE IDENTITY): a session-only
        # mutation discards the pooled clone without moving truth's
        # mod_epoch, so the next session's fresh clone arrives at the
        # SAME snap_epoch — the identity check is what forces the
        # refill (and re-seeds the per-clone _drf_open_alloc cache the
        # lazy _DrfAttr materialization depends on).  Strong refs; rows
        # are bounded by the compaction rule in job_aggregates_open.
        self.clones: List[object] = []
        self.n = 0
        cap = 64
        self.epochs = np.full((cap,), -1, np.int64)
        self.min_avail = np.zeros((cap,), np.int64)
        self.ready = np.zeros((cap,), np.int64)
        self.valid = np.zeros((cap,), np.int64)
        # DRF open-allocation vectors over ``axis``; float32 so the
        # vectorized share division is the exact np.float32 operand
        # rounding api.resource.share applies (bit parity).
        self.alloc = np.zeros((cap, 2), np.float32)
        self.axis: tuple = ("cpu", "memory")
        self.shares = None
        self.open_session_uid = ""
        self.close_session_uid = ""

    def _grow(self, need: int) -> None:
        import numpy as np
        cap = len(self.epochs)
        if need <= cap:
            return
        new_cap = max(need, cap * 2)
        pad = new_cap - cap
        self.epochs = np.concatenate(
            [self.epochs, np.full((pad,), -1, np.int64)])
        for name in ("min_avail", "ready", "valid"):
            arr = getattr(self, name)
            setattr(self, name,
                    np.concatenate([arr, np.zeros((pad,), np.int64)]))
        self.alloc = np.concatenate(
            [self.alloc,
             np.zeros((pad, self.alloc.shape[1]), np.float32)])


def _drf_alloc_of(job):
    """The job clone's DRF open allocation — the exact walk
    DrfPlugin.on_session_open performs, cached on the clone under the
    same clone-identity validity token (``_drf_open_alloc``), so the
    control arm and the fast path serve byte-identical Resources."""
    from ..api import Resource, allocated_status
    cached = getattr(job, "_drf_open_alloc", None)
    if cached is not None:
        return cached
    acc = Resource.empty()
    for status, tasks in job.task_status_index.items():
        if allocated_status(status):
            for t in tasks.values():
                acc.add(t.resreq)
    try:
        job._drf_open_alloc = acc
    except AttributeError:  # lint: allow-swallow(slotted/foreign clone: the walk simply re-runs next session, which is the control behavior)
        pass
    return acc


def job_fast_enabled(ssn) -> bool:
    return (wire_fast_enabled() and incremental_enabled()
            and state_for(ssn.cache) is not None)


def _fill_job_row(agg: JobAggregates, i: int, job) -> None:
    agg.min_avail[i] = job.min_available
    agg.ready[i] = job.ready_task_num()
    agg.valid[i] = job.valid_task_num()
    res = _drf_alloc_of(job)
    row = agg.alloc[i]
    row[:] = 0.0
    for d, name in enumerate(agg.axis):
        row[d] = res.get(name)


def job_aggregates_open(ssn) -> Optional[JobAggregates]:
    """Build or dirty-patch the persistent per-job columns for this
    session's OPEN state (runs once per session; later callers get the
    cached result).  Returns None on the control arm."""
    if not job_fast_enabled(ssn):
        return None
    st = state_for(ssn.cache)
    agg = st.job_agg
    if agg is not None and len(agg.index) > 2 * max(len(ssn.jobs), 1) + 64:
        agg = None  # compaction: churn left mostly-dead rows behind
    if agg is None:
        agg = st.job_agg = JobAggregates()
    if agg.open_session_uid == ssn.uid:
        return agg
    agg.open_session_uid = ssn.uid
    agg.close_session_uid = ""
    agg._grow(len(agg.index) + len(ssn.jobs))
    mutated = getattr(ssn, "mutated_jobs", set())
    for uid, job in ssn.jobs.items():
        i = agg.index.get(uid)
        ep = (getattr(job, "snap_epoch", None)
              if uid not in mutated else None)
        if i is None:
            i = len(agg.uids)
            agg._grow(i + 1)
            agg.index[uid] = i
            agg.uids.append(uid)
            agg.clones.append(None)
            agg.n = i + 1
        elif ep is not None and agg.epochs[i] == ep \
                and agg.clones[i] is job:
            continue  # clean row: bit-unchanged clone since last fill
        _fill_job_row(agg, i, job)
        agg.epochs[i] = ep if ep is not None else -1
        agg.clones[i] = job
    # job_agg rebinds OUTSIDE the tensorize chokepoint (open-session
    # plugin path: _grow reallocations and the compaction rebuild above)
    # — re-price here, or a session that opens and then dies before any
    # tensorize (chaos faults) leaves the ledger under-counting for the
    # life of this state object.
    st._mem_refresh()
    return agg


def job_aggregates_close(ssn) -> Optional[JobAggregates]:
    """The CLOSE-state view: open columns plus a re-read of every
    session-mutated job's clone.  Mutated rows are stamped always-dirty
    (-1): a session-only mutation (e.g. pipeline) does not move truth's
    mod_epoch, so the next open must not mistake the close-state row for
    the fresh clone's state."""
    agg = job_aggregates_open(ssn)
    if agg is None:
        return None
    if agg.close_session_uid == ssn.uid:
        return agg
    agg.close_session_uid = ssn.uid
    for uid in getattr(ssn, "mutated_jobs", ()):
        i = agg.index.get(uid)
        job = ssn.jobs.get(uid)
        if i is None or job is None:
            continue
        agg.min_avail[i] = job.min_available
        agg.ready[i] = job.ready_task_num()
        agg.valid[i] = job.valid_task_num()
        agg.epochs[i] = -1
        agg.clones[i] = job
    return agg


def drf_open_shares(ssn, total_resource) -> Optional[JobAggregates]:
    """Vectorized DRF dominant shares at session open: one float32
    column division + row max over the persistent allocation matrix,
    bit-identical to the per-job ``_calculate_share`` loop because
    ``api.resource.share`` is DEFINED as the correctly-rounded float32
    division of float32-rounded operands — exactly the elementwise op
    below — and max over exact f32→f64 widenings equals the widened f32
    max.  Returns the aggregates with ``shares``/``index`` populated, or
    None on the control arm."""
    import numpy as np

    agg = job_aggregates_open(ssn)
    if agg is None:
        return None
    axis = ("cpu", "memory",
            *sorted(total_resource.scalar_resources
                    or ()))
    if axis != agg.axis or agg.alloc.shape[1] != len(axis):
        # Resource axis moved (a scalar appeared in/left the cluster
        # total): refill every live row's vector from the cached per-
        # clone Resources — O(jobs) Python, once per axis change.
        agg.axis = axis
        agg.alloc = np.zeros((len(agg.epochs), len(axis)), np.float32)
        for uid, i in agg.index.items():
            job = ssn.jobs.get(uid)
            if job is not None:
                res = _drf_alloc_of(job)
                for d, name in enumerate(axis):
                    agg.alloc[i, d] = res.get(name)
    n = agg.n
    total_vec = np.asarray([total_resource.get(name) for name in axis],
                           np.float32)
    a32 = agg.alloc[:n]
    with np.errstate(divide="ignore", invalid="ignore"):
        q = a32 / total_vec
    zero_t = total_vec == 0
    if zero_t.any():
        # share(l, 0) is 0 for l == 0 and 1 otherwise (helpers.go:47-59).
        q[:, zero_t] = np.where(a32[:, zero_t] != 0,
                                np.float32(1.0), np.float32(0.0))
    if n:
        agg.shares = np.maximum(
            q.max(axis=1), np.float32(0.0)).astype(np.float64)
    else:
        agg.shares = np.zeros((0,), np.float64)
    return agg


def job_valid_pass_uids(ssn) -> Optional[set]:
    """Job uids provably PASSING the open_session job_valid gate, or
    None when the fast path cannot decide (control arm, a non-gang
    validator registered).  Passing jobs are unobservable through the
    gate (no condition, no deletion), so skipping them is bit-parity;
    every other job still runs the real validator chain."""
    if not ssn.job_valid_fns or set(ssn.job_valid_fns) - {"gang"}:
        return None
    agg = job_aggregates_open(ssn)
    if agg is None:
        return None
    import numpy as np
    n = agg.n
    ok = np.nonzero(agg.valid[:n] >= agg.min_avail[:n])[0]
    uids = agg.uids
    return {uids[int(i)] for i in ok}


def gang_close_unready(ssn) -> Optional[list]:
    """The session's not-ready jobs for the gang close pass (ready <
    minAvailable from the close-state columns), or None on the control
    arm.  Ready jobs are skipped without a Python visit; the returned
    jobs run the exact per-job close body.  Cross-job order carries no
    observable interaction (per-job conditions, name-labeled gauges,
    monotonic counters), so aggregate row order is parity-safe."""
    agg = job_aggregates_close(ssn)
    if agg is None:
        return None
    import numpy as np
    n = agg.n
    rows = np.nonzero(agg.ready[:n] < agg.min_avail[:n])[0]
    out = []
    for i in rows:
        job = ssn.jobs.get(agg.uids[int(i)])
        if job is not None:
            out.append(job)
    return out


def finish_tensorize(plan: Optional[SessionPlan], ssn, axis,
                     node_count: int, job_count: int) -> None:
    """Close out a COMPLETED build: update the layout facts the next
    plan validates against, bump the generation, and publish the
    kind/dirty counts to metrics and the flight recorder (the
    /debug/sessions ``incremental`` surface)."""
    if plan is None:
        return
    st = plan.state
    st.build_open = False
    st.axis = tuple(axis)
    st.node_count = node_count
    st.job_count = job_count
    st.generation += 1
    st.last_kind = plan.kind
    st.last_reason = plan.reason
    st.stats[plan.kind] = st.stats.get(plan.kind, 0) + 1
    st._mem_refresh()
    metrics.set_incremental_dirty(plan.dirty_nodes, plan.dirty_jobs)
    # One count per SESSION (the scanner and the allocate action may
    # both tensorize within one cycle; the first build classifies it).
    if not getattr(ssn, "_inc_counted", False):
        try:
            ssn._inc_counted = True
        except AttributeError:
            pass
        metrics.note_incremental_session(plan.kind)
    trace.set_meta(incremental=plan.kind,
                   dirty_nodes=plan.dirty_nodes,
                   dirty_jobs=plan.dirty_jobs,
                   **({"incremental_reason": plan.reason}
                      if plan.reason else {}))
    trace.annotate(incremental=plan.kind, dirty_nodes=plan.dirty_nodes,
                   dirty_jobs=plan.dirty_jobs)
