"""The allocate session solve: types, routing and async dispatch.

Counterpart of kube_batch_tpu/ops/solver.py.  One session solve runs the
reference's allocate loop (allocate.go:43-195): queue pop, job pop, and a
drain of the popped job's tasks, each placement the first index of the
best integer score among feasible nodes.  On a CUDA tensor the solve is
one launch of the hand-written kernel (``ops/cuda_solver.py``); on a CPU
tensor it is that kernel's plain PyTorch version.

``dispatch_solve`` enqueues the solve without blocking; ``fetch_solve``
reads back assignment, kind, order and the placement permutation as one
transfer.  ``fetch_result`` is the blocking readback of the sequential
path (``KUBE_BATCH_TPU_PIPELINE=0``).  A candidate-row solve
(ops/prefilter.py) gathers the prefiltered node rows out of the resident
inputs and runs the same route on them; the fetch scatters the
assignment back to full-space rows.

Observability, as in the reference: the ``solver.dispatch`` span covers
the enqueue and the ``solver.fetch`` span the event wait and the host
read; each solve counts ``kube_batch_solver_route_total{family=
"allocate"}`` under its route, ``cuda`` (the kernel), ``torch`` (its
plain version on the CPU), ``candidates`` (the gathered rows, on either)
or ``sharded`` (the node-sharded mesh, parallel/: K1's shard mode on
CUDA shards, its plain version on CPU shards). The chaos sites
``solve.device_error`` (the dispatch), ``solve.slow`` and
``solve.poison`` (the readback) are one no-op branch each when the chaos
engine is off.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from .. import knobs
from ..chaos import plan as chaos_plan
from .scoring import ScoreWeights


class SolverInputs(NamedTuple):
    """Static per-session tensors (field order is the packed leaf order).

    Resource tensors ([.., R]) are int32 fixed-point quanta
    (ops/resources.py); ts/prio/rank keys, queue_deserved_f and total_res
    are in the float key dtype (float32 or float64)."""
    # tasks (P = padded candidate count)
    task_req: torch.Tensor       # [P, R] i32 launch requirement
    task_res: torch.Tensor       # [P, R] i32 steady requirement
    task_sig: torch.Tensor       # [P] i32 index into sig_mask
    task_sorted: torch.Tensor    # [P] i32 task ids in (job, task-order) order
    task_ports: torch.Tensor     # [P, NP] bool: task uses host-port key
    task_aff_req: torch.Tensor   # [P, NS] bool: requires selector matched
    task_anti: torch.Tensor      # [P, NS] bool: forbids selector matched
    task_match: torch.Tensor     # [P, NS] bool: task's labels match selector
    task_paff_w: torch.Tensor    # [P, NS] i32 preferred-affinity weights
    task_panti_w: torch.Tensor   # [P, NS] i32 preferred-anti weights
    # jobs (J)
    job_start: torch.Tensor      # [J] i32 offset into the task axis
    job_count: torch.Tensor      # [J] i32 number of candidate tasks
    job_queue: torch.Tensor      # [J] i32 queue index
    job_minavail: torch.Tensor   # [J] i32
    job_prio: torch.Tensor       # [J] f PriorityClass value
    job_ts: torch.Tensor         # [J] f creation timestamp
    job_uid_rank: torch.Tensor   # [J] f rank of UID (tie-break)
    job_init_ready: torch.Tensor  # [J] i32 ready_task_num at session open
    job_init_alloc: torch.Tensor  # [J, R] allocated at session open (drf)
    # queues (Q)
    queue_deserved: torch.Tensor  # [Q, R] i32 water-fill (overused compare)
    queue_deserved_f: torch.Tensor  # [Q, R] f unrounded (share denominator)
    queue_init_alloc: torch.Tensor  # [Q, R]
    queue_ts: torch.Tensor       # [Q] f
    queue_uid_rank: torch.Tensor  # [Q] f
    queue_exists: torch.Tensor   # [Q] bool (padding rows False)
    # nodes (N)
    node_idle: torch.Tensor      # [N, R]
    node_releasing: torch.Tensor  # [N, R]
    node_used: torch.Tensor      # [N, R]
    node_alloc: torch.Tensor     # [N, R] allocatable (scoring denominator)
    node_count: torch.Tensor     # [N] i32 resident task count
    node_max_tasks: torch.Tensor  # [N] i32 pod-count cap
    node_exists: torch.Tensor    # [N] bool (padding rows False)
    node_ports: torch.Tensor     # [N, NP] bool: host-port key in use
    node_selcnt: torch.Tensor    # [N, NS] i32: resident tasks matching sel
    sig_mask: torch.Tensor       # [S, N] bool static predicate mask
    sig_bonus: torch.Tensor      # [S, N] i32 static score bonus
    # cluster
    total_res: torch.Tensor      # [R] f sum of allocatable (drf denominator)
    eps: torch.Tensor            # [R] epsilon vector
    scalar_dims: torch.Tensor    # [R] bool
    score_shift: torch.Tensor    # [2] i32 grid shifts for cpu/mem scoring
    node_coords: torch.Tensor    # [N, 8] i32 topology (inert to the solve)


class SolverConfig(NamedTuple):
    """Plugin and tier structure of the loaded conf.  The key orders list
    the order-contributing plugins in tier order, so the lexicographic
    keys reproduce the conf's tiered chain.  Every field reaches the
    kernel as a launch argument."""
    job_key_order: tuple = ("priority", "gang", "drf")
    queue_key_order: tuple = ("proportion",)
    has_gang: bool = True          # gang registers JobReady
    has_proportion: bool = True    # proportion registers Overused
    has_ports: bool = False        # any candidate uses host ports
    has_pod_affinity: bool = False  # any candidate uses pod (anti-)affinity
    has_pod_affinity_score: bool = False  # preferred pod-affinity scoring
    weights: ScoreWeights = ScoreWeights()


class SolveResult(NamedTuple):
    assignment: torch.Tensor  # [P] i32 node index or -1
    kind: torch.Tensor        # [P] i32 0=none 1=allocate 2=pipeline
    order: torch.Tensor       # [P] i32 placement sequence number
    step: torch.Tensor        # scalar i32 total placements

    # A K1 launch's result carries its ops/cuda_solver.K1Timing here
    # (``TimedResult``); every other result reads None.
    timing = None


_INT32_MAX = 2 ** 31 - 1


def _pack_result_ordered(assignment, kind, order) -> torch.Tensor:
    """[4, P] packed readback with the placement permutation computed on
    the device: row 3 sorts task ids by placement step (unplaced rows
    pushed to the tail by an int32-max key).  Placed steps are unique and
    the sort is stable, so it equals the host's stable argsort."""
    key = torch.where(kind > 0, order, _INT32_MAX)
    perm = torch.argsort(key, stable=True).to(torch.int32)
    return torch.stack([assignment, kind, order, perm])


class PendingSolve(NamedTuple):
    """A dispatched solve that has not been fetched.  On the card,
    ``packed`` is a pinned host tensor that a non-blocking copy fills and
    ``ready`` is the CUDA event recorded after that copy.  On the CPU the
    solve ran synchronously and ``ready`` is None.  ``remap`` (numpy [C]
    int32, candidate-row solves only) maps each gathered row back to its
    full-space node row.  ``timing`` is the K1 launch's K1Timing, which
    the fetch records as a ``k1.device`` span.  Every dispatched handle
    ends in exactly one ``fetch_solve`` or ``discard_solve``."""
    packed: torch.Tensor       # [4, P] i32: assignment/kind/order/perm
    ready: object = None       # torch.cuda.Event, or None on the CPU
    remap: object = None       # np [C] int32, or None for a full solve
    timing: object = None      # ops/cuda_solver.K1Timing, or None


# In-flight dispatch ledger (process-wide): dispatched-but-not-consumed
# PendingSolve handles.
_inflight_lock = threading.Lock()
_inflight = 0  # guarded-by: _inflight_lock


def _note_dispatch(delta: int) -> None:
    global _inflight
    from ..metrics import metrics
    with _inflight_lock:
        _inflight = max(0, _inflight + delta)
        metrics.set_solver_inflight(_inflight)


def solver_inflight() -> int:
    """Outstanding dispatch handles."""
    with _inflight_lock:
        return _inflight


def discard_solve(pending: PendingSolve) -> None:
    """Abandon a dispatched solve without reading it back.  The resident
    input image stays a valid delta baseline: the ship that fed this
    dispatch completed.  It only drops the handle, K1's timing with it
    (no ``k1.device`` span), and calls nothing on the device."""
    if pending is not None:
        _note_dispatch(-1)


def _lex_argmin(mask: torch.Tensor, keys, key_dtype: torch.dtype
                ) -> torch.Tensor:
    """Index of the masked lexicographic minimum as an int32 0-d tensor,
    with no host read.  A floating key compares in its own dtype (the
    reference's ``jnp.where(mask, k, inf)`` keeps it); any other key is
    promoted to ``key_dtype``, the staged float key type, where JAX
    promotes to its default float (float64 under x64, float32 without)
    and torch would pick float32 in both.  An all-false mask gives 0, as
    ``jnp.argmax`` does."""
    for k in keys:
        if not k.is_floating_point():
            k = k.to(key_dtype)
        kv = torch.where(mask, k, torch.full_like(k, float("inf")))
        mask = mask & (kv == kv.min())
    return torch.argmax(mask.to(torch.int32)).to(torch.int32)


def dynamic_predicate_mask(cfg: SolverConfig, t, task_ports, task_aff_req,
                           task_anti, ports, selcnt):
    """[N] bool: host-port conflicts (predicates.go:174) and required
    inter-pod (anti-)affinity at hostname topology (predicates.go:249-262)
    for task ``t`` (an index tensor, read on the device) against the
    occupancy state ``ports`` / ``selcnt``.  None when neither feature is
    active."""
    ok = None
    t = t.long()
    if cfg.has_ports:
        conflict = (task_ports[t][None, :] & ports).any(dim=-1)
        ok = ~conflict
    if cfg.has_pod_affinity:
        have = selcnt > 0
        aff_ok = torch.all(~task_aff_req[t][None, :] | have, dim=-1)
        anti_ok = torch.all(~task_anti[t][None, :] | ~have, dim=-1)
        both = aff_ok & anti_ok
        ok = both if ok is None else (ok & both)
    return ok


def _gather_candidate_inputs(inp: SolverInputs, idx: torch.Tensor,
                             valid: torch.Tensor) -> SolverInputs:
    """Rebucket the node axis to the candidate rows (ascending full-space
    order, so first-max tie-breaks survive the gather): node-major leaves
    take rows of the resident inputs, [S, N] leaves take columns, on the
    device that holds them, and padding rows are masked out through
    node_exists (their data repeats the last real candidate, so
    downstream math stays well-defined).  ``index_select`` allocates, so
    every gathered leaf is a copy: a later delta ship that rewrites the
    resident buffer in place cannot change a pending gathered solve.
    Everything replicated (tasks/jobs/queues/cluster, including
    total_res and score_shift — the DRF denominator and score grid stay
    full-cluster) passes through untouched.  ``node_coords`` stays
    [N, 8], as in the reference: the solve never reads it
    (ops/cuda_solver.build_buffers takes no topology row)."""
    def take(a):
        return torch.index_select(a, 0, idx)

    return inp._replace(
        node_idle=take(inp.node_idle),
        node_releasing=take(inp.node_releasing),
        node_used=take(inp.node_used),
        node_alloc=take(inp.node_alloc),
        node_count=take(inp.node_count),
        node_max_tasks=take(inp.node_max_tasks),
        node_exists=take(inp.node_exists) & valid,
        node_ports=take(inp.node_ports),
        node_selcnt=take(inp.node_selcnt),
        sig_mask=torch.index_select(inp.sig_mask, 1, idx),
        sig_bonus=torch.index_select(inp.sig_bonus, 1, idx))


def _solve_candidates(inp: SolverInputs, cfg: SolverConfig,
                      candidates) -> SolveResult:
    """The candidate-row program: gather [C] rows out of the resident
    inputs and run the session solve on them, on the route
    ``choose_solver_mesh`` picks for the gathered inputs (the kernel on
    the card, its plain version on the CPU).  Placement-identical to the
    full program by the prefilter's exactness argument (ops/prefilter.py;
    tests/test_torch_prefilter.py holds it).  Counted under the route
    ``candidates``."""
    # Same chaos chokepoint as best_solve_allocate: the candidate path is
    # still a device dispatch and must feed the breaker under injection.
    _chaos_dispatch()
    from ..metrics import metrics
    from ..trace import spans as trace
    from .compile_cache import note_solve
    choice, mesh = choose_solver_mesh(inp)
    if choice == "sharded":
        # Each shard gathers its own rows of its resident slice
        # (candidates.local_idx), so no node row leaves its shard, and
        # the sharded solve runs on the gathered slices.
        from ..parallel.sharded_solver import (gather_candidate_sharded,
                                               solve_allocate_sharded)
        sub = gather_candidate_sharded(inp, candidates.local_idx,
                                       candidates.local_valid, mesh)
        metrics.note_route("allocate", "sharded")
        trace.annotate(route="sharded", mesh_devices=mesh.size,
                       candidate_rows=candidates.count)
        note_solve("sharded", sub, cfg)
        return solve_allocate_sharded(sub, cfg, mesh)
    metrics.note_route("allocate", "candidates")
    trace.annotate(route="candidates", mesh_devices=1,
                   candidate_rows=candidates.count)
    dev = inp.node_idle.device
    # The index and valid rows go to the device once per session.
    idx = torch.as_tensor(candidates.idx, dtype=torch.long, device=dev)
    valid = torch.as_tensor(candidates.valid, device=dev)
    sub = _gather_candidate_inputs(inp, idx, valid)
    # Keyed under the solver that runs on the gathered rows, as the
    # reference keys its gathered solve under "xla".
    note_solve(choose_solver_mesh(sub)[0], sub, cfg)
    return solve_on_route(sub, cfg)


def to_host_async(*tensors, out=None):
    """(host tensors, event): on the card a non-blocking copy of each
    tensor into pinned host memory (``out``, when given, else allocated
    here), enqueued on the current stream, and one event recorded after
    them (wait on the event, not the stream, so later work on the stream
    is not waited for); on the CPU the tensors themselves and None.  A
    pinned allocation can synchronize the device, so a caller that must
    not wait for work already queued allocates ``out`` before it queues
    that work (``packed_host``)."""
    if not tensors[0].is_cuda:
        return list(tensors), None
    hosts = list(out) if out is not None else [
        torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        for t in tensors]
    for host, t in zip(hosts, tensors):
        host.copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(tensors[0].device))
    return hosts, ready


def packed_host(inp: SolverInputs):
    """The pinned [4, P] int32 buffer of a solve's packed readback on
    the card, allocated before the launch (see to_host_async); None on
    the CPU."""
    if not inp.node_idle.is_cuda:
        return None
    return torch.empty((4, inp.task_req.shape[0]), dtype=torch.int32,
                       pin_memory=True)


def pending_of(result: SolveResult, remap=None, host=None) -> PendingSolve:
    """Pack ``result`` and enqueue its readback (into ``host`` when
    given) as a PendingSolve: one handle in the in-flight ledger."""
    (packed,), ready = to_host_async(
        _pack_result_ordered(result.assignment, result.kind, result.order),
        out=None if host is None else (host,))
    _note_dispatch(+1)
    return PendingSolve(packed, ready, remap, result.timing)


def dispatch_solve(inp: SolverInputs, cfg: SolverConfig,
                   candidates=None) -> PendingSolve:
    """Route and dispatch the solve without blocking on its result.  On
    the card the kernel, the packing and a non-blocking copy into pinned
    host memory are enqueued on the current stream, followed by an event
    recorded there (a shard session's current stream is its view's own,
    scheduler.py); on the CPU everything runs synchronously.  ``candidates``
    (ops/prefilter.CandidateSet) narrows the node axis to the
    prefiltered rows; the fetch remaps the result to full space.  Counts
    one ``solve`` session dispatch, as the reference does."""
    from ..metrics import metrics
    from ..trace import spans as trace
    with trace.span("solver.dispatch"):
        host = packed_host(inp)
        if candidates is not None:
            result = _solve_candidates(inp, cfg, candidates)
            remap = candidates.remap
        else:
            result = best_solve_allocate(inp, cfg)
            remap = None
        pending = pending_of(result, remap, host)
    metrics.note_session_dispatch("solve")
    return pending


def _chaos_dispatch() -> None:
    """The device dispatch fault site (doc/CHAOS.md
    ``solve.device_error``): one no-op branch when chaos is off."""
    plan = chaos_plan.PLAN
    if plan is not None and plan.fire("solve.device_error"):
        raise RuntimeError("chaos: device solve dispatch failed (injected)")


def _chaos_fetch(packed: np.ndarray) -> np.ndarray:
    """Readback fault sites (doc/CHAOS.md): a slow device (``solve.slow``
    sleeps before the readback is consumed) and a poisoned readback
    (``solve.poison`` truncates a column, the shape every consumer must
    validate before applying).  Poison returns a truncated slice and
    never writes into ``packed``, which may be a solve's pinned buffer.
    One no-op branch when chaos is off."""
    plan = chaos_plan.PLAN
    if plan is None:
        return packed
    slow = plan.fire("solve.slow")
    if slow is not None:
        import time
        time.sleep(0.01 + 0.05 * slow.magnitude)
    if plan.fire("solve.poison") and packed.shape[-1]:
        return packed[:, :-1]
    return packed


def _check_not_aborted(kind: np.ndarray) -> None:
    """K1's shard mode writes kind -1 for every task when a shard gave up
    on the cross-shard exchange (ops/cuda_solver.py SPIN_MS): raise
    ``DeviceFailure`` rather than read a half-solved session."""
    if kind.size and int(kind.min()) < 0:
        from ..chaos.breaker import DeviceFailure
        raise DeviceFailure("the sharded solve gave up: a shard's "
                            "cross-shard exchange timed out or aborted")


def fetch_solve(pending: PendingSolve):
    """Wait for a dispatched solve and read it back.

    Returns numpy (assignment, kind, order, ordered) where ``ordered`` is
    the placed task ids in placement order: the device-computed
    equivalent of ``placed[np.argsort(order[placed], kind="stable")]``.
    A candidate-row solve's assignment column is scattered back to
    full-space node rows here (unplaced rows keep -1), so consumers never
    see program-local indices; ``perm`` indexes tasks, not nodes, and
    passes through unchanged."""
    from ..trace import spans as trace
    try:
        with trace.span("solver.fetch"):
            if pending.ready is not None:
                pending.ready.synchronize()
            if pending.timing is not None:
                pending.timing.record()
            packed = pending.packed.numpy()
    finally:
        # Consumed either way: a fetch that raises still retires the
        # handle from the in-flight ledger.
        _note_dispatch(-1)
    packed = _chaos_fetch(packed)
    assignment, kind, order, perm = packed
    _check_not_aborted(kind)
    if pending.remap is not None:
        # A placement outside the gathered program's C rows is a
        # malformed result: raise, where the reference clips (the action
        # validates the remapped rows against N in turn).
        remap = pending.remap
        placed = kind > 0
        local = assignment[placed]
        if local.size and (int(local.min()) < 0
                           or int(local.max()) >= len(remap)):
            raise RuntimeError(
                f"malformed candidate solve result: node row outside the "
                f"{len(remap)} gathered rows")
        assignment = assignment.copy()
        assignment[placed] = remap[local]
    n_placed = int(np.count_nonzero(kind > 0))
    return assignment, kind, order, perm[:n_placed]


def fetch_result(result: SolveResult):
    """Blocking readback of (assignment, kind, order) as one transfer:
    the sequential (``KUBE_BATCH_TPU_PIPELINE=0``) counterpart of
    ``dispatch_solve`` -> ``fetch_solve``.  ``torch.stack`` allocates, so
    the numpy rows never alias the solver's tensors."""
    from ..trace import spans as trace
    with trace.span("solver.fetch"):
        packed = torch.stack([result.assignment, result.kind,
                              result.order]).cpu().numpy()
        if result.timing is not None:
            result.timing.record()
    packed = _chaos_fetch(packed)
    _check_not_aborted(packed[1])
    return packed[0], packed[1], packed[2]


# When to shard the solve over the mesh: the reference's gates and
# defaults, 16,384 nodes and 256 MiB of node-major state, which it derived
# from its own sharded solve on another device; they are unmeasured for
# K1's shard mode on the H100.  FORCE_SHARD for the tests and drills.
SHARD_NODES_ENV = knobs.SHARD_NODES.env
SHARD_BYTES_ENV = knobs.SHARD_BYTES.env
FORCE_SHARD_ENV = knobs.FORCE_SHARD.env
DEFAULT_SHARD_NODES = knobs.SHARD_NODES.default
DEFAULT_SHARD_BYTES = knobs.SHARD_BYTES.default


def _node_state_bytes(inp: SolverInputs) -> int:
    """Approximate node-major working set: the only state that scales with
    the cluster's node count (everything else is replicated)."""
    n = inp.node_idle.shape[0]
    r = inp.node_idle.shape[1]
    per_node = (4 * r * 4                       # idle/releasing/used/alloc
                + inp.sig_mask.shape[0]          # static mask rows (bool)
                + inp.task_ports.shape[1]        # port occupancy (bool)
                + 4 * inp.task_aff_req.shape[1]  # selector counts (i32)
                + 16)                            # count/cap/exists/cs rows
    return n * per_node


class ShardKnobs(NamedTuple):
    """The routing gates, resolved from the environment once:
    ``choose_solver_mesh`` sits on every solve and every ship, and the
    eviction and topology gates read the same knobs.  A malformed value
    warns once (knobs.py) and pins the default."""
    nodes: int = DEFAULT_SHARD_NODES
    bytes: int = DEFAULT_SHARD_BYTES
    force: bool = False


_SHARD_KNOBS = None  # resolved lazily once; refresh_shard_knobs re-reads


def _resolve_shard_knobs() -> ShardKnobs:
    return ShardKnobs(
        nodes=knobs.SHARD_NODES.value(),
        bytes=knobs.SHARD_BYTES.value(),
        force=knobs.FORCE_SHARD.enabled())


def shard_knobs() -> ShardKnobs:
    """The pinned routing knobs (resolved at first use, startup-stable)."""
    global _SHARD_KNOBS
    if _SHARD_KNOBS is None:
        _SHARD_KNOBS = _resolve_shard_knobs()
    return _SHARD_KNOBS


def refresh_shard_knobs() -> ShardKnobs:
    """Re-resolve the knobs from the current environment: the test and
    drill hook.  The scheduler loop never calls it: routing stays pinned
    from startup."""
    global _SHARD_KNOBS
    _SHARD_KNOBS = None
    return shard_knobs()


def choose_solver_mesh(inp: SolverInputs):
    """('sharded'|'cuda'|'torch', mesh): the one routing chokepoint.  The
    mesh route needs a mesh (parallel.mesh.default_mesh), a node bucket
    that divides into its shards, and the node count at SHARD_NODES, the
    node-major bytes above SHARD_BYTES, or FORCE_SHARD; the mesh returned
    is the one it validated.  Else the hand-written kernel for CUDA
    tensors and its plain PyTorch version for CPU tensors.  The resident
    shipper routes its layout through the same gate, so the bytes land
    sharded where the solve reads them."""
    from ..parallel.mesh import default_mesh
    mesh = default_mesh()
    n = inp.node_idle.shape[0]
    if mesh is not None and n % mesh.size == 0:
        gate = shard_knobs()
        if gate.force or n >= gate.nodes \
                or _node_state_bytes(inp) > gate.bytes:
            return "sharded", mesh
    if getattr(inp.node_idle, "is_cuda", False):
        return "cuda", None
    return "torch", None


def choose_solver(inp: SolverInputs) -> str:
    return choose_solver_mesh(inp)[0]


def best_solve_allocate(inp: SolverInputs, cfg: SolverConfig) -> SolveResult:
    """The session solve on the route ``choose_solver_mesh`` picks, behind
    the ``solve.device_error`` chaos site and counted under its route.
    Both routes are placement-identical (tests and chip_smoke.py hold
    the kernel against the plain version)."""
    _chaos_dispatch()
    choice, mesh = choose_solver_mesh(inp)
    from ..metrics import metrics
    from ..trace import spans as trace
    metrics.note_route("allocate", choice)
    trace.annotate(route=choice, mesh_devices=mesh.size if mesh else 1)
    from .compile_cache import note_solve
    note_solve(choice, inp, cfg)  # compile-cache hit/miss observability
    return solve_on_route(inp, cfg)


def solve_on_route(inp: SolverInputs, cfg: SolverConfig) -> SolveResult:
    """The route ``choose_solver_mesh`` picks, without the chaos site and
    the route count (the fused program's allocate leg counts its own
    ``fused`` route, as the reference's does): the sharded solve on the
    mesh, else the kernel for CUDA tensors and its plain version for CPU
    tensors.  Inputs sharded over the mesh gate's mesh stay so; sharded
    inputs the gate no longer shards (a knob refreshed in between) are
    gathered onto one device."""
    from .cuda_solver import solve_allocate_cuda, solve_allocate_plain
    choice, mesh = choose_solver_mesh(inp)
    if choice == "sharded":
        from ..parallel.sharded_solver import solve_allocate_sharded
        return solve_allocate_sharded(inp, cfg, mesh)
    from ..parallel.mesh import gathered
    inp = gathered(inp)
    if choice == "cuda":
        return solve_allocate_cuda(inp, cfg)[0]
    return solve_allocate_plain(inp, cfg)[0]
