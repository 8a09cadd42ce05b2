"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. device: the card's name and power limit; exits non-zero without CUDA;
     daemon: kube_batch_tpu_torch.cli.main, run as ``python -m`` runs
     it, booted three times against a north-star cluster-state file
     (cold with --warmup-buckets, whose boot builds K1 into
     build/torch_kernels on a fresh checkout; warm, which must load it
     without nvcc; a control without warmup), read over HTTP; every pod
     must land where an in-process cycle of the plain route on the CPU
     puts it (see daemon_phase);
     daemon-edge: the port's API server (python -m
     kube_batch_tpu_torch.edge.server) in its own process holds the same
     file, and the daemon booted with --master at it lists, watches,
     schedules and binds over HTTP; read from the server's store, every
     pod must be on the in-process cycle's node and every pod group in
     its phase (see daemon_edge_phase);
     edge-federation: two replicas with --replica-federation over one
     API server at the drill shape: shards split, mirrors scoped to
     their own shards, every pod bound once, both launch K1 (see
     edge_federation_phase);
  2. build: loads the library the daemon built (nvcc must not run again:
     csrc/solve_session.cu is compiled in units at once, then linked) and
     prints the seconds;
     native: the C host walk (native/fastpath.c, built with cc at import)
     must have loaded unless KUBE_BATCH_TPU_NO_NATIVE is set;
  3. kernel against plain: the session-solve kernel must equal its plain
     PyTorch version (run on a CPU copy of the inputs, in three worker
     processes while this one launches the kernel and drives the main
     path and the phases after it; compared before the kernels line:
     HostPlains) exactly
     (assignment, kind, order, step and the final
     node, job and queue buffers) on the test matrix and on cases that
     launch it as clusters of every size its plan takes, in float32 and
     float64; each line names the cluster size and shared memory;
  4. main path at the north-star shape (50k pods x 10k nodes x 2k jobs x
     4 queues, float32): full, delta and clean ships through the resident
     shipper, each followed by dispatch_solve -> fetch_solve on the cuda
     route with the kernel's launch count reset just before and read just
     after; the result is validated, compared once with the plain version
     (on the card, on the full ship's inputs, in a process of its own
     that runs beside daemon-edge and edge-federation: north_star_plain),
     and timed (7 warm dispatch -> fetch rounds, and the
     kernel alone with CUDA events); one more launch with the kernel's
     phase stamps on prints the phase split (`kernel-phases`: cluster
     size, shared memory, microseconds per phase, per placement, per
     pop); the same inputs with the cluster bound forced to 8 must equal
     the plain version too;
 4b. mesh: the node-sharded mesh on 4 shards of the card, K1's shard
     mode (its own library, built in a thread beside daemon-edge, where
     the host's cores are mostly idle; built beside the main path's
     plain version on the card in this process, it slowed that
     host-bound loop) held against single-device K1 and its plain
     version (see mesh_phase);
  5. session, the slice's main path at the north star, in two arms: the
     C host walk (the default) and the KUBE_BATCH_TPU_NO_NATIVE=1 control
     (native_arm), taking turns.  Per arm, make_synthetic_cache through
     the SchedulerCache's ingestion, then one cold and two warm sessions of
     open_session -> TpuAllocateAction(cuda, float32) -> close_session,
     bound pods echoed back between them; each session must take the cuda
     route without the host fallback, launch the kernel once, bind
     exactly the kernel's placements (read off a direct launch on its
     shipped inputs), leave no node over its allocatable and no gang job
     below its minAvailable; prints the stage split (median, p90), the
     wall time and the kernel's share.  The arms must bind the same pods
     in the same order and write the same pod-group statuses.  Then one
     more warm session per arm under cProfile, outside the timed ones
     (apply-profile: the functions of largest own time under
     Session.batch_apply_solved and under tensorize_session);
     warmup: SolverWarmup in process on the session phase's cache; the
     next session must be a compile-cache hit, every launch held;
  6. session-vs-cpu: one 5k x 1k session on the card and on the CPU (the
     plain route) must give the same binds in the same order and the
     same pod-group statuses;
  7. steady and steady-hetero: the steady state at 1% churn per round,
     default arm against KUBE_BATCH_TPU_INCREMENTAL=0 (see steady_phase);
  8. evict: the eviction engine at the north star — the shipped
     four-action conf (reclaim, tpu-allocate, backfill, preempt) on
     make_churn_cache(50k, 10k, 2k, 4), one warm cycle per
     KUBE_BATCH_TPU_BATCH_EVICT arm then off/on on fresh caches;
     prints per-action medians and p90s per arm, the evictions and their
     split by action, the scanner's stats, the trace spans and the
     session kernel's launches; both arms must evict the same victims in
     the same order with the same binds, each batched session must make
     one batched dispatch on the card, each session one kernel launch,
     and the tasks that stay on a node must fit its allocatable; the
     batched eviction solve is replayed on the session's staged inputs
     on the card and on the CPU and must be equal (max abs err 0);
  9. evict-vs-cpu: the four-action session at 5k x 1k on the card and on
     the CPU, both arms: the same victims, victim order, binds and
     events;
 10. topo: topology-aware slice placement at the box scan's node ceiling
     (see topo_phase), then topo-vs-cpu at 4x4x2;
 11. tenancy-streams: two owners' resident shippers, each owner with its
     own CUDA stream, at the north-star shape: each solo launch equals
     the plain version, the second owner's ship and dispatch must return
     while the first's kernel is still pending, and both results must
     equal their solo launches (see tenancy_streams_phase);
 12. tenancy: bench.py's concurrent-shard storm through a real Scheduler
     and TenancyEngine at 10,000 nodes, KUBE_BATCH_TPU_CONCURRENT_SHARDS
     off and on: equal binds, events and lineage, a pipeline that
     overlapped, every shard's launches on its own view's stream, no
     shard failure and no host fallback, every launch held against the
     plain version (see tenancy_phase); then tenancy-backlog, the
     concurrent arm with one tenant's backlog at 10,000 and 30,000
     pods against 4-pod neighbours: whether the next shard's
     begin half returns while that solve is still on the card
     (tenancy_backlog_phase);
 13. scheduler-loop: Scheduler(cache).run() on the card at 5k x 1k: the
     loop thread's first cycle binds, a churned pod wakes and binds,
     stop() within 5 s, each launch held against the plain version (see
     scheduler_loop_phase);
 14. the fused one-dispatch program (ops/fused_solver.py) against its
     controls, the conf's ladder stamped on each session: fused-quiet,
     fused-storm, fused-served, fused-topo and fused-steady (see their
     functions); the evict and topo phases above pin
     KUBE_BATCH_TPU_FUSED=0;
 15. the device half's failure path, drills that inject their own
     faults and must show exactly those: degrade-deadline (the solve
     deadline at the north star), profile (one north-star session under
     KUBE_BATCH_TPU_PROFILE: the torch.profiler trace, K1's device time,
     the device's busy time and idle share), degrade-solve (the breaker
     cycle at DRILL_SHAPE and a poisoned readback), degrade-evict,
     degrade-topo, degrade-fused, degrade-shard, degrade-mesh (K1's shard
     mode with a shard launched late, in a session and from two threads
     at once: mesh_drills) and tensorize-limit (a
     session past the tensorizer's 64 host-port keys: the host path on
     the card as on the CPU, counted; see their functions).  On the card a device failure raises DeviceFailure
     after the breaker is fed and never runs the host path
     (chaos/breaker.py), so the drills check that the failed session
     raised with nothing mutated, and that the next healthy session
     binds as its control; the fused dispatch's failure re-dispatches
     each family on the card;
 16. the verification harnesses (kube_batch_tpu_torch/tools/), in a
     process of their own (``python3 chip_smoke.py tools``) that runs
     beside the phases from warmup to topo-vs-cpu: scenarios (scenario_gen's sweep, one seed per kind, both
     arms on the card and equal, the breaker never tripped, the replay
     round trip bit-identical; scenarios-vs-cpu: the batched arm on the
     card equal to the CPU's), chaos-soak (chaos_soak at chaos-smoke's
     shape, its seeds swept in order until every required site fired,
     in process and over the edge, and an oracle + chaos pair at 2,000
     nodes: no loop death or double bind, convergence to the oracle or
     a divergence the fault-free scheduler reaches from the state the
     faults left, no host path run on the card, the breaker's trips,
     probes and waits; the overhead A/B; the plan off and the breaker
     closed after it) and replica-soak (replica_soak
     at soak-replicas' shape: every invariant, the steal time against
     the lease, the key ledger's hits and misses around the kill); every
     K1 launch held against the plain version (see their functions).
Every phase before the drills runs inside ``guarded``: the device
failure counter (every stage), the solve-deadline counter, the
tensorizer-limit counter and the breaker are read before and after it,
and a phase that moved any of them or left the breaker open fails the
script (a ``no-fallback`` line each).
The functions' defaults are the depth the script runs, cut below the
protocols' earlier depth to keep the script inside its time limit, never
narrower: 2 tenancy rounds per arm (was 4) in two arms, off and on
(was off/on/on/off), the 10,000 and 30,000 backlogs (2,500 dropped), 2
fused-quiet sessions per arm (was 4, then 3), 2 fused-storm cycles (was
3), 4 fused-steady rounds (was 6), 3 sessions per arm in the session
phase (was 4, one cold and two warm; cut when the main path's plain
version went back on the card) and 2 timed evict cycles, off and on
(was off/on/on/off); the last cuts of fused-quiet, the tenancy arms
and the evict cycles paid for the harness phases.
From the mesh phase on, every hold of a solve that placed a task
(DeferredHolds; the north star's take 45-55 s on the host) runs in one
of two worker processes while the script goes on, and is checked before
the kernels line (``deferred-holds``).  The two child processes (Child)
put the main path's plain version and the harnesses beside phases that
leave cores idle and gate on no time; a child that fails, or runs over,
fails the script.
Every launch held against the plain version goes through LaunchLedger:
where its inputs are byte-equal to a solve already held in this run
(tenancy-streams' seed-0 solo and the main path's full ship, the arms of
a phase that stage the same session), the outputs are compared byte for
byte instead; the kernel table counts both.  ``python3 chip_smoke.py
fused`` runs the build and the five fused phases alone; ``python3
chip_smoke.py daemon`` runs daemon, daemon-edge, edge-federation, the
build, a 2-session session phase, warmup and tensorize-limit alone;
``python3 chip_smoke.py tools`` the build and the three harness phases;
``python3 chip_smoke.py north-star-plain OUT`` the main path's plain
version alone, saved to OUT.
Each phase line carries ``t_s``, the seconds since the script started.
The kernel-vs-plain matrix includes the shapes the kernel once refused:
2,500 queues in float64 (the queue piece in global memory) and 10 and 20
resource dims.
The last two lines are the kernel table as JSON and
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero
before those lines.  Imports nothing of JAX and nothing of kube_batch_tpu.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# The H100 SXM's published peaks (NVIDIA data sheet): HBM bandwidth, and
# the non-tensor float32 rate, used here for the kernel's int32/float
# lane operations.
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 67e12
# Lane operations to test and score one node for one placement, counted
# from the kernel's node scan at R=2 without ports or affinity: epsilon
# fits 28, predicates 7, grid score 34, selection 5.  Only the scans that
# place a task are counted (this run's data needs at least those).
OPS_PER_NODE_SCAN = 74
NORTH_STAR = (50_000, 10_000, 2_000, 4)
# The breaker drill's shape (degrade_solve_phase): small enough that its
# host control, the host allocate action, which runs Python predicates
# for each task over every node, ends in seconds (timed on the CPU).
DRILL_SHAPE = (2_000, 200, 80, 4)
# Caches and results of earlier phases that a later one reuses (the
# drills run on the session, evict, topo and fused-quiet cells).
KEPT = {}


_STARTED = time.perf_counter()


def phase(name: str, **fields) -> None:
    """One phase line; ``t_s`` is the seconds since the script started."""
    print(json.dumps({"phase": name, **fields,
                      "t_s": time.perf_counter() - _STARTED}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def wait_device(what: str, seconds: float = 120.0) -> None:
    """Wait for the card's queued work, at most ``seconds``; a kernel that
    has not finished by then is taken as hung, and the process leaves at
    once (its CUDA context, and the kernel with it, goes too)."""
    done = torch.cuda.Event()
    done.record()
    deadline = time.monotonic() + seconds
    while not done.query():
        if time.monotonic() > deadline:
            print(f"chip_smoke: {what} did not finish in {seconds} s",
                  file=sys.stderr, flush=True)
            Child.stop_live()
            os._exit(3)
        time.sleep(0.001)


def compare(kernel_out, plain_out) -> int:
    """Max absolute difference over result and final buffers; raises on
    any shape or dtype difference."""
    (kr, kf), (pr, pf) = kernel_out, plain_out
    worst = 0
    pairs = [(getattr(kr, f), getattr(pr, f))
             for f in ("assignment", "kind", "order", "step")]
    pairs += list(zip(kf, pf))
    for a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype mismatch {a.shape} {a.dtype} "
                                 f"vs {b.shape} {b.dtype}")
        worst = max(worst, int((a.cpu().long() - b.cpu().long()).abs().max()))
    return worst


def plain_on_host(job):
    """One kernel-vs-plain case's plain version on the host's CPU, in a
    worker process (HostPlains): numpy leaves in, numpy out."""
    kind, leaves, cfg = job
    from kube_batch_tpu_torch.ops import cuda_solver
    torch.set_num_threads(1)
    res, final = cuda_solver.solve_allocate_plain(
        kind(*(torch.from_numpy(a) for a in leaves)), cfg)
    return (tuple(t.numpy() for t in res), tuple(t.numpy() for t in final))


class HostPlains:
    """The plain version of each case of ``cases`` ([(inputs, cfg)]) on
    the host's CPU, in ``workers`` processes of their own, so that it
    runs while this process drives the card; ``results()`` waits for
    them and stops the workers.  Each result is (SolveResult,
    FinalState) of CPU tensors, as solve_allocate_plain returns."""

    def __init__(self, cases, workers: int = 3):
        import multiprocessing
        jobs = [(type(inp), tuple(t.cpu().numpy() for t in inp), cfg)
                for inp, cfg in cases]
        self._pool = multiprocessing.get_context("spawn").Pool(workers)
        self._pending = self._pool.map_async(plain_on_host, jobs,
                                             chunksize=1)

    def results(self, seconds: float = 900.0) -> list:
        from kube_batch_tpu_torch.ops.cuda_solver import FinalState
        from kube_batch_tpu_torch.ops.solver import SolveResult
        try:
            out = self._pending.get(seconds)
        finally:
            self._pool.terminate()
            self._pool.join()
        return [(SolveResult(*map(torch.from_numpy, res)),
                 FinalState(*map(torch.from_numpy, final)))
                for res, final in out]


def matrix(dtype):
    """The cases of tests/test_torch_solver.py, then the cluster cases,
    on the card."""
    from kube_batch_tpu_torch.models.synthetic import (make_feature_inputs,
                                                       make_synthetic_inputs)
    for seed in (0, 1, 2):
        yield f"synthetic-200x40x20x3-seed{seed}", make_synthetic_inputs(
            200, 40, 20, 3, seed=seed, dtype=dtype)
    yield "synthetic-300x60x25x4-gang0.5-seed7", make_synthetic_inputs(
        300, 60, 25, 4, gang_fraction=0.5, seed=7, dtype=dtype)
    inp, cfg = make_synthetic_inputs(200, 40, 20, 3, seed=3, dtype=dtype)
    yield "synthetic-seed3-other-conf", (inp, cfg._replace(
        job_key_order=("drf", "priority"), queue_key_order=(),
        has_gang=False, has_proportion=False,
        weights=cfg.weights._replace(most_requested=2)))
    for seed in (0, 1, 2):
        yield f"features-seed{seed}", make_feature_inputs(seed, dtype=dtype)
    yield from cluster_cases(dtype)
    yield from repaired_cases(dtype)
    yield from gathered_cases(dtype)


def repaired_cases(dtype, device=None):
    """Shapes the kernel once refused: more queues than a CTA's shared
    memory holds (float64: the queue piece goes to global memory), and 10
    and 20 resource dims (the instantiation for any R), the last with node
    rows in global memory too."""
    from kube_batch_tpu_torch.models.synthetic import (make_feature_inputs,
                                                       make_synthetic_inputs,
                                                       with_scalar_dims)
    if dtype == torch.float64:
        yield "queues-2500-in-global", make_synthetic_inputs(
            3000, 400, 2600, 2500, seed=21, dtype=dtype, device=device)
    yield "features-r10", with_scalar_dims(make_feature_inputs(
        6, n_nodes=1100, dtype=dtype, device=device), 10, seed=6)
    yield "synthetic-r20", with_scalar_dims(make_synthetic_inputs(
        6000, 1500, 80, 4, seed=22, dtype=dtype, device=device), 20, seed=22)
    yield "synthetic-r20-rows-in-global", with_scalar_dims(
        make_synthetic_inputs(300, 30_000, 200, 4, seed=23, dtype=dtype,
                              device=device), 20, seed=23)


def cluster_cases(dtype, device=None):
    """Shapes that spread the node slices over clusters of 2, 4, 8 and 16
    CTAs (N not a multiple of C x 1024; uniform nodes, so ties cross CTA
    boundaries), a case whose first winners lie in the last CTA, features
    at thousands of nodes, and one whose rows do not all fit on chip."""
    from kube_batch_tpu_torch.models.synthetic import (make_feature_inputs,
                                                       make_synthetic_inputs)
    from kube_batch_tpu_torch.ops import cuda_solver
    for tasks, nodes, jobs in ((1000, 1100, 60), (1000, 2500, 60),
                               (1000, 5000, 60), (1000, 20000, 60)):
        yield f"cluster-{tasks}x{nodes}x{jobs}", make_synthetic_inputs(
            tasks, nodes, jobs, 4, seed=11, dtype=dtype, device=device)
    # Every node before the last CTA's slice starts a quarter full, so the
    # least-requested score sends the first placements to the last CTA.
    inp, cfg = make_synthetic_inputs(1000, 20000, 60, 4, seed=12,
                                     dtype=dtype, device=device)
    lo = cuda_solver.plan_of(inp, cfg).slices(inp.node_idle.shape[0])[-1][0]
    load = inp.node_idle.clone()
    load[lo:] = 0
    load //= 4
    yield "cluster-last-cta-wins", (inp._replace(
        node_idle=inp.node_idle - load, node_used=inp.node_used + load), cfg)
    for seed, nodes in ((4, 3000), (5, 6000)):
        yield f"features-{nodes}-nodes-seed{seed}", make_feature_inputs(
            seed, n_nodes=nodes, dtype=dtype, device=device)
    yield "rows-in-global-300x100000x6000", make_synthetic_inputs(
        300, 100_000, 6000, 4, seed=13, dtype=dtype, device=device)


def validate(inputs, assignment, kind, order, ordered, n_nodes: int) -> int:
    """actions/tpu_allocate.py _validate_result, plus placed > 0."""
    p = int(inputs.task_req.shape[0])
    shapes = (assignment.shape, kind.shape, order.shape)
    if shapes != ((p,), (p,), (p,)):
        raise AssertionError(f"malformed result: expected [P={p}], got "
                             f"{shapes}")
    if not ordered.size:
        raise AssertionError("the solve placed nothing")
    if int(ordered.min()) < 0 or int(ordered.max()) >= p:
        raise AssertionError("placement permutation out of range")
    sel = assignment[ordered]
    if int(sel.min()) < 0 or int(sel.max()) >= n_nodes:
        raise AssertionError("node index out of range")
    if np.any(kind[ordered] <= 0):
        raise AssertionError("permutation selects unplaced tasks")
    if not np.array_equal(np.sort(order[ordered]),
                          np.arange(order[ordered].min(),
                                    order[ordered].min() + ordered.size)):
        raise AssertionError("placement steps are not one consecutive run")
    return int(ordered.size)


def plan_fields(cuda_solver, inp, cfg, max_cluster=None) -> dict:
    """The cluster plan for these inputs under a cluster bound (by
    default the largest size the kernel takes; the card's own bound
    applies on top at launch)."""
    plan = cuda_solver.plan_of(inp, cfg, max_cluster
                               or cuda_solver.CLUSTER_SIZES[-1])
    return dict(n=inp.node_idle.shape[0], r=inp.task_req.shape[1],
                q=inp.queue_deserved.shape[0], cluster=plan.cluster,
                smem_bytes=plan.smem_bytes,
                rows_on_chip=f"{plan.smem_rows}/{plan.rows}",
                jsta_smem=plan.jsta_smem, jwork_smem=plan.jwork_smem,
                queue_piece="shared" if plan.queue_smem else "global")


def phase_split(cuda_solver, inp, cfg) -> dict:
    """One more launch with the kernel's clock64() phase stamps on: thread
    0's cycles in each phase, turned into microseconds by the launch's
    own cycles per CUDA-event millisecond (this includes the buffer
    build, so the rate is a slight underestimate of the SM clock)."""
    stamps = torch.zeros(len(cuda_solver.PHASES), dtype=torch.int64,
                         device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    cuda_solver.solve_allocate_cuda(inp, cfg, stamps=stamps)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop)
    got = dict(zip(cuda_solver.PHASES, stamps.tolist()))
    cycles_per_us = got["total"] / (ms * 1e3)
    split = {f"{k}_us": got[k] / cycles_per_us for k in cuda_solver.PHASES
             if k not in ("placements", "pops", "total")}
    return dict(**plan_fields(cuda_solver, inp, cfg), stamped_ms=ms,
                cycles_per_us=cycles_per_us,
                placements=got["placements"], pops=got["pops"],
                us_per_placement=sum(split[f"{k}_us"] for k in (
                    "node_scan", "cta_reduce", "cluster_exchange",
                    "owner_update")) / max(got["placements"], 1),
                us_per_pop=sum(split[f"{k}_us"] for k in (
                    "queue_pop", "job_pop", "write_back"))
                / max(got["pops"], 1), **split)


@contextlib.contextmanager
def env_arm(env: dict):
    """The KUBE_BATCH_TPU_* variables of ``env`` for the block."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def incremental_arm(on: bool):
    """Run the block with incremental sessions on (the default) or as the
    reference's KUBE_BATCH_TPU_INCREMENTAL=0 control; the knob is read at
    every call, so one process runs both arms."""
    return env_arm({"KUBE_BATCH_TPU_INCREMENTAL": "1" if on else "0"})


def _register(device):
    """The port's default plugins and actions in its own registries."""
    from kube_batch_tpu_torch.actions.factory import register_default_actions
    from kube_batch_tpu_torch.plugins.factory import register_default_plugins
    from kube_batch_tpu_torch.scheduler import (DEFAULT_SCHEDULER_CONF,
                                                parse_scheduler_conf)
    register_default_plugins()
    register_default_actions(device=device)
    return parse_scheduler_conf(DEFAULT_SCHEDULER_CONF).tiers


def _run_session(cache, tiers, action):
    """open_session -> tpu-allocate -> close_session; returns the
    session's seconds by stage (open, the action's four, close) and its
    wall time."""
    from kube_batch_tpu_torch.framework import close_session, open_session
    action.last = None
    began = time.perf_counter()
    ssn = open_session(cache, tiers)
    opened = time.perf_counter()
    try:
        action.execute(ssn)
        executed = time.perf_counter()
        over = [name for name, node in ssn.nodes.items()
                if over_allocatable(node)]
    finally:
        closing = time.perf_counter()
        close_session(ssn)
    ended = time.perf_counter()
    if action.last is None:
        raise AssertionError("the session solved nothing on the device "
                             "(host fallback or an empty backlog)")
    if over:
        raise AssertionError(f"{len(over)} nodes over their allocatable "
                             f"after apply, e.g. {over[:3]}")
    stages = {"open": opened - began, **action.last.stages,
              "close": ended - closing}
    # The allocatable check between the action and the close is not
    # session time.
    return stages, (executed - began) + (ended - closing)


def over_allocatable(node) -> bool:
    """Whether a node holds more than its allocatable in any dimension or
    more pods than its cap (exact compares, no epsilon)."""
    used, alloc = node.used, node.allocatable
    if used.milli_cpu > alloc.milli_cpu or used.memory > alloc.memory:
        return True
    if len(node.tasks) > alloc.max_task_num:
        return True
    return any(v > (alloc.scalar_resources or {}).get(k, 0.0)
               for k, v in (used.scalar_resources or {}).items())


def over_committed(node) -> bool:
    """Whether the tasks that stay on a node — every resident but the
    Releasing victims, which leave — hold more than its allocatable in
    any dimension, or more pods than its cap (exact compares).  After an
    eviction ``node.used`` still counts the victims until they exit, and
    a preemptor pipelined onto their room counts as well, so used alone
    may exceed the allocatable by design."""
    from kube_batch_tpu_torch.api import Resource, TaskStatus
    stay = [t for t in node.tasks.values()
            if t.status is not TaskStatus.Releasing]
    held = Resource.empty()
    for t in stay:
        held.add(t.resreq)
    alloc = node.allocatable
    if held.milli_cpu > alloc.milli_cpu or held.memory > alloc.memory:
        return True
    if len(stay) > alloc.max_task_num:
        return True
    return any(v > (alloc.scalar_resources or {}).get(k, 0.0)
               for k, v in (held.scalar_resources or {}).items())


@contextlib.contextmanager
def native_arm(on: bool):
    """Run the block with the C host walk (the default) or as the
    reference's KUBE_BATCH_TPU_NO_NATIVE=1 control, in this process: the
    three bindings that the knob leaves None when the package is imported
    — Session's ``native_apply``, the tensorizer's ``_pod_static`` (back
    to its Python body) and ``native.clone_task_map`` (read at each call)
    — are swapped for the block."""
    from kube_batch_tpu_torch import native
    from kube_batch_tpu_torch.framework import session as session_mod
    from kube_batch_tpu_torch.models import tensor_snapshot
    saved = (session_mod.native_apply, tensor_snapshot._pod_static,
             native.clone_task_map)
    if not on:
        session_mod.native_apply = None
        tensor_snapshot._pod_static = tensor_snapshot._pod_static_py
        native.clone_task_map = None
    try:
        yield
    finally:
        (session_mod.native_apply, tensor_snapshot._pod_static,
         native.clone_task_map) = saved


def session_phase(cuda_solver, card, sessions=3) -> int:
    """The slice's main path at the north star, in both native arms: the
    C host walk and the NO_NATIVE=1 control (native_arm), each on its own
    make_synthetic_cache built through the cache's ingestion.
    ``sessions`` sessions (one cold, the rest warm) of open_session ->
    TpuAllocateAction(cuda, float32) -> close_session per arm, the arms taking turns (C first in
    even rounds, the control first in odd ones), every bound pod echoed
    back unchanged between sessions (bench.py measure_full_session), so
    each sees the same backlog.  Run as the KUBE_BATCH_TPU_INCREMENTAL=0
    arm: with incremental sessions on, an unchanged backlog ships clean
    and reuses the previous solve, and this phase measures the full
    session.  The sessions run under the production GC posture, as
    measure_full_session runs them.  The arms must bind the same pods in
    the same order and write the same pod-group statuses.  After the
    timed sessions, one more warm session per arm runs under cProfile
    (apply_profile).  Returns the kernel launches of the timed
    sessions."""
    from kube_batch_tpu_torch.actions.tpu_allocate import TpuAllocateAction
    from kube_batch_tpu_torch.api import pod_key
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_cache

    arms = {}
    with incremental_arm(False):
        tiers = _register("cuda")
        for on in (True, False):
            began = time.perf_counter()
            cache, binder = make_synthetic_cache(*NORTH_STAR)
            tasks = [t for job in cache.jobs.values()
                     for t in job.tasks.values()]
            arms[on] = dict(
                name="native" if on else "no_native", cache=cache,
                binder=binder, build_s=time.perf_counter() - began,
                pods={pod_key(t.pod): t.pod for t in tasks},
                job_of={pod_key(t.pod): t.job for t in tasks},
                min_avail={uid: job.min_available
                           for uid, job in cache.jobs.items()},
                action=TpuAllocateAction(device="cuda", dtype=torch.float32),
                runs=[], binds=[], launches=0)
        with gc_posture():
            for i in range(sessions):
                for on in ((True, False) if i % 2 == 0 else (False, True)):
                    with native_arm(on):
                        timed_session(cuda_solver, arms[on], tiers, i)
            for on in (True, False):
                arm = arms[on]
                seen = len(arm["binder"].channel)
                with native_arm(on):
                    arm["profile"] = apply_profile(arm["cache"], tiers,
                                                   arm["action"])
                echo_binds(arm["cache"], arm["binder"], arm["pods"], seen)
    summary = {on: arm_summary(arms[on], card) for on in (True, False)}
    # The C walk's cache, its backlog echoed back, for the deadline drill
    # and the profile.
    KEPT["session"] = dict(arms[True], tiers=tiers)
    for on in (True, False):
        phase("apply-profile", arm=arms[on]["name"], shape=list(NORTH_STAR),
              **arms[on]["profile"], card=card)
    for key in ("binds", "statuses"):
        if summary[True][key] != summary[False][key]:
            raise AssertionError(f"session: the C walk's {key} differ from "
                                 f"the NO_NATIVE=1 arm's")
    c, py = summary[True]["apply_ms"], summary[False]["apply_ms"]
    phase("session-arms", identical_binds_and_statuses=True,
          binds=sum(len(b) for b in arms[True]["binds"]),
          statuses=len(summary[True]["statuses"]),
          apply_ms_median_c=c, apply_ms_median_no_native=py,
          apply_share_of_no_native=c / py,
          apply_ms_c=[r[0]["apply"] * 1e3 for r in arms[True]["runs"][1:]],
          apply_ms_no_native=[r[0]["apply"] * 1e3
                              for r in arms[False]["runs"][1:]],
          wall_ms_median_c=summary[True]["wall_ms"],
          wall_ms_median_no_native=summary[False]["wall_ms"], card=card)
    return arms[True]["launches"] + arms[False]["launches"]


def timed_session(cuda_solver, arm, tiers, i) -> None:
    """Session ``i`` of one arm of the session phase: checked against a
    direct launch on its shipped inputs, then every bind echoed back
    unchanged (outside the clock)."""
    from kube_batch_tpu_torch.api import pod_key
    cache, binder, action = arm["cache"], arm["binder"], arm["action"]
    seen = len(binder.channel)
    cuda_solver.solve_allocate_cuda.launches = 0
    stages, wall = _run_session(cache, tiers, action)
    got = cuda_solver.solve_allocate_cuda.launches
    arm["launches"] += got
    last = action.last
    binds = [(key, binder.binds[key]) for key in binder.channel[seen:]]
    arm["binds"].append(binds)
    if last.route != "cuda" or last.snap.needs_fallback:
        raise AssertionError(f"session {i}: route {last.route}, "
                             f"fallback {last.snap.fallback_reason}")
    if got != 1:
        raise AssertionError(f"session {i} launched the kernel {got} times")
    # The bind map read off a direct launch on the shipped inputs, timed
    # with CUDA events (the kernel's share of the session).
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    res, _ = cuda_solver.solve_allocate_cuda(last.inputs, last.snap.config)
    stop.record()
    stop.synchronize()
    kernel_ms = start.elapsed_time(stop)
    assignment = res.assignment.cpu().numpy()
    kind = res.kind.cpu().numpy()
    order = res.order.cpu().numpy()
    placed = np.nonzero(kind > 0)[0]
    ordered = placed[np.argsort(order[placed], kind="stable")]
    expect = [(pod_key(last.snap.tasks[t].pod),
               last.snap.node_names[assignment[t]]) for t in ordered]
    if int(res.step) != len(binds) or len(binds) != ordered.size:
        raise AssertionError(f"session {i}: {len(binds)} binds for "
                             f"{int(res.step)} placements")
    # A map: the binder sees each gang job's tasks together, in the order
    # the jobs become ready, not in placement order.
    if len(dict(binds)) != len(binds) or dict(binds) != dict(expect):
        raise AssertionError(f"session {i}: the bind map differs from the "
                             f"kernel's placements on its inputs")
    per_job = {}
    for key, _host in binds:
        job = arm["job_of"][key]
        per_job[job] = per_job.get(job, 0) + 1
    short = [uid for uid, n in per_job.items()
             if n < arm["min_avail"][uid]]
    if short:
        raise AssertionError(f"session {i}: gang jobs bound below "
                             f"minAvailable: {short[:3]}")
    arm["runs"].append((stages, wall, len(binds), kernel_ms))
    phase("session-run", arm=arm["name"], session=i, cold=i == 0,
          wall_s=wall, binds=len(binds), launches=got, kernel_ms=kernel_ms,
          stages_ms={k: v * 1e3 for k, v in stages.items()})
    pods = arm["pods"]
    for key, _host in binds:
        cache.update_pod(pods[key], pods[key])


def arm_summary(arm, card) -> dict:
    """Prints one arm's ``session`` line (warm medians and p90s by stage,
    the wall time, the kernel's share) and returns what the arms
    compare."""
    runs = arm["runs"]
    warm = runs[1:]
    walls = [w for _s, w, _b, _k in warm]
    split = {k: float(np.median([s[k] for s, _w, _b, _k in warm])) * 1e3
             for k in warm[0][0]}
    split_p90 = {k: float(np.percentile([s[k] for s, _w, _b, _k in warm],
                                        90)) * 1e3 for k in warm[0][0]}
    kernel_med = float(np.median([k for _s, _w, _b, k in warm]))
    wall_med = float(np.median(walls)) * 1e3
    phase("session", arm=arm["name"], shape=list(NORTH_STAR),
          build_s=arm["build_s"], cold_wall_ms=runs[0][1] * 1e3,
          warm_wall_ms_median=wall_med,
          warm_wall_ms_p90=float(np.percentile(walls, 90)) * 1e3,
          warm_wall_ms_all=[w * 1e3 for w in walls],
          stage_ms_median=split, stage_ms_p90=split_p90,
          kernel_ms_median=kernel_med,
          kernel_share_of_session=kernel_med / wall_med,
          binds_per_session=[b for _s, _w, b, _k in runs],
          launches=arm["launches"], route="cuda", card=card)
    statuses = [(pg.metadata.namespace, pg.metadata.name, pg.status.phase,
                 pg.status.running,
                 [(c.type, c.status, c.reason, c.message)
                  for c in pg.status.conditions])
                for pg in arm["cache"].status_updater.pod_groups]
    return dict(binds=arm["binds"], statuses=statuses,
                apply_ms=split["apply"], wall_ms=wall_med)


def apply_profile(cache, tiers, action, top: int = 12) -> dict:
    """One session under cProfile, profiling only inside
    Session.batch_apply_solved and inside tensorize_session: per function
    the own time (tottime), the time with its callees and the call count,
    the ``top`` largest own times of each, and each profile's total."""
    import cProfile
    import pstats

    from kube_batch_tpu_torch.framework.session import Session
    from kube_batch_tpu_torch.models import tensor_snapshot

    profs = {"batch_apply_solved": cProfile.Profile(),
             "tensorize_session": cProfile.Profile()}
    apply_fn = Session.batch_apply_solved
    tensorize_fn = tensor_snapshot.tensorize_session

    def apply(self, *args, **kw):
        return profs["batch_apply_solved"].runcall(apply_fn, self, *args,
                                                   **kw)

    def tensorize(*args, **kw):
        return profs["tensorize_session"].runcall(tensorize_fn, *args, **kw)

    Session.batch_apply_solved = apply
    tensor_snapshot.tensorize_session = tensorize
    try:
        stages, wall = _run_session(cache, tiers, action)
    finally:
        Session.batch_apply_solved = apply_fn
        tensor_snapshot.tensorize_session = tensorize_fn
    out = dict(wall_ms=wall * 1e3,
               stages_ms={k: v * 1e3 for k, v in stages.items()})
    for name, prof in profs.items():
        st = pstats.Stats(prof)
        rows = sorted(st.stats.items(), key=lambda kv: kv[1][2],
                      reverse=True)[:top]
        out[name] = dict(total_ms=st.total_tt * 1e3, top=[dict(
            fn=f"{os.path.basename(path)}:{line}({func})", calls=nc,
            tottime_ms=tt * 1e3, cumtime_ms=ct * 1e3)
            for (path, line, func), (_cc, nc, tt, ct, _callers) in rows])
    return out


def session_vs_cpu_phase(cuda_solver) -> None:
    """One session at a mid size on the card and the same session on the
    CPU (the plain route): the binds in bind order and the pod-group
    statuses must be exactly equal."""
    from kube_batch_tpu_torch.actions.tpu_allocate import TpuAllocateAction
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_cache

    shape = (5_000, 1_000, 200, 4)
    out = {}
    for device in ("cuda", "cpu"):
        tiers = _register(device)
        cache, binder = make_synthetic_cache(*shape)
        action = TpuAllocateAction(device=device, dtype=torch.float32)
        _stages, wall = _run_session(cache, tiers, action)
        statuses = [(pg.metadata.namespace, pg.metadata.name,
                     pg.status.phase, pg.status.running,
                     [(c.type, c.status, c.reason, c.message)
                      for c in pg.status.conditions])
                    for pg in cache.status_updater.pod_groups]
        out[device] = (list(binder.channel), list(binder.binds.items()),
                       statuses, wall, action.last.route)
    card, cpu = out["cuda"], out["cpu"]
    if card[4] != "cuda" or cpu[4] != "torch":
        raise AssertionError(f"routes {card[4]} / {cpu[4]}")
    if card[:3] != cpu[:3]:
        raise AssertionError("the card's session and the CPU's differ")
    phase("session-vs-cpu", shape=list(shape), binds=len(card[1]),
          statuses=len(card[2]), cuda_wall_s=card[3], cpu_wall_s=cpu[3],
          identical=True)


def bound_of(cuda_solver, inp, kout) -> dict:
    """The least time the card could take for one solve on ``inp``: each
    buffer the kernel reads once and each it writes once over the HBM
    rate, against the placing node scans (this run's steps x the node
    axis x OPS_PER_NODE_SCAN) over the float32 lane rate."""
    ops = cuda_solver._operands(inp)
    in_bytes = sum(t.numel() * t.element_size()
                   for t in (*ops.bufs, ops.task_data, ops.task_sig,
                             ops.sig_mask, ops.sig_bonus, ops.nport, ops.nsel,
                             ops.total, ops.score_shift))
    out_bytes = (kout[0].assignment.shape[0] * 4 * 4 + 4
                 + sum(t.numel() * t.element_size() for t in kout[1]))
    n_pad = ops.bufs.node_int.shape[1]
    steps = int(kout[0].step)
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = steps * n_pad * OPS_PER_NODE_SCAN / LANE_OPS_PER_S * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    return dict(bound_ms=bound_ms, bound_by=bound_by,
                bytes_moved=in_bytes + out_bytes, bytes_bound_ms=bytes_ms,
                lane_ops=steps * n_pad * OPS_PER_NODE_SCAN,
                ops_bound_ms=ops_ms)


def gathered_cases(dtype, device=None):
    """The node axes a steady session's candidate-row launch takes: C = 8,
    512 (1% churn at the north star: about 500 pending tasks of one
    profile) and 1,280 rows gathered out of a larger resident axis, the
    last row of the two larger cases a padding row, as
    ops/solver._gather_candidate_inputs builds them."""
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
    from kube_batch_tpu_torch.ops.solver import _gather_candidate_inputs
    for rows in (8, 512, 1280):
        inp, cfg = make_synthetic_inputs(3 * rows, 4 * rows, 6, 2, seed=rows,
                                         dtype=dtype, device=device)
        rng = np.random.default_rng(rows)
        idx = np.sort(rng.choice(4 * rows, size=rows, replace=False))
        valid = np.ones(rows, bool)
        valid[-1] = rows == 8
        dev = inp.node_idle.device
        yield f"gathered-c{rows}", (_gather_candidate_inputs(
            inp, torch.from_numpy(idx).long().to(dev),
            torch.from_numpy(valid).to(dev)), cfg)


def steady_run(cuda_solver, shape, rounds, *, n_signatures=1, control=False,
               device="cuda", check_kernel=True):
    """The steady state of the reference's measure_steady_session
    (bench.py) on the port: make_synthetic_cache(*shape), one cold session,
    then ``rounds`` rounds of 1% churn (models/synthetic.SteadyChurn: new
    gangs in, pods of two rounds before retired, binds and pod-group
    statuses echoed back), each an open_session -> TpuAllocateAction ->
    close_session.  ``control`` runs it with KUBE_BATCH_TPU_INCREMENTAL=0.

    Returns one record per session (the cold one first): kind, reason,
    route, candidate rows, launches, reuse, stages, the session's trace
    spans summed by name (``spans_ms``: the snapshot and each plugin's
    open and close, apply and fit deltas, ...), wall time, and the
    round's bind map and events.  Where ``check_kernel``, each solve of a
    gathered program is launched once more directly on the gathered
    inputs and must equal solve_allocate_plain on them, and the action's
    binds must be that launch's placements."""
    from kube_batch_tpu_torch.actions.tpu_allocate import TpuAllocateAction
    from kube_batch_tpu_torch.models import incremental
    from kube_batch_tpu_torch.models.synthetic import (SteadyChurn,
                                                       make_synthetic_cache)
    from kube_batch_tpu_torch.ops.solver import _gather_candidate_inputs
    from kube_batch_tpu_torch.trace import flight_recorder
    from kube_batch_tpu_torch.trace import spans as tspans

    with incremental_arm(not control):
        tiers = _register(device)
        cache, binder = make_synthetic_cache(*shape,
                                             n_signatures=n_signatures)
        churn = SteadyChurn(cache, binder, shape[0], shape[3], churn=0.01)
        action = TpuAllocateAction(device=device, dtype=torch.float32)
        records = []
        for rnd in range(rounds + 1):
            if rnd:
                churn.inject(rnd)
            cache.events.clear()
            cuda_solver.solve_allocate_cuda.launches = 0
            sid = tspans.begin_session(bench="steady")
            try:
                stages, wall = _run_session(cache, tiers, action)
            finally:
                tspans.end_session()
            launches = cuda_solver.solve_allocate_cuda.launches
            spans_ms = {}
            for sp in flight_recorder.get(sid).spans:
                name = sp.name + (f".{sp.args['on']}"
                                  if sp.args and "on" in sp.args else "")
                spans_ms[name] = spans_ms.get(name, 0.0) + sp.dur / 1e3
            last = action.last
            st = incremental.state_for(cache, create=False)
            cand = last.candidates
            rec = dict(round=rnd, kind=st.last_kind if st else "control",
                       reason=st.last_reason if st else "",
                       route=last.route, reused=last.reused,
                       candidate_rows=cand.count if cand else None,
                       gathered_rows=int(cand.idx.shape[0]) if cand else None,
                       launches=launches, wall_s=wall,
                       stages_ms={k: v * 1e3 for k, v in stages.items()},
                       spans_ms=spans_ms, binds=dict(binder.binds),
                       events=list(cache.events))
            if cand is not None and check_kernel and not last.reused:
                # The gathered inputs of this round's launch, rebuilt from
                # the resident inputs before the next ship rewrites them.
                dev = last.inputs.node_idle.device
                sub = _gather_candidate_inputs(
                    last.inputs, torch.from_numpy(cand.idx).long().to(dev),
                    torch.from_numpy(cand.valid).to(dev))
                times = []
                for _ in range(3):
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    kout = cuda_solver.solve_allocate_cuda(
                        sub, last.snap.config)
                    stop.record()
                    wait_device(f"the gathered kernel in round {rnd}")
                    times.append(start.elapsed_time(stop))
                t0 = time.perf_counter()
                pout = cuda_solver.solve_allocate_plain(sub, last.snap.config)
                torch.cuda.synchronize()
                rec["plain_ms"] = (time.perf_counter() - t0) * 1e3
                rec["kernel_ms"] = float(np.median(times))
                rec["max_abs_err"] = compare(kout, pout)
                rec.update(bound_of(cuda_solver, sub, kout))
                local = kout[0].assignment.cpu().numpy()
                placed = kout[0].kind.cpu().numpy() > 0
                full = np.where(placed, cand.remap[np.clip(
                    local, 0, len(cand.remap) - 1)], -1)
                rec["action_equals_launch"] = bool(np.array_equal(
                    np.where(last.kind > 0, last.assignment, -1), full))
            records.append(rec)
            phase("steady-round", shape=list(shape), control=control,
                  signatures=n_signatures,
                  **{k: v for k, v in rec.items()
                     if k not in ("binds", "events")},
                  binds_n=len(rec["binds"]), events_n=len(rec["events"]))
            churn.echo()
        return records


def steady_phase(cuda_solver, card) -> int:
    """The steady state at the north star on the card, both arms, then
    5k x 1k with four signatures (the sig-mask patch), both arms.
    Asserts the binds and events of every round equal between the arms;
    rounds 3 to 6 of the default arm micro sessions on the candidate
    route, each one launch of the kernel on gathered inputs of at most
    1,280 rows that equals the plain version exactly.  Rounds 1 and 2
    re-absorb the cold session's echo (every node, then every pod-group
    status) and take the reference's fallback.  Returns the kernel
    launches of the default arm's run."""
    rounds = 6
    default = steady_run(cuda_solver, NORTH_STAR, rounds)
    control = steady_run(cuda_solver, NORTH_STAR, rounds, control=True,
                         check_kernel=False)
    for d, c in zip(default, control):
        if d["binds"] != c["binds"] or d["events"] != c["events"]:
            raise AssertionError(f"steady round {d['round']}: the default "
                                 f"arm and INCREMENTAL=0 differ")
        if not d["binds"]:
            raise AssertionError(f"steady round {d['round']} bound nothing")
    for d in default[3:]:
        if d["kind"] != "micro" or d["candidate_rows"] is None:
            raise AssertionError(f"steady round {d['round']}: {d['kind']} "
                                 f"({d['reason']}), candidate rows "
                                 f"{d['candidate_rows']}")
        if d["launches"] != 1 or d["route"] != "cuda" or d["reused"]:
            raise AssertionError(f"steady round {d['round']}: "
                                 f"{d['launches']} launches on {d['route']}")
        if d["gathered_rows"] > 1280 or d["max_abs_err"] \
                or not d["action_equals_launch"]:
            raise AssertionError(f"steady round {d['round']}: gathered "
                                 f"{d['gathered_rows']} rows, err "
                                 f"{d['max_abs_err']}, action equals launch "
                                 f"{d['action_equals_launch']}")
    launches = sum(d["launches"] for d in default)

    def summary(records):
        walls = [r["wall_s"] * 1e3 for r in records]
        return dict(wall_ms_median=float(np.median(walls)),
                    wall_ms_p90=float(np.percentile(walls, 90)),
                    wall_ms_all=walls,
                    stage_ms_median={k: float(np.median(
                        [r["stages_ms"][k] for r in records]))
                        for k in records[0]["stages_ms"]},
                    span_ms_median={k: float(np.median(
                        [r["spans_ms"].get(k, 0.0) for r in records]))
                        for k in records[-1]["spans_ms"]},
                    kinds=[r["kind"] for r in records])

    micro = default[3:]
    phase("steady", shape=list(NORTH_STAR), rounds=rounds,
          default_rounds_2_6=summary(default[2:]),
          default_micro_rounds_3_6=summary(micro),
          control_rounds_2_6=summary(control[2:]),
          candidate_rows=[d["candidate_rows"] for d in default],
          gathered_rows=[d["gathered_rows"] for d in default],
          kernel_ms_gathered=[d["kernel_ms"] for d in micro],
          plain_ms_gathered=[d["plain_ms"] for d in micro],
          bound_ms_gathered=[d["bound_ms"] for d in micro],
          bound_by_gathered=micro[0]["bound_by"],
          launches=launches, identical_arms=True, card=card)

    small = (5_000, 1_000, 200, 4)
    hetero = [steady_run(cuda_solver, small, 4, n_signatures=4,
                         control=arm) for arm in (False, True)]
    for d, c in zip(*hetero):
        if d["binds"] != c["binds"] or d["events"] != c["events"]:
            raise AssertionError(f"hetero steady round {d['round']}: the "
                                 f"arms differ")
    phase("steady-hetero", shape=list(small), signatures=4,
          kinds=[d["kind"] for d in hetero[0]],
          candidate_rows=[d["candidate_rows"] for d in hetero[0]],
          binds=[len(d["binds"]) for d in hetero[0]], identical_arms=True)
    return launches + sum(d["launches"] for d in hetero[0])


SHIPPED_CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "config", "kube-batch-conf.yaml")


def shipped_conf() -> str:
    """The shipped four-action conf with tpu-allocate in place of
    allocate (bench.py measure_action_pipeline does the same)."""
    with open(SHIPPED_CONF) as fh:
        conf = fh.read()
    old = '"reclaim, allocate, backfill, preempt"'
    if old not in conf:
        raise AssertionError(f"{SHIPPED_CONF} no longer ships {old}")
    return conf.replace(old, '"reclaim, tpu-allocate, backfill, preempt"')


@contextlib.contextmanager
def gc_posture():
    """The production GC posture that bench.py's measure_action_pipeline
    times the session under: collect, freeze and disable the collector
    for the block."""
    import gc
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.unfreeze()
        gc.enable()


def batch_evict_arm(on: bool):
    """KUBE_BATCH_TPU_BATCH_EVICT for the block: the batched eviction
    engine (1) or its sequential control (0)."""
    return env_arm({"KUBE_BATCH_TPU_BATCH_EVICT": "1" if on else "0"})


def allocate_vs_plain(cuda_solver, action,
                      where: str = "the evict session") -> dict:
    """tpu-allocate's last solve held against the kernel's plain version
    on the same inputs (record_vs_plain on ``action.last``).  Run right
    after the action, before a later ship can rewrite the resident
    inputs."""
    last = action.last
    if last is None or last.reused:
        raise AssertionError(f"tpu-allocate solved nothing on the device in "
                             f"{where}")
    return record_vs_plain(cuda_solver, last, where)


def capture_launch(action):
    """tpu-allocate's last record with its shipped inputs cloned on the
    current stream (a shard session's is its view's), so that it can be
    held against the plain version after later ships have rewritten the
    resident image.  The clone is stream-ordered: nothing waits."""
    last = action.last
    if last is None or last.reused:
        raise AssertionError("tpu-allocate's finish ran without a launch")
    return last._replace(inputs=type(last.inputs)(*(
        t.clone() if hasattr(t, "clone") else t for t in last.inputs)))


def record_vs_plain(cuda_solver, last, where: str) -> dict:
    """One tpu-allocate record (action.last, or a capture_launch) held
    against the kernel's plain version on its inputs: the assignment,
    kind and order the action fetched from its launch must equal
    solve_allocate_plain's exactly (max abs err 0).  A gathered
    (candidate-row) solve is compared on its gathered inputs, its
    placements mapped back to full-space rows."""
    from kube_batch_tpu_torch.ops.solver import _gather_candidate_inputs
    inputs, cand = last.inputs, last.candidates
    dev = inputs.node_idle.device
    if cand is not None:
        inputs = _gather_candidate_inputs(
            inputs, torch.from_numpy(cand.idx).long().to(dev),
            torch.from_numpy(cand.valid).to(dev))
    out = LaunchLedger.hold_one(
        cuda_solver, inputs, last.snap.config,
        (last.assignment, last.kind, last.order), where,
        remap=None if cand is None else cand.remap)
    return dict(route=last.route, gathered=cand is not None, **out)


def solve_vs_plain(cuda_solver, inputs, cfg, got, remap=None,
                   where: str = "") -> dict:
    """A fetched solve ``got`` (assignment, kind, order) held against
    solve_allocate_plain on ``inputs``: equal exactly, or raise.
    ``remap`` maps gathered rows back to the full-space rows of a
    candidate-row solve's assignment.  The plain version runs on the
    host's CPU, on a copy of ``inputs``: the same code on the same
    values, and there a placement costs a few small operations instead
    of a few kernel launches (``plain_ms`` is the CPU's time).  The
    kernel-vs-plain matrix runs it there too; the main path's north-star
    check runs it on the card (the kernels line's ``plain_ms``).  Once
    DeferredHolds is started, a solve that placed a task is held in a
    worker process while this one goes on: its result says ``deferred``
    and the check happens at DeferredHolds.drain."""
    placed = int((np.asarray(got[1]) > 0).sum())
    if DeferredHolds.takes(placed, inputs):
        DeferredHolds.submit(cuda_solver, inputs, cfg, got, remap, where)
        return dict(placed=placed, deferred=True, max_abs_err=None)
    inputs = type(inputs)(*(t.cpu() for t in inputs))
    t0 = time.perf_counter()
    res, _ = cuda_solver.solve_allocate_plain(inputs, cfg)
    plain_ms = (time.perf_counter() - t0) * 1e3
    return check_vs_plain(
        tuple(t.cpu().numpy() for t in (res.assignment, res.kind, res.order,
                                        res.step)),
        got, remap, where, plain_ms)


def check_vs_plain(plain, got, remap, where: str, plain_ms: float) -> dict:
    """``got`` (assignment, kind, order) against the plain version's
    numpy (assignment, kind, order, step): equal exactly, or raise."""
    assignment, kind, order = (np.asarray(a).astype(np.int64)
                               for a in plain[:3])
    got_assignment = np.asarray(got[0], np.int64)
    if remap is not None:
        placed = kind > 0
        assignment = np.where(placed, remap[np.clip(
            assignment, 0, len(remap) - 1)], -1)
        got_assignment = np.where(placed, got_assignment, -1)
    err = 0
    for name, have, want in (("assignment", got_assignment, assignment),
                             ("kind", got[1], kind),
                             ("order", got[2], order)):
        have = np.asarray(have, np.int64)
        if have.shape != want.shape:
            raise AssertionError(f"the launch's {name} in {where} has shape "
                                 f"{have.shape}, the plain version's "
                                 f"{want.shape}")
        if have.size:
            err = max(err, int(np.abs(have - want).max()))
    if err:
        raise AssertionError(f"the launch in {where} != the plain version: "
                             f"max abs err {err}")
    return dict(placed=int((kind > 0).sum()), steps=int(plain[3]),
                plain_ms=plain_ms, max_abs_err=err)


def plain_timed(job):
    """plain_on_host with its own seconds: (assignment, kind, order,
    step) as numpy and the plain version's ms."""
    t0 = time.perf_counter()
    res, _final = plain_on_host(job)
    return res, (time.perf_counter() - t0) * 1e3


class DeferredHolds:
    """Holds of solves of ``DEFER_CELLS`` placements x nodes or more
    (every solve that placed a task; the north star's take tens of
    seconds each on the host) in ``workers`` spawned processes on the
    host's CPU, beside the card work of the phases that follow.  Off until ``start``; ``drain``
    waits for every pending hold, checks it (check_vs_plain), prints
    one ``deferred-holds`` line and stops the workers.  A failed hold
    raises there, before any result line."""

    DEFER_CELLS = 1
    pool = None
    pending = []

    @classmethod
    def start(cls, workers: int = 2) -> None:
        import multiprocessing
        cls.pool = multiprocessing.get_context("spawn").Pool(workers)
        cls.pending = []

    @classmethod
    def takes(cls, placed: int, inputs) -> bool:
        return (cls.pool is not None
                and placed * int(inputs.node_idle.shape[0])
                >= cls.DEFER_CELLS)

    @classmethod
    def submit(cls, cuda_solver, inputs, cfg, got, remap, where) -> None:
        job = (type(inputs), tuple(t.cpu().numpy() for t in inputs), cfg)
        cls.pending.append((where, tuple(np.asarray(a) for a in got),
                            remap, cls.pool.apply_async(plain_timed,
                                                        (job,))))

    @classmethod
    def drain(cls, seconds: float = 900.0) -> int:
        """Check every deferred hold; returns how many."""
        if cls.pool is None:
            return 0
        began = time.perf_counter()
        held = []
        try:
            for where, got, remap, pending in cls.pending:
                left = max(1.0, seconds - (time.perf_counter() - began))
                plain, plain_ms = pending.get(left)
                held.append(dict(where=where, **check_vs_plain(
                    plain, got, remap, where, plain_ms)))
        finally:
            cls.pool.terminate()
            cls.pool.join()
            cls.pool, cls.pending = None, []
        phase("deferred-holds", held=len(held), waited_s=(
            time.perf_counter() - began), max_abs_err=max(
            (h["max_abs_err"] for h in held), default=0), holds=held)
        return len(held)


def held_summary(records) -> dict:
    """The phase-line summary of launches held against the plain
    version (``held``; ``byte_equal`` of them compared with a held solve
    on byte-equal inputs, LaunchLedger.hold_one)."""
    if not records:
        return dict(held=0)
    plain = sorted(r["plain_ms"] for r in records if "plain_ms" in r)
    return dict(held=len(records),
                byte_equal=sum(r["held"] == "byte_equal" for r in records),
                deferred=sum(bool(r.get("deferred")) for r in records),
                max_abs_err=max((r["max_abs_err"] for r in records
                                 if r["max_abs_err"] is not None),
                                default=0),
                gathered=sum(r["gathered"] for r in records),
                placed=[r["placed"] for r in records],
                plain_ms_median=float(np.median(plain)) if plain else None,
                plain_ms_total=float(sum(plain)))


def evict_cycle(cuda_solver, shape, batched: bool, device="cuda",
                check_plain=False, fails=False) -> dict:
    """One session of the shipped four-action conf (reclaim, tpu-allocate,
    backfill, preempt) on a fresh make_churn_cache(*shape) on ``device``,
    float32, under the production GC posture (gc_posture).  Returns each
    action's host-clock time, the victims in order, the binds, the cache
    events, the evictions by action, the shared scanner's stats, the
    session's trace spans summed by name and the session kernel's
    launches (the count set to 0 just before the session and read just
    after).  With ``check_plain``, tpu-allocate's solve is held against
    the plain version right after the action, outside its clock
    (allocate_vs_plain; the record is under ``vs_plain``).  With
    ``fails`` an action must raise DeviceFailure (a drill's fault on the
    card): the session stops there and ``raised`` names the action and
    the error.  Raises if the tasks that stay on a node end over its
    allocatable (over_committed)."""
    from kube_batch_tpu_torch.chaos.breaker import DeviceFailure
    from kube_batch_tpu_torch.framework import close_session, open_session
    from kube_batch_tpu_torch.metrics.metrics import evictions_by_action
    from kube_batch_tpu_torch.models.synthetic import make_churn_cache
    from kube_batch_tpu_torch.scheduler import load_scheduler_conf
    from kube_batch_tpu_torch.trace import flight_recorder
    from kube_batch_tpu_torch.trace import spans as tspans

    _register(device)
    actions, tiers = load_scheduler_conf(shipped_conf())
    names = [a.name() for a in actions]
    if names != ["reclaim", "tpu-allocate", "backfill", "preempt"]:
        raise AssertionError(f"the shipped conf loaded {names}")
    t0 = time.perf_counter()
    cache, binder = make_churn_cache(*shape)
    build_s = time.perf_counter() - t0
    with batch_evict_arm(batched), fused_arm(False), gc_posture():
        before = evictions_by_action()
        cuda_solver.solve_allocate_cuda.launches = 0
        sid = tspans.begin_session(bench="evict")
        ssn = open_session(cache, tiers)
        action_ms = {}
        vs_plain = None
        raised = None
        try:
            for a in actions:
                t0 = time.perf_counter()
                try:
                    a.execute(ssn)
                except DeviceFailure as exc:
                    if not fails:
                        raise
                    raised = f"{a.name()}: {exc}"
                if device == "cuda":
                    torch.cuda.synchronize()
                action_ms[a.name()] = (time.perf_counter() - t0) * 1e3
                if raised is not None:
                    break
                if check_plain and a.name() == "tpu-allocate":
                    vs_plain = allocate_vs_plain(cuda_solver, a)
            if fails and raised is None:
                raise AssertionError("an evict session under a device fault "
                                     "did not raise DeviceFailure")
            launches = cuda_solver.solve_allocate_cuda.launches
            over = [name for name, node in ssn.nodes.items()
                    if over_committed(node)]
            scanner = getattr(ssn, "_shared_scanner", None)
        finally:
            close_session(ssn)
            tspans.end_session()
        after = evictions_by_action()
    spans_ms = {}
    for sp in flight_recorder.get(sid).spans:
        spans_ms[sp.name] = spans_ms.get(sp.name, 0.0) + sp.dur / 1e3
    if over:
        raise AssertionError(f"{len(over)} nodes over their allocatable "
                             f"after the session, e.g. {over[:3]}")
    split = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    return dict(action_ms=action_ms, build_s=build_s, launches=launches,
                raised=raised, evicts=list(cache.evictor.evicts),
                binds=dict(binder.binds), events=list(cache.events),
                split={k: v for k, v in split.items() if v},
                spans_ms=spans_ms, scanner=scanner, vs_plain=vs_plain,
                stats=dict(scanner.stats) if scanner is not None else None)


def evict_solve_vs_cpu(scanner) -> dict:
    """The batched eviction solve (ops/evict_solver.evict_batch_solve,
    PyTorch tensor code with no kernel of its own) replayed on the
    session's staged inputs on the card and on the CPU, its plain
    version: the [K, N] scores and the victim permutation must be equal
    (max abs err 0).  Times both: CUDA events around the card's call,
    the host clock around the CPU's."""
    from kube_batch_tpu_torch.ops.evict_solver import evict_batch_solve

    dyn, trows, node_p, rank_p = scanner.last_batch
    args = (scanner.cfg, scanner.r, scanner.np_pad, scanner.ns_pad)

    def run(device, statics):
        return evict_batch_solve(
            *args, statics, torch.as_tensor(dyn, device=device),
            torch.as_tensor(trows, device=device),
            torch.as_tensor(node_p, device=device),
            torch.as_tensor(rank_p, device=device))

    card_statics = scanner.statics
    cpu_statics = type(card_statics)(*(t.cpu() for t in card_statics))
    run("cuda", card_statics)          # warm the card's allocator
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    card_ms = []
    for _ in range(5):
        start.record()
        card = run("cuda", card_statics)
        stop.record()
        torch.cuda.synchronize()
        card_ms.append(start.elapsed_time(stop))
    t0 = time.perf_counter()
    cpu = run("cpu", cpu_statics)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = 0
    for a, b in zip(card, cpu):
        a = a.cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"evict solve shape/dtype {a.shape} "
                                 f"{a.dtype} vs {b.shape} {b.dtype}")
        err = max(err, int((a.long() - b.long()).abs().max()))
    if err:
        raise AssertionError(f"evict solve on the card != the CPU: max abs "
                             f"err {err}")
    n = int(card_statics.node_exists.shape[0])
    return dict(profiles=int(trows.shape[0]), victims=int(node_p.shape[0]),
                nodes=n, max_abs_err=err, ms=float(np.median(card_ms)),
                plain_ms=plain_ms)


def _stats_ms(runs) -> dict:
    """Median, p90 by nearest rank (bench.py's _stats) and every sample
    of an arm's timed cycles.  With two cycles per arm the p90 is the
    slower of the two: a max of two, not a tail."""
    ranked = sorted(runs)
    p90 = ranked[min(len(ranked) - 1,
                     max(0, math.ceil(0.9 * len(ranked)) - 1))]
    return dict(median=float(np.median(runs)), p90=float(p90),
                all=list(runs))


def evict_phase(cuda_solver, card, timed=2) -> int:
    """The eviction engine at the north star: the shipped four-action conf
    (reclaim, tpu-allocate, backfill, preempt) on make_churn_cache(50k,
    10k, 2k, 4) — every node full of low-priority Running pods and a
    10,000-pod high-priority pending wave split between the occupied
    queues (preempt) and a starved queue (reclaim) — float32 on the card.
    The protocol of bench.py measure_action_pipeline: one warm cycle per
    KUBE_BATCH_TPU_BATCH_EVICT arm, then ``timed`` cycles of
    off/on/on/off (the first two: off, on), each cycle on a
    fresh cache.  Both arms must evict, with the same victims in the same
    order and the same binds; each batched session makes exactly one
    batched dispatch, on the card; each session launches the session
    kernel exactly once; no node ends over its allocatable.  In each
    arm's warm cycle tpu-allocate's launch is held against the plain
    version on its inputs (allocate_vs_plain), and every timed cycle
    must end as its arm's warm cycle did.  Returns the kernel launches
    of all its cycles."""
    shape = NORTH_STAR
    per_arm = {True: {}, False: {}}
    footprint = {}
    launches = 0
    split = None
    stats = []
    replay = None
    vs_plain = {}
    spans = {True: {}, False: {}}
    for i, arm in enumerate((True, False)
                            + (False, True, True, False)[:timed]):
        warm = i < 2
        out = evict_cycle(cuda_solver, shape, arm, check_plain=warm)
        launches += out["launches"]
        if out["launches"] != 1:
            raise AssertionError(f"evict cycle {i} launched the session "
                                 f"kernel {out['launches']} times")
        if not out["evicts"]:
            raise AssertionError(f"evict cycle {i} evicted nothing")
        key = (out["evicts"], out["binds"])
        if footprint.setdefault(arm, key) != key:
            raise AssertionError(f"evict cycle {i} differs from its arm's "
                                 f"warm cycle")
        if warm:
            vs_plain["batched" if arm else "sequential"] = out["vs_plain"]
            phase("evict-allocate-vs-plain", batched=arm, **out["vs_plain"])
            continue
        for name, ms in out["action_ms"].items():
            per_arm[arm].setdefault(name, []).append(ms)
        for name, ms in out["spans_ms"].items():
            spans[arm].setdefault(name, []).append(ms)
        if arm:
            sc = out["scanner"]
            if (sc is None or out["stats"]["batch_dispatches"] != 1
                    or sc.device.type != "cuda"
                    or not sc.statics.node_exists.is_cuda):
                raise AssertionError(
                    f"evict cycle {i}: not one batched dispatch on the "
                    f"card ({out['stats']})")
            stats.append(out["stats"])
            split = split or out["split"]
            if replay is None:
                replay = evict_solve_vs_cpu(sc)
        phase("evict-cycle", cycle=i - 2, batched=arm, build_s=out["build_s"],
              action_ms=out["action_ms"], evictions=len(out["evicts"]),
              evictions_by_action=out["split"], binds=len(out["binds"]),
              scanner_stats=out["stats"], launches=out["launches"],
              spans_ms=out["spans_ms"])
    if footprint[True] != footprint[False]:
        raise AssertionError("the batched arm's victims or binds differ "
                             "from the sequential arm's")
    KEPT["evict"] = dict(footprint=footprint[False], action_ms=per_arm)
    evicts = footprint[True][0]
    phase("evict", shape=list(shape), conf="config/kube-batch-conf.yaml "
          "with tpu-allocate", dtype="float32",
          action_ms_batched={k: _stats_ms(v)
                             for k, v in per_arm[True].items()},
          action_ms_sequential={k: _stats_ms(v)
                                for k, v in per_arm[False].items()},
          evictions=len(evicts), evictions_by_action=split,
          binds=len(footprint[True][1]), scanner_stats=stats,
          span_ms_median_batched={k: float(np.median(v))
                                  for k, v in spans[True].items()},
          span_ms_median_sequential={k: float(np.median(v))
                                     for k, v in spans[False].items()},
          kernel_launches=launches, identical_arms=True,
          evict_solve=replay, allocate_vs_plain=vs_plain, card=card)
    return launches


def evict_vs_cpu_phase(cuda_solver) -> None:
    """The four-action session at 5k x 1k on the card and on the CPU
    (device="cpu", the plain route of every device step), in both
    KUBE_BATCH_TPU_BATCH_EVICT arms: the same victims in the same order,
    the same binds and the same cache events."""
    shape = (5_000, 1_000, 200, 4)
    for arm in (True, False):
        out = {d: evict_cycle(cuda_solver, shape, arm, device=d)
               for d in ("cuda", "cpu")}
        card, cpu = out["cuda"], out["cpu"]
        for key in ("evicts", "binds", "events"):
            if card[key] != cpu[key]:
                raise AssertionError(f"evict session at {shape}: the "
                                     f"card's {key} differ from the CPU's")
        if not card["evicts"]:
            raise AssertionError("the 5k x 1k evict session evicted nothing")
        phase("evict-vs-cpu", shape=list(shape), batched=arm,
              evictions=len(card["evicts"]), binds=len(card["binds"]),
              events=len(card["events"]), identical=True)


TOPO_CONF = """
actions: "topo-allocate, tpu-allocate, backfill"
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
  - name: topology
"""
# The box scan's node ceiling: KUBE_BATCH_TPU_TOPO_MAX_NODES' default,
# above which topo-allocate leaves slice jobs pending.
TOPO_DIMS = (16, 16, 16)
TOPO_SLICE = "4x4x4"


def topo_cycle(cuda_solver, cache, actions, tiers, device) -> dict:
    """One session of TOPO_CONF: each action's host-clock time, the box
    scans dispatched, the node rows of the topology plugin's
    fragmentation bonus that are not zero, and the session kernel's
    launches by tpu-allocate (its count set to 0 just before the session
    and read just after), each held against solve_allocate_plain on its
    inputs (allocate_vs_plain) right after the action."""
    from kube_batch_tpu_torch.framework import close_session, open_session
    from kube_batch_tpu_torch.metrics.metrics import session_dispatch_counts

    tpu = next(a for a in actions if a.name() == "tpu-allocate")
    tpu.last = None
    dispatches = session_dispatch_counts().get("topo", 0)
    cuda_solver.solve_allocate_cuda.launches = 0
    ssn = open_session(cache, tiers)
    action_ms = {}
    vs_plain = None
    try:
        bonus = ssn.prescan.get("topo_frag_bonus")
        for a in actions:
            t0 = time.perf_counter()
            a.execute(ssn)
            if device == "cuda":
                torch.cuda.synchronize()
            action_ms[a.name()] = (time.perf_counter() - t0) * 1e3
            if a is tpu and device == "cuda" and tpu.last is not None \
                    and not tpu.last.reused:
                vs_plain = allocate_vs_plain(cuda_solver, tpu,
                                             "a topo session")
        launches = cuda_solver.solve_allocate_cuda.launches
        over = [name for name, node in ssn.nodes.items()
                if over_committed(node)]
    finally:
        close_session(ssn)
    if over:
        raise AssertionError(f"{len(over)} nodes over their allocatable "
                             f"after a topo session, e.g. {over[:3]}")
    if launches > 1 or (launches == 1) != (vs_plain is not None):
        raise AssertionError(f"tpu-allocate launched {launches} times, "
                             f"{'one' if vs_plain else 'none'} held against "
                             f"the plain version")
    return dict(action_ms=action_ms, launches=launches, vs_plain=vs_plain,
                tpu_allocate=("launched" if launches else
                              "no launch: nothing pending"
                              if tpu.last is None else "no launch: reused"),
                box_scans=session_dispatch_counts().get("topo", 0)
                - dispatches,
                frag_bonus_rows=(int(np.count_nonzero(bonus))
                                 if bonus is not None else 0))


def topo_arm(cuda_solver, device, defrag: bool, batch: bool,
             dims=TOPO_DIMS, slice_shape=TOPO_SLICE, fault=None) -> dict:
    """The reference's two-cycle fragmentation-pressure protocol
    (bench.py _run_topo_arm) on the port, under the production GC
    posture: make_topo_cache(pods=("pod-a",), dims, slice_shape), cycle 1,
    the evicted victims echoed as deletions, the fragmentation stats at
    truth, cycle 2.  ``defrag`` and ``batch`` set KUBE_BATCH_TPU_TOPO_DEFRAG
    and KUBE_BATCH_TPU_TOPO_BATCH (0: the numpy oracle).  ``fault`` (a
    context manager, a drill's) wraps one more session before cycle 1,
    which must raise DeviceFailure: what it raised, evicted and bound is
    returned under ``failed``, and the protocol then runs on the same
    cache."""
    from kube_batch_tpu_torch.api import pod_key
    from kube_batch_tpu_torch.models.synthetic import make_topo_cache
    from kube_batch_tpu_torch.models.topology import build_view
    from kube_batch_tpu_torch.scheduler import load_scheduler_conf

    env = {"KUBE_BATCH_TPU_TOPO_BATCH": "1" if batch else "0",
           "KUBE_BATCH_TPU_TOPO_DEFRAG": "1" if defrag else "0",
           "KUBE_BATCH_TPU_FUSED": "0"}
    with env_arm(env), gc_posture():
        _register(device)
        actions, tiers = load_scheduler_conf(TOPO_CONF)
        names = [a.name() for a in actions]
        if names != ["topo-allocate", "tpu-allocate", "backfill"]:
            raise AssertionError(f"the topology conf loaded {names}")
        t0 = time.perf_counter()
        cache, binder = make_topo_cache(pods=("pod-a",), dims=dims,
                                        slice_shape=slice_shape)
        build_s = time.perf_counter() - t0
        podmap = {pod_key(t.pod): t.pod for job in cache.jobs.values()
                  for t in job.tasks.values()}
        failed = None
        if fault is not None:
            failed = topo_failed_cycle(cache, binder, actions, tiers, fault)
        # The failed session's close writes its pod-group statuses too.
        mark = len(cache.status_updater.pod_groups)
        first = topo_cycle(cuda_solver, cache, actions, tiers, device)
        evicts = list(cache.evictor.evicts)
        for key in evicts:
            cache.delete_pod(podmap.pop(key))
        view = build_view(cache.nodes)
        free = np.asarray([not cache.nodes[n].tasks
                           for n in view.node_names], bool) & view.valid
        frag_after = view.frag_stats(free)
        second = topo_cycle(cuda_solver, cache, actions, tiers, device)
    binds = [(key, binder.binds[key]) for key in binder.channel]
    statuses = [(pg.metadata.namespace, pg.metadata.name, pg.status.phase,
                 [(c.type, c.status, c.reason, c.message)
                  for c in pg.status.conditions])
                for pg in cache.status_updater.pod_groups[mark:]]
    return dict(build_s=build_s, cycles=[first, second], evicts=evicts,
                frag_after=frag_after, binds=binds, statuses=statuses,
                slice_hosts=[host for key, host in binds if "slice0" in key],
                topo_action=actions[0], failed=failed)


def topo_failed_cycle(cache, binder, actions, tiers, fault) -> dict:
    """One TOPO_CONF session under ``fault`` that must raise
    DeviceFailure, in its own flight-recorder trace: what it raised,
    evicted and bound, and the trace's degraded notes."""
    from kube_batch_tpu_torch.chaos.breaker import DeviceFailure
    from kube_batch_tpu_torch.framework import close_session, open_session
    from kube_batch_tpu_torch.trace import flight_recorder
    from kube_batch_tpu_torch.trace import spans as tspans
    sid = tspans.begin_session(bench="topo-fault")
    raised = None
    try:
        with fault():
            ssn = open_session(cache, tiers)
            try:
                for a in actions:
                    a.execute(ssn)
            except DeviceFailure as exc:
                raised = f"{a.name()}: {exc}"
            finally:
                close_session(ssn)
    finally:
        tspans.end_session()
    if raised is None:
        raise AssertionError("a topo session under a device fault did not "
                             "raise DeviceFailure")
    return dict(raised=raised, evicts=list(cache.evictor.evicts),
                binds=dict(binder.binds),
                notes=list(flight_recorder.get(sid).meta.get("degraded", [])))


def is_box(hosts, dims, shape) -> bool:
    """Whether ``hosts`` (t-<pod>-<x>-<y>-<z>) are exactly one
    axis-aligned box of ``shape`` on the ``dims`` torus."""
    coords = sorted(tuple(int(v) for v in h.split("-")[2:]) for h in hosts)
    if len({h.split("-")[1] for h in hosts}) != 1:
        return False
    for origin in coords:
        box = sorted(tuple((origin[a] + off[a]) % dims[a] for a in range(3))
                     for off in np.ndindex(*shape))
        if box == coords:
            return True
    return False


def box_scan_vs_cpu(topo_action) -> dict:
    """The last batched box scan of ``topo_action`` replayed on its staged
    inputs on the card and on the CPU (ops/topo_solver.box_scan, PyTorch
    tensor code with no kernel of its own): the [N, 6] stats must be
    equal.  Times the card with CUDA events (median of 5 after a warm
    call) and the CPU with the host clock, and reads the card's peak
    memory above the inputs for one scan."""
    from kube_batch_tpu_torch.ops.topo_solver import (box_scan,
                                                      stage_box_inputs)

    host, shape, n = topo_action.last_scan
    if topo_action.device.type != "cuda":
        raise AssertionError("the batched box scan did not run on the card")
    inp = stage_box_inputs(host, "cuda")
    box_scan(inp, *shape)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    card = box_scan(inp, *shape)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        box_scan(inp, *shape)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    cpu_inp = stage_box_inputs(host, "cpu")
    t0 = time.perf_counter()
    cpu = box_scan(cpu_inp, *shape)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((card.cpu().long() - cpu.long()).abs().max())
    if card.shape != cpu.shape or card.dtype != cpu.dtype or err:
        raise AssertionError(f"box scan on the card != the CPU: max abs err "
                             f"{err}")
    n_pad = int(inp.coords.shape[0])
    return dict(nodes=n, n_pad=n_pad, shape=list(shape),
                result_shape=list(card.shape), max_abs_err=err,
                ms=float(np.median(times)), ms_all=times, plain_ms=plain_ms,
                peak_bytes=int(peak), pairwise_int32_bytes=n_pad * n_pad * 12,
                complete_origins=int((cpu[:n, 0] == 1).sum()))


def topo_phase(cuda_solver, card) -> int:
    """Topology-aware slice placement at the engine's node ceiling: the
    reference's topology conf (topo-allocate, tpu-allocate, backfill with
    the topology plugin) on make_topo_cache(dims=(16, 16, 16),
    slice_shape="4x4x4") — 4,096 single-accelerator hosts, a checkerboard
    of 2,048 low-priority Running fillers (free capacity everywhere, no
    free box) and one high-priority 64-task slice gang — in three arms:
    defrag batched, defrag with KUBE_BATCH_TPU_TOPO_BATCH=0 (the numpy
    oracle) and capacity-only (TOPO_DEFRAG=0) batched.  The batched and
    oracle arms must give the same binds and the same evictions in order;
    in the defrag arms the 64 slice tasks bind to one axis-aligned 4x4x4
    box in cycle 2; in the capacity arm the slice stays pending.  The last
    batched box scan is replayed on the card and the CPU (equal).  Returns
    the session kernel's launches of the cell."""
    arms = {}
    launches = 0
    for name, defrag, batch in (("defrag-batched", True, True),
                                ("defrag-oracle", True, False),
                                ("capacity-batched", False, True)):
        out = topo_arm(cuda_solver, "cuda", defrag, batch)
        arms[name] = out
        for i, cyc in enumerate(out["cycles"]):
            launches += cyc["launches"]
            phase("topo-cycle", arm=name, cycle=i + 1,
                  action_ms=cyc["action_ms"], box_scans=cyc["box_scans"],
                  tpu_allocate=cyc["tpu_allocate"],
                  launches=cyc["launches"], vs_plain=cyc["vs_plain"],
                  frag_bonus_rows=cyc["frag_bonus_rows"])
        phase("topo-arm", arm=name, build_s=out["build_s"],
              evictions=len(out["evicts"]), slice_binds=len(out["slice_hosts"]),
              binds=len(out["binds"]), frag_after_cycle_1=out["frag_after"],
              box_scans=[c["box_scans"] for c in out["cycles"]])
    batched, oracle = arms["defrag-batched"], arms["defrag-oracle"]
    KEPT["topo"] = oracle
    for key in ("binds", "evicts", "frag_after", "statuses"):
        if batched[key] != oracle[key]:
            raise AssertionError(f"topo: the batched arm's {key} differ from "
                                 f"the numpy oracle's")
    vol = int(np.prod([int(v) for v in TOPO_SLICE.split("x")]))
    shape = tuple(int(v) for v in TOPO_SLICE.split("x"))
    for name in ("defrag-batched", "defrag-oracle"):
        hosts = arms[name]["slice_hosts"]
        if len(hosts) != vol or not is_box(hosts, TOPO_DIMS, shape):
            raise AssertionError(f"topo {name}: the slice bound to {hosts[:8]}"
                                 f"..., not one {TOPO_SLICE} box")
        if not arms[name]["evicts"]:
            raise AssertionError(f"topo {name}: nothing was evicted")
    if arms["capacity-batched"]["slice_hosts"]:
        raise AssertionError("topo capacity arm: the slice bound")
    if any(c["box_scans"] != 1 for c in batched["cycles"]) \
            or any(c["box_scans"] for c in oracle["cycles"]):
        raise AssertionError("topo: not one box scan per batched session")
    scan = box_scan_vs_cpu(batched["topo_action"])
    phase("topo", dims=list(TOPO_DIMS), slice=TOPO_SLICE,
          nodes=int(np.prod(TOPO_DIMS)), conf="TOPO_CONF (bench.py)",
          identical_batched_and_oracle=True, slice_box=True,
          capacity_arm_pending=True,
          evictions=len(batched["evicts"]),
          action_ms={name: [c["action_ms"] for c in out["cycles"]]
                     for name, out in arms.items()},
          frag_after_cycle_1={name: out["frag_after"]
                              for name, out in arms.items()},
          box_scan=scan, kernel_launches=launches, card=card)
    return launches


def topo_vs_cpu_phase(cuda_solver) -> None:
    """The topology scenario at 4x4x2 (2x2x2 slice) on the card and on the
    CPU in the three arms: the same binds, evictions in order,
    fragmentation stats and pod-group statuses."""
    for name, defrag, batch in (("defrag-batched", True, True),
                                ("defrag-oracle", True, False),
                                ("capacity-batched", False, True)):
        out = {d: topo_arm(cuda_solver, d, defrag, batch, dims=(4, 4, 2),
                           slice_shape="2x2x2") for d in ("cuda", "cpu")}
        for key in ("binds", "evicts", "frag_after", "statuses"):
            if out["cuda"][key] != out["cpu"][key]:
                raise AssertionError(f"topo at 4x4x2 ({name}): the card's "
                                     f"{key} differ from the CPU's")
        phase("topo-vs-cpu", dims=[4, 4, 2], arm=name,
              evictions=len(out["cuda"]["evicts"]),
              slice_binds=len(out["cuda"]["slice_hosts"]), identical=True)



# ---- the Scheduler loop, tenancy and the shard pipeline -------------------

def _same_solve(a, b) -> int:
    """Max absolute difference between two fetched solves (assignment,
    kind, order, ordered); raises on any shape difference."""
    worst = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise AssertionError(f"fetched shapes differ: {x.shape} "
                                 f"!= {y.shape}")
        if x.size:
            worst = max(worst, int(np.max(np.abs(
                x.astype(np.int64) - y.astype(np.int64)))))
    return worst


def tenancy_streams_phase(cuda_solver, card) -> int:
    """The device half of the shard pipeline alone: two owners' resident
    shippers, each owner with its own CUDA stream (as a TenancyEngine
    gives its shard views), at the north-star shape
    (make_synthetic_inputs seeds 0 and 1).  Each owner first ships and
    solves alone on its stream (the reference results, fetched one after
    the other); seed 1's solo launch is held against the plain version
    on its shipped inputs.  Then, in turns (back to back, in flight, in
    flight, back to back), both resident images are dropped and each
    pair runs: back to back ships, dispatches and fetches A, then B; in
    flight ships and dispatches A, then ships and dispatches B, and only
    then fetches both.  In flight, B's ship and dispatch must return to
    the host while A's ready event is still pending (the successor's
    ship does not wait on the predecessor's kernel), and every fetched
    result must equal its owner's solo result exactly.  Prints the
    pair's wall times and each dispatch's CUDA-event time (buffer build,
    kernel, packing).  Returns the kernel launches of the solo and pair
    runs."""
    from kube_batch_tpu_torch.models.shipping import resident_shipper
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
    from kube_batch_tpu_torch.ops.solver import dispatch_solve, fetch_solve
    from kube_batch_tpu_torch.tenancy.engine import assign_shard_streams

    class Owner:
        pass

    owners = [Owner(), Owner()]
    assign_shard_streams(owners, "cuda")
    staged = [make_synthetic_inputs(*NORTH_STAR, seed=seed,
                                    dtype=torch.float32)
              for seed in (0, 1)]
    shippers = [resident_shipper(o, "cuda") for o in owners]
    streams = [o.stream for o in owners]
    handles = [st.cuda_stream for st in streams]
    if len(set(handles)) != 2:
        raise AssertionError(f"two owners share a stream: {handles}")
    cuda_solver.solve_allocate_cuda.launches = 0
    solo = []
    for sh, st, (inp, cfg) in zip(shippers, streams, staged):
        with torch.cuda.stream(st):
            solo.append(fetch_solve(dispatch_solve(sh.ship(inp, cfg), cfg)))
    wait_device("the solo launches")
    solo_launches = cuda_solver.solve_allocate_cuda.launches
    # Each solo launch against the plain version, on its owner's stream
    # over its owner's resident image (a clean ship returns it as is).
    # A solo launch on inputs byte-equal to a launch already held in
    # this run (seed 0: the main path's full ship) is compared with that
    # launch's outputs byte for byte (LaunchLedger).
    for seed, (sh, st, (inp, cfg), got) in enumerate(zip(
            shippers, streams, staged, solo)):
        with torch.cuda.stream(st):
            phase("tenancy-streams-vs-plain", seed=seed,
                  **LaunchLedger.hold_one(
                      cuda_solver, sh.ship(inp, cfg), cfg, got[:3],
                      f"the solo launch of seed {seed}"))

    def pair(together: bool) -> dict:
        for sh in shippers:
            sh.invalidate()          # each ship of the pair is a full one
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in owners]
        fetched, pending = [None, None], [None, None]
        pending_at_b = None
        t0 = time.perf_counter()
        for i, (sh, st, (inp, cfg)) in enumerate(zip(shippers, streams,
                                                      staged)):
            with torch.cuda.stream(st):
                shipped = sh.ship(inp, cfg)
                events[i][0].record()
                pending[i] = dispatch_solve(shipped, cfg)
                events[i][1].record()
            if i == 1:
                pending_at_b = not pending[0].ready.query()
            if not together:
                fetched[i] = fetch_solve(pending[i])
        if together:
            fetched = [fetch_solve(p) for p in pending]
        wall_ms = (time.perf_counter() - t0) * 1e3
        wait_device("the pair of launches")
        err = max(_same_solve(f, s) for f, s in zip(fetched, solo))
        if err:
            raise AssertionError(f"a shard-stream solve differs from its "
                                 f"solo launch: max abs err {err}")
        return dict(wall_ms=wall_ms, max_abs_err=err,
                    a_pending_when_b_returned=pending_at_b,
                    dispatch_ms=[a.elapsed_time(b) for a, b in events])

    cuda_solver.solve_allocate_cuda.launches = 0
    cuda_solver.solve_allocate_cuda.stream_launches = {}
    runs = [(together, pair(together))
            for together in (False, True, True, False)]
    launches = cuda_solver.solve_allocate_cuda.launches
    tally = cuda_solver.solve_allocate_cuda.stream_launches
    for together, run in runs:
        phase("tenancy-streams-run", in_flight=together, **run)
    if launches != 2 * len(runs) or tally != {h: len(runs) for h in handles}:
        raise AssertionError(f"{launches} launches on streams {tally}, "
                             f"expected {len(runs)} on each of {handles}")
    if not all(run["a_pending_when_b_returned"]
               for together, run in runs if together):
        raise AssertionError("B's ship and dispatch waited for A's kernel: "
                             "the two streams serialized")
    walls = {name: [run["wall_ms"] for t, run in runs if t == together]
             for name, together in (("back_to_back", False),
                                    ("in_flight", True))}
    phase("tenancy-streams", shape=list(NORTH_STAR), seeds=[0, 1],
          streams=handles, launches=solo_launches + launches, max_abs_err=0,
          b_returned_while_a_pending=True,
          pair_wall_ms_back_to_back=walls["back_to_back"],
          pair_wall_ms_in_flight=walls["in_flight"],
          pair_wall_ms_median={k: float(np.median(v))
                               for k, v in walls.items()},
          dispatch_ms=[run["dispatch_ms"] for _, run in runs], card=card)
    return solo_launches + launches


TENANCY_SHAPE = dict(n_tasks=50_000, n_nodes=10_000, n_queues=4)


class _BeginProbe:
    """Around ShardPipeline._begin (measurement only): counts the begin
    halves that returned while a predecessor in flight still had its
    solve's ready event pending on the card, and keeps, per begin half,
    its shard, its host-clock ms and a pair of CUDA events recorded on
    the view's stream just before and just after it.  The stream is idle
    when the first is recorded, so their elapsed time runs from the
    begin half's start to the end of the device work it queued (ship,
    candidate gather, kernel, packing, readback); less the host ms, it
    is the device tail left when the begin half returned.  Recording an
    event does not wait."""

    def __init__(self, pipeline_cls):
        self.cls = pipeline_cls
        self.real = pipeline_cls._begin
        self.reset()

    def reset(self) -> None:
        self.begins = 0
        self.with_pending_predecessor = 0
        self.samples = []   # (shard, host ms, start event, end event)

    def __enter__(self):
        probe = self

        def _begin(pipeline, shard):
            preds = [getattr(s.handle.cont, "pending", None)
                     for s in pipeline._inflight]
            stream = pipeline.engine.views[shard].stream
            start = end = None
            if stream is not None:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            t0 = time.perf_counter()
            stage = probe.real(pipeline, shard)
            host_ms = (time.perf_counter() - t0) * 1e3
            if stream is not None:
                end.record(stream)
            probe.begins += 1
            probe.samples.append((shard, host_ms, start, end))
            if any(p is not None and p.ready is not None
                   and not p.ready.query() for p in preds):
                probe.with_pending_predecessor += 1
            return stage

        self.cls._begin = _begin
        return self

    def __exit__(self, *exc):
        self.cls._begin = self.real

    def timings(self) -> list:
        """Per begin half: [shard, host ms, ms from its start to the end
        of its device work] (None on the CPU).  Read after the card is
        idle."""
        return [[shard, host_ms,
                 start.elapsed_time(end) if start is not None else None]
                for shard, host_ms, start, end in self.samples]


def tenancy_arm(cuda_solver, concurrent: bool, device="cuda", *,
                n_tasks, n_nodes, n_queues, rounds=4,
                churn_frac=0.05, gangs=None, chaos=None) -> dict:
    """bench.py's _tenancy_storm_arm through the port: ``n_queues``
    tenants on disjoint node-selector pools of 16 CPU / 64 GiB nodes,
    KUBE_BATCH_TPU_TENANCY=n_queues with each queue pinned to its own
    shard, every tenant submitting one gang of n_tasks * churn_frac /
    n_queues pods (or ``gangs[tenant]`` pods; minMember 4/5 of it) per
    round and gangs two rounds old retired, through a real Scheduler and
    TenancyEngine on ``device`` with KUBE_BATCH_TPU_CONCURRENT_SHARDS
    toggled.  One warm pass, then ``rounds`` rounds, under the
    production GC posture.  Every round must end with no shard backing
    off and no session on the host fallback.  Every tpu-allocate
    dispatch after the warm pass (on the card, a launch) is captured
    when its finish runs (capture_launch, on the view's stream) and,
    after the last round, held against the plain version
    (record_vs_plain).  Returns
    the parity material (per-round bind fingerprints, the events after
    the warm pass, the lineage bind samples), the round walls, the
    pipeline counters, the kernel's launches by stream, the begin
    halves' timings and the records held against the plain version.
    ``chaos`` (a FaultPlan, the degrade-shard drill's) is installed for
    the warm pass alone: a shard session it fails raises on the card
    (no host path there), that shard backs off and is retried at once
    (the drill clears the back-off before each pass), and the shards
    that failed are returned as ``failed_shards``; the measured rounds
    then run without faults and must end with no shard failing."""
    import dataclasses as dc

    from kube_batch_tpu_torch.api import (Container, Node, NodeSpec,
                                          NodeStatus, ObjectMeta, Pod,
                                          PodSpec, PodStatus, pod_key)
    from kube_batch_tpu_torch.api.queue_info import Queue
    from kube_batch_tpu_torch.apis.scheduling import v1alpha1
    from kube_batch_tpu_torch.cache import (FakeBinder, FakeEvictor,
                                            FakeStatusUpdater,
                                            FakeVolumeBinder, SchedulerCache)
    from kube_batch_tpu_torch.cache.cache import _EventDeque
    from kube_batch_tpu_torch.framework import get_action
    from kube_batch_tpu_torch.metrics.metrics import (shard_cycle_stats,
                                                      shard_overlap_total_ms,
                                                      shard_pipeline_counts)
    from kube_batch_tpu_torch.models.shipping import resident_shipper
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.tenancy.pipeline import ShardPipeline
    from kube_batch_tpu_torch.trace.lineage import lineage as pod_lineage

    env = {"KUBE_BATCH_TPU_CONCURRENT_SHARDS": "1" if concurrent else "0",
           "KUBE_BATCH_TPU_TENANCY": str(n_queues),
           "KUBE_BATCH_TPU_SHARD_MAP": "|".join(
               f"q{i}:{i}" for i in range(n_queues))}
    with env_arm(env):
        binder = FakeBinder()
        cache = SchedulerCache(binder=binder, evictor=FakeEvictor(),
                               status_updater=FakeStatusUpdater(),
                               volume_binder=FakeVolumeBinder())
        cache.events = _EventDeque(maxlen=max(200000, 4 * n_tasks + 20000))
        for q in range(n_queues):
            cache.add_queue(Queue(metadata=ObjectMeta(
                name=f"q{q}", creation_timestamp=float(q)), weight=1))
        alloc = {"cpu": "16", "memory": "64Gi", "pods": 110}
        for i in range(n_nodes):
            name = f"n{i:05d}"
            cache.add_node(Node(
                metadata=ObjectMeta(name=name, uid=name,
                                    labels={"pool": f"q{i % n_queues}"}),
                spec=NodeSpec(), status=NodeStatus(
                    allocatable=dict(alloc), capacity=dict(alloc))))
        scheduler = Scheduler(cache, schedule_period=3600, device=device)
        engine = scheduler.tenancy
        if engine is None or (engine.pipeline is not None) != concurrent:
            raise AssertionError("the tenancy engine is not as configured")
        tpu = get_action("tpu-allocate")
        # A host fallback on the card (tensorizer gaps aside, none in
        # this workload) would be a device failure moved to the CPU.
        fallbacks = []
        real_fallback = tpu._run_host_fallback
        tpu._run_host_fallback = lambda ssn, **kw: (
            fallbacks.append((ssn.uid, getattr(ssn.cache, "shard", None))),
            real_fallback(ssn, **kw))
        # Each launch's record, captured when its finish runs (on the
        # view's stream, before the shard's next ship).
        captured, capturing = [], [False]
        real_begin = tpu.execute_begin

        def execute_begin(ssn):
            fin = real_begin(ssn)
            if not capturing[0] or getattr(fin, "pending", None) is None:
                return fin

            def finish():
                fin()
                captured.append(capture_launch(tpu))
            finish.pending = fin.pending
            return finish

        tpu.execute_begin = execute_begin
        # Launches by stream: the count is set to 0 after the warm pass.
        pod_lineage.clear()
        podmap = {}

        def submit_gang(tenant, name, size):
            cache.add_pod_group(v1alpha1.PodGroup(
                metadata=ObjectMeta(name=name, namespace="bench"),
                spec=v1alpha1.PodGroupSpec(min_member=max(1, size * 4 // 5),
                                           queue=f"q{tenant}")))
            keys = []
            for i in range(size):
                uid = f"{name}-{i}"
                pod = Pod(
                    metadata=ObjectMeta(
                        name=uid, namespace="bench", uid=uid,
                        annotations={v1alpha1.GroupNameAnnotationKey: name},
                        creation_timestamp=float(len(podmap))),
                    spec=PodSpec(node_selector={"pool": f"q{tenant}"},
                                 containers=[Container(requests={
                                     "cpu": "500m", "memory": "1Gi"})]),
                    status=PodStatus(phase="Pending"))
                podmap[pod_key(pod)] = pod
                keys.append(pod_key(pod))
                cache.add_pod(pod)
            return keys

        def echo():
            binds = dict(binder.binds)
            binder.binds.clear()
            for key, node in binds.items():
                old = podmap.get(key)
                if old is None:
                    continue
                new = dc.replace(old, spec=dc.replace(old.spec,
                                                      node_name=node),
                                 status=PodStatus(phase="Running"))
                podmap[key] = new
                cache.update_pod(old, new)
            updater = cache.status_updater
            for pg in updater.pod_groups:
                cache.add_pod_group(pg)
            updater.pod_groups.clear()

        failed_shards = set()

        def run_once(faulted=False):
            if faulted:
                engine._next_ok.clear()
            scheduler.run_once()
            if faulted:
                failed_shards.update(engine._failures)
            elif engine._failures:
                raise AssertionError(f"shard sessions failed: "
                                     f"{engine._failures}")
            if fallbacks:
                raise AssertionError(f"{len(fallbacks)} shard sessions "
                                     f"took the host fallback")

        gang = max(4, int(n_tasks * churn_frac) // max(n_queues, 1))
        gangs = tuple(gangs) if gangs is not None else (gang,) * n_queues
        try:
            with gc_posture(), _BeginProbe(ShardPipeline) as probe:
                pipe0 = shard_pipeline_counts()
                faulted = chaos is not None
                if faulted:
                    # The drill's faults hit the warm pass; its launches
                    # are counted and held too.
                    from kube_batch_tpu_torch.chaos import plan as chaos_plan
                    chaos_plan.install(chaos)
                    capturing[0] = True
                    cuda_solver.solve_allocate_cuda.launches = 0
                    cuda_solver.solve_allocate_cuda.stream_launches = {}
                for t in range(n_queues):
                    submit_gang(t, f"warm-{t}", 4)
                run_once(faulted)
                echo()
                run_once(faulted)
                echo()
                if faulted:
                    chaos_plan.disable()
                    engine._next_ok.clear()
                if device == "cuda":
                    torch.cuda.synchronize()
                events_mark = len(cache.events)
                overlap0 = shard_overlap_total_ms()
                warm_launches = 0
                if chaos is None:
                    pipe0 = shard_pipeline_counts()
                    probe.reset()
                    capturing[0] = True
                    cuda_solver.solve_allocate_cuda.launches = 0
                    cuda_solver.solve_allocate_cuda.stream_launches = {}
                else:
                    warm_launches = cuda_solver.solve_allocate_cuda.launches
                retire, walls, fingerprints, launches = [], [], [], []
                overlap_rounds, inflight_hw = [], 1
                for rnd in range(rounds):
                    round_start = time.perf_counter()
                    launched = cuda_solver.solve_allocate_cuda.launches
                    new_keys = []
                    for t in range(n_queues):
                        new_keys.extend(submit_gang(t, f"storm-{rnd}-t{t}",
                                                    gangs[t]))
                    if len(retire) >= 2:
                        for key in retire.pop(0):
                            pod = podmap.pop(key, None)
                            if pod is not None:
                                cache.delete_pod(pod)
                    o0 = shard_overlap_total_ms()
                    run_once()
                    overlap_rounds.append(shard_overlap_total_ms() - o0)
                    if concurrent:
                        inflight_hw = max(inflight_hw,
                                          shard_cycle_stats()[1])
                    fingerprints.append(tuple(sorted(binder.binds.items())))
                    echo()
                    retire.append(new_keys)
                    walls.append((time.perf_counter() - round_start) * 1e3)
                    launches.append(cuda_solver.solve_allocate_cuda.launches
                                    - launched)
                pipe1 = shard_pipeline_counts()
        finally:
            if chaos is not None:
                from kube_batch_tpu_torch.chaos import plan as chaos_plan
                chaos_plan.disable()
            del tpu._run_host_fallback
            del tpu.execute_begin
        if device == "cuda":
            wait_device("the tenancy rounds")
            torch.cuda.synchronize()
        timings = probe.timings()
        held = [record_vs_plain(cuda_solver, rec, "a tenancy shard session")
                for rec in captured]
        if device == "cuda" and len(held) != sum(launches) + warm_launches:
            raise AssertionError(f"{len(held)} of {sum(launches)} tenancy "
                                 f"launches held against the plain version")
        views = {v.stream: v.shard for v in engine.views}
        by_shard = {}
        for handle, n in cuda_solver.solve_allocate_cuda.stream_launches \
                .items():
            shard = next((s for stream, s in views.items()
                          if stream is not None
                          and stream.cuda_stream == handle), None)
            by_shard.setdefault(shard, []).append((handle, n))
        if len(cache.events) >= cache.events.maxlen:
            raise AssertionError("the event ring overflowed")
        samples = sorted(p["pod"] for p in pod_lineage.dump()["pods"]
                         if p.get("bound"))
        return dict(
            fingerprints=fingerprints,
            events=list(cache.events)[events_mark:], samples=samples,
            walls_ms=walls, launches=launches, gangs=list(gangs),
            overlap_ms_rounds=overlap_rounds,
            overlap_ms_total=shard_overlap_total_ms() - overlap0,
            inflight=inflight_hw,
            pipeline={k: pipe1.get(k, 0) - pipe0.get(k, 0)
                      for k in set(pipe0) | set(pipe1)},
            launches_by_shard=by_shard,
            begins=probe.begins,
            begins_with_pending_predecessor=probe.with_pending_predecessor,
            begin_timings=timings, held=held,
            failed_shards=sorted(failed_shards),
            failures=dict(engine._failures), warm_launches=warm_launches)


def tenancy_phase(cuda_solver, card, device="cuda",
                  shape=TENANCY_SHAPE, rounds=2,
                  arms=(False, True)) -> int:
    """The reference's concurrent-shard A/B through a real Scheduler and
    TenancyEngine at the north star's cluster size (tenancy_arm), one
    arm per entry of ``arms`` (CONCURRENT_SHARDS off, on; the reference
    runs off/on/on/off) on fresh caches.  Every round's binds, the event
    stream and the lineage bind samples must be equal across the arms; the concurrent arms must have pipelined (stages
    overlapped, overlap time above 0, two in flight at once); every
    shard's launches must have gone to its own view's stream, a distinct
    stream per shard.  Prints per arm the round walls (median,
    nearest-rank p90), shard sessions per second, launches per round and
    the begin halves that returned while a predecessor's solve was still
    pending on the card, and every launch's record held against the
    plain version (tenancy_arm).  Returns the launches of the arms."""
    runs = []
    for concurrent in arms:
        out = tenancy_arm(cuda_solver, concurrent, device, rounds=rounds,
                          **shape)
        runs.append((concurrent, out))
        walls = sorted(out["walls_ms"])
        phase("tenancy-arm", concurrent=concurrent, gangs=out["gangs"],
              walls_ms=out["walls_ms"],
              wall_ms_median=float(np.median(walls)),
              wall_ms_p90=walls[max(0, math.ceil(0.9 * len(walls)) - 1)],
              sessions_per_s=(len(walls) * shape["n_queues"]
                              / (sum(walls) / 1e3)),
              launches_per_round=out["launches"],
              launches_by_shard={str(k): v for k, v in
                                 out["launches_by_shard"].items()},
              overlap_ms_rounds=out["overlap_ms_rounds"],
              overlap_ms_total=out["overlap_ms_total"],
              inflight_high_water=out["inflight"], pipeline=out["pipeline"],
              begins=out["begins"],
              begins_with_pending_predecessor=out[
                  "begins_with_pending_predecessor"],
              binds=sum(len(f) for f in out["fingerprints"]),
              begin_timings=out["begin_timings"],
              vs_plain=held_summary(out["held"]))
    base = runs[0][1]
    if not base["fingerprints"][-1]:
        raise AssertionError("the tenancy cell bound nothing")
    for concurrent, out in runs[1:]:
        for key in ("fingerprints", "events", "samples"):
            if out[key] != base[key]:
                raise AssertionError(f"tenancy arms differ in {key} "
                                     f"(concurrent={concurrent})")
    shards = set(range(shape["n_queues"]))
    for concurrent, out in runs:
        by_shard = out["launches_by_shard"]
        handles = [h for v in by_shard.values() for h, _ in v]
        if device == "cuda" and (
                None in by_shard or set(by_shard) != shards
                or len(handles) != len(shards)
                or len(set(handles)) != len(handles)):
            raise AssertionError(f"launches not each on its shard's own "
                                 f"stream: {by_shard}")
        if concurrent and not (out["pipeline"].get("overlapped", 0) > 0
                               and out["overlap_ms_total"] > 0
                               and out["inflight"] >= 2):
            raise AssertionError(f"the concurrent arm did not pipeline: "
                                 f"{out['pipeline']}, "
                                 f"{out['overlap_ms_total']} ms, "
                                 f"in flight {out['inflight']}")
    launches = sum(sum(out["launches"]) for _, out in runs)
    phase("tenancy", nodes=shape["n_nodes"], tenants=shape["n_queues"],
          n_tasks=shape["n_tasks"], gangs=base["gangs"],
          rounds=len(base["walls_ms"]), identical_arms=True,
          binds_per_round=[len(f) for f in base["fingerprints"]],
          events=len(base["events"]), lineage_samples=len(base["samples"]),
          kernel_launches=launches,
          held_against_plain=sum(len(out["held"]) for _, out in runs),
          held_byte_equal=sum(r["held"] == "byte_equal"
                              for _, out in runs for r in out["held"]),
          card=card)
    return launches


TENANCY_BACKLOGS = (10_000, 30_000)


def tenancy_backlog_phase(cuda_solver, card, device="cuda",
                          shape=TENANCY_SHAPE,
                          backlogs=TENANCY_BACKLOGS) -> int:
    """Where a shard's solve outlasts the next shard's begin half: the
    tenancy protocol's concurrent arm (tenancy_arm) with tenant 0
    submitting one gang of B pods and the other tenants 4 pods each, one
    round after the warm pass, for each B in ``backlogs``.  Shard 1's
    begin half then runs while shard 0's B-pod solve is on the card.
    Prints per B shard 0's begin host ms and its device tail (the ms its
    device work, the kernel included, ran on after its begin half
    returned), shard 1's begin host ms, and whether shard 1's begin
    returned while shard 0's ready event was pending: it should exactly
    when the tail outlasts shard 1's begin half.
    Every launch is held against the plain version (tenancy_arm); the
    arm must bind shard 0's gang.  Returns the launches."""
    launches = 0
    for backlog in backlogs:
        gangs = (backlog,) + (4,) * (shape["n_queues"] - 1)
        out = tenancy_arm(cuda_solver, True, device, rounds=1, gangs=gangs,
                          **shape)
        timings = out["begin_timings"]
        first = {shard: (host, end) for shard, host, end in reversed(timings)}
        host0, end0 = first.get(0, (None, None))
        binds = len(out["fingerprints"][0])
        if binds < backlog * 4 // 5:
            raise AssertionError(f"the backlog arm at {backlog} pods bound "
                                 f"{binds}")
        launches += sum(out["launches"])
        phase("tenancy-backlog", backlog=backlog, gangs=list(gangs),
              binds=binds, wall_ms=out["walls_ms"][0],
              shard0_begin_host_ms=host0,
              shard0_device_tail_ms=(end0 - host0 if end0 is not None
                                     else None),
              shard1_begin_host_ms=first.get(1, (None, None))[0],
              begins=out["begins"],
              begins_with_pending_predecessor=out[
                  "begins_with_pending_predecessor"],
              begin_timings=timings, launches=sum(out["launches"]),
              vs_plain=held_summary(out["held"]), card=card)
    return launches


def scheduler_loop_phase(cuda_solver, card, device="cuda",
                         shape=(5_000, 1_000, 100, 4)) -> int:
    """Scheduler(cache).run() on ``device`` over make_synthetic_cache(
    *shape): the loop thread's first cycle must bind with the session
    kernel launched from that thread; a churned pod (one new one-pod
    gang) must wake the loop, sleeping in a 30 s schedule period, and
    bind; stop() must return within 5 s with the thread gone.  Every wait
    is bounded: a loop that does not bind in time leaves the process at
    once with exit code 3, as wait_device does.  On the card each cycle
    that solved on the device has its tpu-allocate record captured on the
    loop thread when the cycle ends (capture_launch), and every one is
    held against the plain version after stop().  Returns the launches
    the loop made."""
    import gc
    import threading

    from kube_batch_tpu_torch.api import (Container, ObjectMeta, Pod,
                                          PodSpec, PodStatus)
    from kube_batch_tpu_torch.apis.scheduling import v1alpha1
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_cache
    from kube_batch_tpu_torch.ops import solver
    from kube_batch_tpu_torch.scheduler import Scheduler

    def wait_for(what, pred, seconds):
        deadline = time.monotonic() + seconds
        while not pred():
            if time.monotonic() > deadline:
                print(f"chip_smoke: {what} did not happen in {seconds} s",
                      file=sys.stderr, flush=True)
                os._exit(3)
            time.sleep(0.01)
        return time.monotonic()

    cache, binder = make_synthetic_cache(*shape)
    sched = Scheduler(cache, schedule_period=30.0, device=device)
    tpu = next(a for a in sched.actions if a.name() == "tpu-allocate")
    cycles = []   # (end on the monotonic clock, binds so far) per cycle
    captured = []
    real_run_once = sched.run_once

    def counted_run_once():
        before = tpu.last
        real_run_once()
        if tpu.last is not before and tpu.last is not None \
                and not tpu.last.reused:
            captured.append(capture_launch(tpu))
        cycles.append((time.monotonic(), len(binder.binds)))

    sched.run_once = counted_run_once
    launch_threads = []
    real = solver.solve_on_route

    def traced(inp, cfg):
        launch_threads.append(threading.get_ident())
        return real(inp, cfg)

    solver.solve_on_route = traced
    cuda_solver.solve_allocate_cuda.launches = 0
    try:
        t0 = time.monotonic()
        sched.run()
        loop_ident = sched._thread.ident
        wait_for("the loop's first cycle", lambda: cycles, 300)
        first, first_binds = cycles[0]
        if not first_binds:
            raise AssertionError("the loop's first cycle bound nothing")
        # The group's own churn wakes the loop once; the pod below must
        # find it asleep again, in its 30 s schedule period.
        cache.add_pod_group(v1alpha1.PodGroup(
            metadata=ObjectMeta(name="churn", namespace="bench"),
            spec=v1alpha1.PodGroupSpec(min_member=1, queue="q0")))
        wait_for("the group's wake cycle", lambda: len(cycles) >= 2, 120)
        time.sleep(0.5)
        asleep = len(cycles)
        t1 = time.monotonic()
        cache.add_pod(Pod(
            metadata=ObjectMeta(
                name="churn-0", namespace="bench", uid="churn-0",
                annotations={v1alpha1.GroupNameAnnotationKey: "churn"},
                creation_timestamp=1e9),
            spec=PodSpec(containers=[Container(
                requests={"cpu": "100m", "memory": "64Mi"})]),
            status=PodStatus(phase="Pending")))
        woke = wait_for("the churn bind",
                        lambda: "bench/churn-0" in binder.binds, 25)
        # The bind lands inside run_once; the cycle that made it is
        # counted when run_once returns.
        wait_for("the waking cycle's end", lambda: len(cycles) > asleep, 25)
        t2 = time.monotonic()
        sched.stop(timeout=5.0)
        stop_s = time.monotonic() - t2
    finally:
        solver.solve_on_route = real
        gc.unfreeze()
    launches = cuda_solver.solve_allocate_cuda.launches
    if sched._thread.is_alive() or stop_s > 5.0:
        raise AssertionError(f"stop() took {stop_s:.2f} s")
    if not launch_threads or set(launch_threads) != {loop_ident} \
            or (device == "cuda" and launches != len(launch_threads)):
        raise AssertionError(f"the kernel was not launched from the loop "
                             f"thread alone: {len(launch_threads)} solves "
                             f"({launches} launches)")
    if sched._consecutive_failures:
        raise AssertionError("a loop cycle failed")
    held = [record_vs_plain(cuda_solver, rec, "a loop cycle")
            for rec in captured]
    if device == "cuda" and len(held) != launches:
        raise AssertionError(f"{len(held)} of the loop's {launches} launches "
                             f"held against the plain version")
    phase("scheduler-loop", shape=list(shape), device=device,
          first_cycle_s=first - t0, first_cycle_binds=first_binds,
          cycles=len(cycles),
          churn_bind_s=woke - t1, stop_s=stop_s, launches=launches,
          binds=len(binder.binds), vs_plain=held_summary(held), card=card)
    return launches


# ---- the fused one-dispatch program (ops/fused_solver.py) -----------------

FUSED_SWALLOW_SITES = ("fused_stage_alloc", "fused_stage_storm",
                       "fused_storm_prove", "fused_topo_scanner",
                       "topo_box_scan")


class LaunchLedger:
    """Every solve of the session kernel's route inside the block, held
    against the plain version on its own inputs.  On the card the
    wrapper around ``solve_allocate_cuda`` (measurement only) clones the
    launch's inputs on the launch's stream right after it
    (stream-ordered: a later ship that rewrites the resident leaves runs
    after the clone) and brackets the call with two CUDA events (buffer
    build and kernel); on the CPU, where the route is the plain version
    itself, it wraps ``solve_allocate_plain`` the same way, so a
    rehearsal captures every solve.  ``hold`` runs the plain version on
    each record's inputs — or, where the inputs are byte-equal to a
    record already held in this run (``HELD``, across phases), compares
    the outputs byte for byte.  ``counts`` says how many were held each
    way."""

    HELD = {}                       # digest -> (assignment, kind, order)
    counts = {"plain": 0, "byte_equal": 0}

    @staticmethod
    def digest(inputs, cfg) -> str:
        """Identity of a solve's staged inputs: the config and every
        leaf's dtype, shape and bytes."""
        import hashlib
        h = hashlib.blake2b(repr(cfg).encode(), digest_size=20)
        for t in inputs:
            a = t.cpu().numpy()
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())
        return h.hexdigest()

    @classmethod
    def note_held(cls, inputs, cfg, out) -> None:
        """Record a solve held against the plain version elsewhere (its
        numpy assignment, kind and order)."""
        cls.HELD[cls.digest(inputs, cfg)] = tuple(
            np.asarray(a, np.int64) for a in out)

    @classmethod
    def hold_one(cls, cuda_solver, inputs, cfg, got, where: str,
                 plain=None, remap=None) -> dict:
        """One fetched or launched solve ``got`` (numpy assignment, kind,
        order; the assignment in full-space rows when ``remap`` maps the
        gathered ``inputs`` back) held: byte for byte against a held
        solve on byte-equal inputs, else against the plain version
        (``plain`` a namespace with ``solve_allocate_plain``, by default
        ``cuda_solver``), then recorded.  Raises on any difference."""
        digest = cls.digest(inputs, cfg)
        if remap is not None:
            digest += np.asarray(remap).tobytes().hex()
        got = tuple(np.asarray(a, np.int64) for a in got)
        placed = int((got[1] > 0).sum())
        seen = cls.HELD.get(digest)
        if seen is not None:
            if any(a.tobytes() != b.tobytes() for a, b in zip(got, seen)):
                raise AssertionError(f"{where} differs from a solve on "
                                     f"byte-equal inputs")
            cls.counts["byte_equal"] += 1
            return dict(held="byte_equal", placed=placed, max_abs_err=0)
        out = solve_vs_plain(plain or cuda_solver, inputs, cfg, got, remap,
                             where=where)
        cls.HELD[digest] = got
        cls.counts["plain"] += 1
        return dict(held="plain", **out)

    def __init__(self, cuda_solver, device="cuda"):
        self.cs = cuda_solver
        self.card = device == "cuda"
        self.name = ("solve_allocate_cuda" if self.card
                     else "solve_allocate_plain")
        self.real = getattr(cuda_solver, self.name)
        self.plain = cuda_solver.solve_allocate_plain
        self.records = []

    def __enter__(self):
        ledger, real, card = self, self.real, self.card

        def launch(inp, cfg, **kw):
            events = None
            if card:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            res, final = real(inp, cfg, **kw)
            if card:
                events[1].record()
            ledger.records.append(dict(
                inputs=type(inp)(*(t.clone() for t in inp)), cfg=cfg,
                out=(res.assignment, res.kind, res.order), events=events))
            return res, final

        # The wrapped function counts its launches on the module's name,
        # which is the wrapper inside the block.
        for attr in ("launches", "stream_launches"):
            if hasattr(real, attr):
                setattr(launch, attr, getattr(real, attr))
        self.wrapper = launch
        setattr(self.cs, self.name, launch)
        return self

    def __exit__(self, *exc):
        setattr(self.cs, self.name, self.real)
        for attr in ("launches", "stream_launches"):
            if hasattr(self.wrapper, attr):
                setattr(self.real, attr, getattr(self.wrapper, attr))

    def take(self) -> list:
        """The records so far, emptied."""
        out, self.records = self.records, []
        return out

    @staticmethod
    def launch_ms(rec):
        """The record's CUDA-event ms (None on the CPU)."""
        if rec["events"] is None:
            return None
        start, stop = rec["events"]
        stop.synchronize()
        return start.elapsed_time(stop)

    def hold(self, records, where: str) -> dict:
        """Hold ``records`` (see the class, ``hold_one``): raises on any
        difference.  Returns how many were held each way and the plain
        versions' times."""
        import types
        if records and self.card:
            torch.cuda.synchronize()
        plain = types.SimpleNamespace(solve_allocate_plain=self.plain)
        plain_ms, by = [], {"plain": 0, "byte_equal": 0}
        for i, rec in enumerate(records):
            out = self.hold_one(
                self.cs, rec["inputs"], rec["cfg"],
                tuple(t.cpu().numpy() for t in rec["out"]),
                f"launch {i} in {where}", plain=plain)
            by[out["held"]] += 1
            if "plain_ms" in out:
                plain_ms.append(out["plain_ms"])
        return dict(held=by, plain_ms=plain_ms, max_abs_err=0)


def fused_counters() -> dict:
    """The session-dispatch, fused-leg and fused-route counters, and the
    counters that a device path which fell back would move: fused legs
    failed, device failures at any stage (the breaker's feed: tensorize,
    solve, evict_solve, fused, topo), solves over the deadline, swallowed
    exceptions at the fused staging sites and at the box scan, and
    sessions a tensorizer limit sent to the host path."""
    from kube_batch_tpu_torch.metrics import metrics as m
    return dict(
        dispatches=m.session_dispatch_counts(), legs=m.fused_leg_counts(),
        routes={k: v for k, v in m.route_counts().items()
                if k.startswith("fused/")},
        fallback=dict(
            legs_failed=sum(v for k, v in m.fused_leg_counts().items()
                            if k.endswith("/failed")),
            device_failures=int(sum(
                v for labels, v in m.device_solve_failures.values().items()
                if labels)),
            deadline_overruns=int(m.solve_deadline_exceeded.value()),
            swallowed=int(sum(
                v for labels, v in m.swallowed_exceptions.values().items()
                if labels and labels[0] in FUSED_SWALLOW_SITES)),
            tensorize_limits=sum(m.tensorize_limit_counts().values())))


def counters_delta(before: dict, after: dict) -> dict:
    def delta(a, b):
        return {k: b[k] - a.get(k, 0) for k in sorted(b)
                if b[k] - a.get(k, 0)}
    return {key: delta(before[key], after[key]) for key in before}


def check_no_fallback(delta: dict, where: str) -> None:
    """Raise unless ``delta`` (counters_delta of fused_counters) moved
    no fallback counter and the device breaker is closed."""
    from kube_batch_tpu_torch.chaos.breaker import device_breaker
    state = device_breaker().state()
    if delta["fallback"] or state != "closed":
        raise AssertionError(f"{where}: a device path fell back: "
                             f"{delta['fallback']}, breaker {state}")


def guarded(run, *args, where=None, **kw):
    """Run one phase with the fallback counters read just before and
    just after it (no_fallback_since): a phase that is not a drill must
    leave no device failure, no deadline overrun and a closed breaker."""
    before = fused_counters()
    out = run(*args, **kw)
    no_fallback_since(before, where or run.__name__.replace(
        "_phase", "").replace("_", "-"))
    return out


def no_fallback_since(before: dict, where: str) -> None:
    check_no_fallback(counters_delta(before, fused_counters()), where)
    phase("no-fallback", where=where, device_failures=0,
          deadline_overruns=0, tensorize_limits=0, breaker="closed")


def stamped_session(cache, actions, tiers) -> dict:
    """One session of ``actions`` with the conf's ladder stamped on it as
    Scheduler.session_once stamps it (the fused dispatcher keys on it),
    nothing synchronized between actions: each action's host-clock ms,
    the wall ms, the end state (task, status, node), the counter deltas
    (fused_counters).  Raises if the tasks that stay on a node end over
    its allocatable."""
    from kube_batch_tpu_torch.framework import close_session, open_session
    before = fused_counters()
    began = time.perf_counter()
    ssn = open_session(cache, tiers)
    ssn._conf_actions = tuple(a.name() for a in actions)
    action_ms = {}
    try:
        for a in actions:
            t0 = time.perf_counter()
            a.execute(ssn)
            action_ms[a.name()] = (time.perf_counter() - t0) * 1e3
        state = sorted((t.uid, t.status.name, t.node_name)
                       for job in ssn.jobs.values()
                       for t in job.tasks.values())
        over = [name for name, node in ssn.nodes.items()
                if over_committed(node)]
    finally:
        close_session(ssn)
    wall_ms = (time.perf_counter() - began) * 1e3
    if over:
        raise AssertionError(f"{len(over)} nodes over their allocatable "
                             f"after a fused session, e.g. {over[:3]}")
    return dict(action_ms=action_ms, wall_ms=wall_ms, state=state,
                delta=counters_delta(before, fused_counters()))


def fused_arm(on: bool, storm=None):
    env = {"KUBE_BATCH_TPU_FUSED": "1" if on else "0"}
    if storm is not None:
        env["KUBE_BATCH_TPU_FUSED_STORM"] = "1" if storm else "0"
    return env_arm(env)


class _EnqueueProbe:
    """Around fused_solver.take_evict and ops.solver.fetch_solve
    (measurement only): for each fused enqueue with an alloc leg, whether
    the leg's ready event was still pending when take_evict returned to
    the scanner, and the host ms from that return to tpu-allocate's
    fetch of the leg and of the fetch's wait."""

    def __init__(self):
        from kube_batch_tpu_torch.ops import fused_solver, solver
        self.fs, self.solver = fused_solver, solver
        self.samples = []

    def __enter__(self):
        probe, fs, solver = self, self.fs, self.solver
        real_take, real_fetch = fs.take_evict, solver.fetch_solve
        self._real = (real_take, real_fetch)

        def take_evict(ssn, *args):
            out = real_take(ssn, *args)
            st = getattr(ssn, "_fused_state", None)
            pending = st.alloc_pending if st is not None else None
            if out is not None and pending is not None:
                probe.samples.append(dict(
                    pending=pending, returned=time.perf_counter(),
                    pending_at_return=(pending.ready is not None
                                       and not pending.ready.query())))
            return out

        def fetch_solve(pending):
            t0 = time.perf_counter()
            out = real_fetch(pending)
            for s in probe.samples:
                if s["pending"] is pending:
                    s["enqueue_to_fetch_ms"] = (t0 - s["returned"]) * 1e3
                    s["fetch_wait_ms"] = (time.perf_counter() - t0) * 1e3
            return out

        fs.take_evict, solver.fetch_solve = take_evict, fetch_solve
        return self

    def __exit__(self, *exc):
        self.fs.take_evict, self.solver.fetch_solve = self._real

    def take(self) -> list:
        out = [{k: v for k, v in s.items() if k != "pending"}
               for s in self.samples]
        self.samples = []
        return out


def echo_binds(cache, binder, pods, seen: int) -> list:
    """Every bind since ``seen`` echoed back unchanged (timed_session's
    echo: the pod stays pending, so each session sees the same
    backlog); returns those binds in order."""
    binds = [(key, binder.binds[key]) for key in binder.channel[seen:]]
    for key, _host in binds:
        cache.update_pod(pods[key], pods[key])
    return binds


def fused_quiet_phase(cuda_solver, card, shape=NORTH_STAR,
                      sessions=2, device="cuda") -> int:
    """The quiet half of the fused program: the shipped four-action conf
    on make_synthetic_cache(*shape) (free capacity: the scan finds no
    victims), KUBE_BATCH_TPU_FUSED on and off, ``sessions`` sessions
    (one cold, the rest warm) per arm taking turns, every bind echoed back unchanged
    between sessions (each sees the same backlog), run as the
    KUBE_BATCH_TPU_INCREMENTAL=0 arm so every session solves.  Expects
    per session {"fused": 1} with solve/served 1 against {"evict": 1,
    "solve": 1}; the arms must bind the same pods and end in the same
    state.  Every launch is held against the plain version
    (LaunchLedger).  Prints per session the wall, per-action ms, the
    launch's CUDA-event ms and, in the fused arm, whether the alloc leg
    was still running when take_evict returned (it must be in every warm
    session) and the ms from that return to tpu-allocate's fetch.
    Returns the launches."""
    from kube_batch_tpu_torch.api import pod_key
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_cache
    from kube_batch_tpu_torch.scheduler import load_scheduler_conf

    arms = {}
    with incremental_arm(False), gc_posture():
        _register(device)
        actions, tiers = load_scheduler_conf(shipped_conf())
        for on in (True, False):
            t0 = time.perf_counter()
            cache, binder = make_synthetic_cache(*shape)
            arms[on] = dict(cache=cache, binder=binder,
                            build_s=time.perf_counter() - t0,
                            pods={pod_key(t.pod): t.pod
                                  for job in cache.jobs.values()
                                  for t in job.tasks.values()},
                            runs=[])
        with LaunchLedger(cuda_solver, device) as ledger, \
                _EnqueueProbe() as probe:
            for i in range(sessions):
                for on in ((True, False) if i % 2 == 0 else (False, True)):
                    arm = arms[on]
                    seen = len(arm["binder"].channel)
                    with fused_arm(on):
                        run = stamped_session(arm["cache"], actions, tiers)
                    records = ledger.take()
                    run["launch_ms"] = [LaunchLedger.launch_ms(r)
                                        for r in records]
                    run["records"] = records
                    run["probe"] = probe.take()
                    run["binds"] = echo_binds(arm["cache"], arm["binder"],
                                              arm["pods"], seen)
                    arm["runs"].append(run)
                    delta = run["delta"]
                    check_no_fallback(delta, f"fused-quiet session {i}")
                    phase("fused-quiet-session", fused=on, session=i,
                          cold=i == 0, wall_ms=run["wall_ms"],
                          action_ms=run["action_ms"],
                          launch_ms=run["launch_ms"], binds=len(run["binds"]),
                          dispatches=delta["dispatches"], legs=delta["legs"],
                          routes=delta["routes"], probe=run["probe"])
    launches = 0
    held = {"plain": 0, "byte_equal": 0}
    plain_ms = []
    for on in (True, False):
        for i, run in enumerate(arms[on]["runs"]):
            out = ledger.hold(run["records"],
                              f"fused-quiet session {i} (fused={on})")
            launches += len(run["records"])
            plain_ms += out["plain_ms"]
            for k in held:
                held[k] += out["held"][k]
    ladder = {on: [(r["delta"]["dispatches"], r["delta"]["legs"])
                   for r in arms[on]["runs"]] for on in arms}
    expect = {True: ({"fused": 1}, {"solve/served": 1}),
              False: ({"evict": 1, "solve": 1}, {})}
    for on in arms:
        for i, got in enumerate(ladder[on]):
            if got != expect[on]:
                phase("fused-quiet-ladder", fused=on, session=i,
                      got=list(got), expected=list(expect[on]))
                raise AssertionError(f"fused-quiet session {i} (fused={on}) "
                                     f"dispatched {got}")
    for a, b in zip(arms[True]["runs"], arms[False]["runs"]):
        if a["state"] != b["state"] or dict(a["binds"]) != dict(b["binds"]):
            raise AssertionError("fused-quiet: the arms' binds or end state "
                                 "differ")
        if not a["binds"]:
            raise AssertionError("fused-quiet: a session bound nothing")
    KEPT["fused_quiet"] = dict(arm=arms[True], actions=actions,
                               tiers=tiers,
                               control=arms[False]["runs"][-1])
    probes = [p for r in arms[True]["runs"] for p in r["probe"]]
    if len(probes) != sessions or (device == "cuda" and not all(
            p["pending_at_return"] for p in probes[1:])):
        # The cold session may wait: its first allocations and the first
        # loads of the kernels it queues can synchronize.
        raise AssertionError(f"fused-quiet: take_evict waited for the alloc "
                             f"leg in a warm session: {probes}")

    def med(on, key):
        return float(np.median([r[key] for r in arms[on]["runs"][1:]]))
    phase("fused-quiet", shape=list(shape), sessions_per_arm=sessions,
          conf="config/kube-batch-conf.yaml with tpu-allocate",
          build_s={("fused" if on else "control"): arms[on]["build_s"]
                   for on in arms},
          wall_ms_warm_median_fused=med(True, "wall_ms"),
          wall_ms_warm_median_control=med(False, "wall_ms"),
          action_ms_warm_median={
              ("fused" if on else "control"): {
                  k: float(np.median([r["action_ms"][k]
                                      for r in arms[on]["runs"][1:]]))
                  for k in arms[on]["runs"][0]["action_ms"]}
              for on in arms},
          launch_ms={("fused" if on else "control"):
                     [m for r in arms[on]["runs"] for m in r["launch_ms"]]
                     for on in arms},
          alloc_leg_pending_at_take_evict_return=[
              p["pending_at_return"] for p in probes],
          enqueue_to_fetch_ms=[p.get("enqueue_to_fetch_ms") for p in probes],
          fetch_wait_ms=[p.get("fetch_wait_ms") for p in probes],
          binds=len(arms[True]["runs"][0]["binds"]), identical_arms=True,
          launches=launches, held=held, plain_ms=plain_ms,
          fallback_counters=0, card=card)
    return launches


def fused_storm_arm(ledger, name, env, shape, cycles=3,
                    device="cuda") -> dict:
    """bench.py's _fused_storm_arm on the port: the shipped conf on ONE
    make_churn_cache(*shape), ``cycles`` stamped sessions with the
    informer echo between them (victims deleted, binds Running).  Per
    cycle: per-action ms, the counter deltas, each launch's CUDA-event
    ms and the launch records."""
    import dataclasses as dc

    from kube_batch_tpu_torch.api import PodStatus, pod_key
    from kube_batch_tpu_torch.models.synthetic import make_churn_cache
    from kube_batch_tpu_torch.scheduler import load_scheduler_conf

    with env_arm(env), gc_posture():
        _register(device)
        actions, tiers = load_scheduler_conf(shipped_conf())
        t0 = time.perf_counter()
        cache, binder = make_churn_cache(*shape)
        build_s = time.perf_counter() - t0
        podmap = {pod_key(t.pod): t.pod for job in cache.jobs.values()
                  for t in job.tasks.values()}
        runs, evicts_all = [], []
        for c in range(cycles):
            run = stamped_session(cache, actions, tiers)
            run["records"] = ledger.take()
            run["launch_ms"] = [LaunchLedger.launch_ms(r)
                                for r in run["records"]]
            new_evicts = cache.evictor.evicts[len(evicts_all):]
            evicts_all.extend(new_evicts)
            run["evictions"] = len(new_evicts)
            for key in new_evicts:
                pod = podmap.pop(key, None)
                if pod is not None:
                    cache.delete_pod(pod)
            binds = dict(binder.binds)
            binder.binds.clear()
            run["binds"] = len(binds)
            for key, node in binds.items():
                old = podmap.get(key)
                if old is None:
                    continue
                new = dc.replace(old, spec=dc.replace(old.spec,
                                                      node_name=node),
                                 status=PodStatus(phase="Running"))
                podmap[key] = new
                cache.update_pod(old, new)
            check_no_fallback(run["delta"], f"fused-storm {name} cycle {c}")
            phase("fused-storm-cycle", arm=name, cycle=c,
                  wall_ms=run["wall_ms"], action_ms=run["action_ms"],
                  evictions=run["evictions"], binds=run["binds"],
                  dispatches=run["delta"]["dispatches"],
                  legs=run["delta"]["legs"], routes=run["delta"]["routes"],
                  launch_ms=run["launch_ms"])
            runs.append(run)
    bound = sorted((pod_key(p), p.spec.node_name) for p in podmap.values()
                   if p.spec.node_name is not None)
    return dict(build_s=build_s, runs=runs, evicts=evicts_all, binds=bound,
                events=list(cache.events))


def fused_storm_phase(cuda_solver, card, shape=NORTH_STAR,
                      device="cuda", cycles=2) -> int:
    """The storm half at the north star: bench.py's _fused_storm_arm
    protocol (``cycles`` cycles, three in bench.py, on one
    make_churn_cache with the informer echo between them) in three arms, FUSED=1, FUSED=0 and the oracle
    (FUSED=0 BATCH_EVICT=0 PIPELINE=0 INCREMENTAL=0).  The arms must
    evict the same victims in the same order, bind the same pods, and
    log the same cache events.  Cycle 1 of the fused arm must make a
    fused dispatch whose evict leg serves and whose alloc leg is
    invalidated (solve/invalidated or postevict/*); its later cycles
    must serve solve or postevict.  Every launch is held against the
    plain version; the CUDA-event ms of the invalidated launch is
    printed.  Returns the launches."""
    arms = {
        "fused": {"KUBE_BATCH_TPU_FUSED": "1"},
        "control": {"KUBE_BATCH_TPU_FUSED": "0"},
        "oracle": {"KUBE_BATCH_TPU_FUSED": "0",
                   "KUBE_BATCH_TPU_BATCH_EVICT": "0",
                   "KUBE_BATCH_TPU_PIPELINE": "0",
                   "KUBE_BATCH_TPU_INCREMENTAL": "0"},
    }
    out = {}
    with LaunchLedger(cuda_solver, device) as ledger:
        for name, env in arms.items():
            out[name] = fused_storm_arm(ledger, name, env, shape,
                                        cycles=cycles, device=device)
    for name in ("control", "oracle"):
        for key in ("evicts", "binds", "events"):
            if out[name][key] != out["fused"][key]:
                raise AssertionError(f"fused-storm: the {name} arm's {key} "
                                     f"differ from the fused arm's")
    fused = out["fused"]["runs"]
    first = fused[0]["delta"]
    if not out["fused"]["evicts"] or first["dispatches"].get("fused", 0) < 1 \
            or first["legs"].get("evict/served", 0) < 1 \
            or not (first["legs"].get("solve/invalidated", 0)
                    or any(k.startswith("postevict/") for k in first["legs"])):
        raise AssertionError(f"fused-storm cycle 0: {first}")
    for c, run in enumerate(fused[1:], 1):
        legs = run["delta"]["legs"]
        if not (legs.get("solve/served", 0)
                or legs.get("postevict/served", 0)):
            phase("fused-storm-ladder", cycle=c, legs=legs,
                  dispatches=run["delta"]["dispatches"])
    launches, plain_ms = 0, []
    held = {"plain": 0, "byte_equal": 0}
    for name in arms:
        for c, run in enumerate(out[name]["runs"]):
            got = ledger.hold(run["records"], f"fused-storm {name} cycle {c}")
            launches += len(run["records"])
            plain_ms += got["plain_ms"]
            for k in held:
                held[k] += got["held"][k]
    invalidated = first["legs"].get("solve/invalidated", 0) + \
        first["legs"].get("postevict/invalidated", 0)
    phase("fused-storm", shape=list(shape), cycles=cycles,
          evictions=len(out["fused"]["evicts"]),
          binds=len(out["fused"]["binds"]),
          events=len(out["fused"]["events"]), identical_arms=True,
          build_s={n: out[n]["build_s"] for n in arms},
          wall_ms={n: [r["wall_ms"] for r in out[n]["runs"]] for n in arms},
          action_ms={n: [r["action_ms"] for r in out[n]["runs"]]
                     for n in arms},
          legs_by_cycle=[r["delta"]["legs"] for r in fused],
          dispatches_by_cycle={n: [r["delta"]["dispatches"]
                                   for r in out[n]["runs"]] for n in arms},
          invalidated_launch_ms=(fused[0]["launch_ms"][0]
                                 if invalidated and fused[0]["launch_ms"]
                                 else None),
          launches=launches, held=held, plain_ms=plain_ms,
          fallback_counters=0, card=card)
    return launches


def fused_served_run(ledger, kw: dict, storm: bool,
                     device="cuda") -> dict:
    """One stamped shipped-conf session on make_storm_served_cache(**kw)
    under KUBE_BATCH_TPU_FUSED=1 and FUSED_STORM ``storm``: the
    stamped_session record with the build seconds, victims, binds and
    the session's launch records."""
    from kube_batch_tpu_torch.models.synthetic import make_storm_served_cache
    from kube_batch_tpu_torch.scheduler import load_scheduler_conf
    with fused_arm(True, storm), gc_posture():
        _register(device)
        actions, tiers = load_scheduler_conf(shipped_conf())
        t0 = time.perf_counter()
        cache, binder = make_storm_served_cache(**kw)
        build_s = time.perf_counter() - t0
        run = stamped_session(cache, actions, tiers)
    run.update(build_s=build_s, evicts=list(cache.evictor.evicts),
               binds=dict(binder.binds), records=ledger.take())
    run["launch_ms"] = [LaunchLedger.launch_ms(r) for r in run["records"]]
    return run


def fused_served_phase(cuda_solver, card, device="cuda",
                       n_nodes=10_000) -> int:
    """The served storm: make_storm_served_cache at 10,000 nodes (8 pods
    per node, 8 victims, 32 extra tasks) and at bench.py's 256-node gate
    shape, KUBE_BATCH_TPU_FUSED_STORM on and off.  With the storm half
    on the cycle must be one dispatch, {"fused": 1}, its evict and
    postevict legs served, 8 victims each committed once; the arms must
    evict the same victims in the same order, bind the same pods and
    end in the same state.  Every launch is held against the plain
    version.  Returns the launches."""
    shapes = (dict(n_nodes=n_nodes, per_node=8, victims=8, extra_tasks=32),
              dict(n_nodes=256, per_node=8, victims=8, extra_tasks=32))
    launches = 0
    with LaunchLedger(cuda_solver, device) as ledger:
        for kw in shapes:
            runs = {storm: fused_served_run(ledger, kw, storm, device)
                    for storm in (True, False)}
            on, off = runs[True], runs[False]
            for key in ("evicts", "binds", "state"):
                if on[key] != off[key]:
                    raise AssertionError(f"fused-served {kw}: the storm "
                                         f"arms' {key} differ")
            d = on["delta"]
            served = (d["dispatches"] == {"fused": 1}
                      and d["legs"].get("evict/served") == 1
                      and d["legs"].get("postevict/served") == 1)
            for storm, run in runs.items():
                check_no_fallback(run["delta"], f"fused-served {kw}")
                held = ledger.hold(run["records"], f"fused-served {kw} "
                                   f"storm={storm}")
                launches += len(run["records"])
                phase("fused-served-run", **kw, storm=storm,
                      wall_ms=run["wall_ms"], action_ms=run["action_ms"],
                      build_s=run["build_s"], evictions=len(run["evicts"]),
                      binds=len(run["binds"]),
                      dispatches=run["delta"]["dispatches"],
                      legs=run["delta"]["legs"],
                      routes=run["delta"]["routes"],
                      launch_ms=run["launch_ms"], **held)
            if not served or len(on["evicts"]) != kw["victims"] \
                    or len(set(on["evicts"])) != len(on["evicts"]) \
                    or not on["binds"]:
                raise AssertionError(f"fused-served {kw}: did not serve: "
                                     f"{d}, {len(on['evicts'])} victims")
            phase("fused-served", **kw, served=True,
                  committed_victims=len(on["evicts"]),
                  binds=len(on["binds"]),
                  identical_arms=True, card=card)
    return launches


def fused_topo_phase(cuda_solver, card, device="cuda",
                     dims=TOPO_DIMS, slice_shape=TOPO_SLICE) -> int:
    """The three-family dispatch: the topo cell's cache (make_topo_cache
    on the 16x16x16 torus, 4,096 hosts, a 4x4x4 slice) under the
    reference's topology conf with the ladder stamped, two cycles with
    the evicted victims echoed as deletions between them,
    KUBE_BATCH_TPU_FUSED on and off.  The fused arm must route one
    dispatch as fused/evict+solve+topo and serve its topo leg; the
    served topo stats must equal box_scan of the same staged inputs on
    the CPU; the arms must evict and bind the same.  Every launch is
    held against the plain version.  Returns the launches."""
    from kube_batch_tpu_torch.api import pod_key
    from kube_batch_tpu_torch.models.synthetic import make_topo_cache
    from kube_batch_tpu_torch.ops import fused_solver
    from kube_batch_tpu_torch.ops.topo_solver import (box_scan,
                                                      stage_box_inputs)
    from kube_batch_tpu_torch.scheduler import load_scheduler_conf

    served = []
    real_take = fused_solver.take_topo

    def take_topo(ssn, inp, shape, n, device, dtype):
        stats = real_take(ssn, inp, shape, n, device, dtype)
        if stats is not None:
            served.append((inp, tuple(shape), n, np.array(stats)))
        return stats

    out = {}
    launches = 0
    env = {"KUBE_BATCH_TPU_TOPO_BATCH": "1", "KUBE_BATCH_TPU_TOPO_DEFRAG": "1"}
    with LaunchLedger(cuda_solver, device) as ledger:
        fused_solver.take_topo = take_topo
        try:
            for on in (True, False):
                with env_arm(env), fused_arm(on), gc_posture():
                    _register(device)
                    actions, tiers = load_scheduler_conf(TOPO_CONF)
                    cache, binder = make_topo_cache(
                        pods=("pod-a",), dims=dims,
                        slice_shape=slice_shape)
                    podmap = {pod_key(t.pod): t.pod
                              for job in cache.jobs.values()
                              for t in job.tasks.values()}
                    runs = []
                    for c in range(2):
                        run = stamped_session(cache, actions, tiers)
                        run["records"] = ledger.take()
                        run["launch_ms"] = [LaunchLedger.launch_ms(r)
                                            for r in run["records"]]
                        if c == 0:
                            for key in cache.evictor.evicts:
                                cache.delete_pod(podmap.pop(key))
                        check_no_fallback(run["delta"], "fused-topo")
                        phase("fused-topo-cycle", fused=on, cycle=c,
                              wall_ms=run["wall_ms"],
                              action_ms=run["action_ms"],
                              dispatches=run["delta"]["dispatches"],
                              legs=run["delta"]["legs"],
                              routes=run["delta"]["routes"],
                              launch_ms=run["launch_ms"])
                        runs.append(run)
                    out[on] = dict(runs=runs,
                                   evicts=list(cache.evictor.evicts),
                                   binds=[(k, binder.binds[k])
                                          for k in binder.channel])
        finally:
            fused_solver.take_topo = real_take
    for key in ("evicts", "binds"):
        if out[True][key] != out[False][key]:
            raise AssertionError(f"fused-topo: the arms' {key} differ")
    routes = [r["delta"]["routes"] for r in out[True]["runs"]]
    legs = [r["delta"]["legs"] for r in out[True]["runs"]]
    if not any(r.get("fused/evict+solve+topo", 0) for r in routes) \
            or not any(lg.get("topo/served", 0) for lg in legs) or not served:
        raise AssertionError(f"fused-topo: no three-family dispatch served "
                             f"its topo leg: {routes} {legs}")
    err = 0
    for inp, shape, n, stats in served:
        cpu = box_scan(stage_box_inputs(inp, "cpu"), *shape)[:n].numpy()
        if cpu.shape != stats.shape:
            raise AssertionError(f"fused topo leg shape {stats.shape} != "
                                 f"{cpu.shape}")
        err = max(err, int(np.abs(cpu.astype(np.int64)
                                  - stats.astype(np.int64)).max()))
    if err:
        raise AssertionError(f"fused topo leg != box_scan on the CPU: max "
                             f"abs err {err}")
    held = {"plain": 0, "byte_equal": 0}
    for on in (True, False):
        for c, run in enumerate(out[True if on else False]["runs"]):
            got = ledger.hold(run["records"],
                              f"fused-topo cycle {c} (fused={on})")
            launches += len(run["records"])
            for k in held:
                held[k] += got["held"][k]
    phase("fused-topo", dims=list(dims), slice=slice_shape,
          routes=routes, legs=legs, topo_leg_vs_cpu_max_abs_err=err,
          topo_legs_served=len(served), evictions=len(out[True]["evicts"]),
          binds=len(out[True]["binds"]), identical_arms=True,
          launches=launches, held=held, fallback_counters=0, card=card)
    return launches


def fused_steady_run(ledger, on: bool, shape, rounds,
                     device="cuda") -> list:
    """The steady protocol (steady_run: make_synthetic_cache, one cold
    session, ``rounds`` rounds of 1% SteadyChurn with the echo) under the
    shipped conf with the ladder stamped, KUBE_BATCH_TPU_FUSED ``on``."""
    from kube_batch_tpu_torch.models import incremental
    from kube_batch_tpu_torch.models.synthetic import (SteadyChurn,
                                                       make_synthetic_cache)
    from kube_batch_tpu_torch.scheduler import load_scheduler_conf
    with fused_arm(on), gc_posture():
        _register(device)
        actions, tiers = load_scheduler_conf(shipped_conf())
        tpu = next(a for a in actions if a.name() == "tpu-allocate")
        cache, binder = make_synthetic_cache(*shape)
        churn = SteadyChurn(cache, binder, shape[0], shape[3], churn=0.01)
        records = []
        for rnd in range(rounds + 1):
            if rnd:
                churn.inject(rnd)
            cache.events.clear()
            tpu.last = None
            run = stamped_session(cache, actions, tiers)
            run["records"] = ledger.take()
            run["launch_ms"] = [LaunchLedger.launch_ms(r)
                                for r in run["records"]]
            st = incremental.state_for(cache, create=False)
            last = tpu.last
            run.update(round=rnd, kind=st.last_kind if st else None,
                       gathered_rows=(int(last.candidates.idx.shape[0])
                                      if last is not None
                                      and last.candidates is not None
                                      else None),
                       binds=dict(binder.binds), events=list(cache.events))
            check_no_fallback(run["delta"], f"fused-steady round {rnd}")
            phase("fused-steady-round", fused=on, round=rnd,
                  kind=run["kind"], gathered_rows=run["gathered_rows"],
                  wall_ms=run["wall_ms"], action_ms=run["action_ms"],
                  dispatches=run["delta"]["dispatches"],
                  legs=run["delta"]["legs"], launch_ms=run["launch_ms"],
                  binds_n=len(run["binds"]))
            records.append(run)
            churn.echo()
    return records


def fused_steady_phase(cuda_solver, card, shape=NORTH_STAR,
                       rounds=4, device="cuda") -> int:
    """The steady state under the fused program: the steady protocol at
    the north star (1% churn per round, ``rounds`` rounds after a cold
    session) under the shipped conf, KUBE_BATCH_TPU_FUSED on and off.
    Binds and events must be equal per round; every round of the fused
    arm must make one fused dispatch with an alloc leg, and some round
    must solve gathered rows.  A round that is not {"fused": 1} with its
    alloc leg served (reclaim evicts before tpu-allocate ships, say)
    prints a fused-steady-ladder line.  Every launch is held against the
    plain version.  Returns the launches."""
    out = {}
    with LaunchLedger(cuda_solver, device) as ledger:
        for on in (True, False):
            out[on] = fused_steady_run(ledger, on, shape, rounds, device)
    for a, b in zip(out[True], out[False]):
        if a["binds"] != b["binds"] or a["events"] != b["events"]:
            raise AssertionError(f"fused-steady round {a['round']}: the "
                                 f"arms differ")
    micro = [r for r in out[True] if r["gathered_rows"] is not None]
    if not micro:
        raise AssertionError("fused-steady: no round solved gathered rows")
    for r in out[True]:
        d = r["delta"]
        if d["dispatches"].get("fused") != 1 or not any(
                k.split("/")[0] in ("solve", "postevict") for k in d["legs"]):
            raise AssertionError(f"fused-steady round {r['round']}: no fused "
                                 f"alloc leg: {d}")
        if d["dispatches"] != {"fused": 1} \
                or d["legs"].get("solve/served") != 1:
            # Another ladder than one served dispatch: printed, reported.
            phase("fused-steady-ladder", round=r["round"],
                  dispatches=d["dispatches"], legs=d["legs"],
                  gathered_rows=r["gathered_rows"])
    launches, plain_ms = 0, []
    held = {"plain": 0, "byte_equal": 0}
    for on in (True, False):
        for r in out[on]:
            got = ledger.hold(r["records"], f"fused-steady round "
                              f"{r['round']} (fused={on})")
            launches += len(r["records"])
            plain_ms += got["plain_ms"]
            for k in held:
                held[k] += got["held"][k]
    phase("fused-steady", shape=list(shape), rounds=rounds,
          kinds=[r["kind"] for r in out[True]],
          gathered_rounds=[r["round"] for r in micro],
          legs_by_round=[r["delta"]["legs"] for r in out[True]],
          gathered_rows=[r["gathered_rows"] for r in out[True]],
          wall_ms={("fused" if on else "control"):
                   [r["wall_ms"] for r in out[on]] for on in out},
          launch_ms_micro=[r["launch_ms"] for r in micro],
          identical_arms=True, launches=launches, held=held,
          plain_ms=plain_ms, fallback_counters=0, card=card)
    return launches


FUSED_PHASES = (fused_quiet_phase, fused_storm_phase, fused_served_phase,
                fused_topo_phase, fused_steady_phase)



# ---- the device half's failure path: the degrade-* drills and profile ----

@contextlib.contextmanager
def drill_breaker(threshold=None, clock=None):
    """A fresh device breaker for the block (the global one restored and
    closed after it), whose failure() and success() calls are logged in
    order: each drill shows exactly the feed it caused."""
    from kube_batch_tpu_torch.chaos import breaker as brk
    kw = {} if clock is None else dict(clock=clock)
    br = brk.CircuitBreaker("device_solve", threshold=threshold,
                            cooldown=30.0, **kw)
    br.calls = []
    real_failure, real_success = br.failure, br.success
    br.failure = lambda: (br.calls.append("failure"), real_failure())[1]
    br.success = lambda: (br.calls.append("success"), real_success())[1]
    saved = brk._device_breaker
    brk._device_breaker = br
    try:
        yield br
    finally:
        brk._device_breaker = saved
        brk.device_breaker().reset()


@contextlib.contextmanager
def fault_plan(*sites, seed=1, rate=1.0, budget=None):
    """The chaos plan for the block: ``sites`` at ``rate`` (a drill; the
    program has no other switch for these faults)."""
    from kube_batch_tpu_torch.chaos import plan as chaos_plan
    plan = chaos_plan.install(chaos_plan.FaultPlan(
        seed=seed, rate=rate, sites=tuple(sites), budget=budget))
    try:
        yield plan
    finally:
        chaos_plan.disable()


def failures_by_stage() -> dict:
    from kube_batch_tpu_torch.metrics import metrics as m
    return {labels[0]: int(v)
            for labels, v in m.device_solve_failures.values().items()
            if labels}


def stage_delta(before: dict) -> dict:
    now = failures_by_stage()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def drill_session(cache, binder, pods, tiers, action,
                  fails=False) -> dict:
    """open_session -> ``action`` -> close_session inside a traced
    session; every bind echoed back unchanged after it (each session
    sees the same backlog).  With ``fails`` the action must raise
    DeviceFailure (a device failure on the card, which never moves to
    the host path), and its message is kept.  Returns the binds in
    order, the wall ms, the session trace's degraded notes and what was
    raised (None when nothing was)."""
    from kube_batch_tpu_torch.chaos.breaker import DeviceFailure
    from kube_batch_tpu_torch.framework import close_session, open_session
    from kube_batch_tpu_torch.trace import flight_recorder
    from kube_batch_tpu_torch.trace import spans as tspans
    seen = len(binder.channel)
    sid = tspans.begin_session(bench="drill")
    began = time.perf_counter()
    ssn = open_session(cache, tiers)
    raised = None
    try:
        action.execute(ssn)
    except DeviceFailure as exc:
        if not fails:
            raise
        raised = str(exc)
    finally:
        close_session(ssn)
        wall_ms = (time.perf_counter() - began) * 1e3
        tspans.end_session()
    if fails and raised is None:
        raise AssertionError("a drill session under a device fault did not "
                             "raise DeviceFailure")
    tr = flight_recorder.get(sid)
    binds = echo_binds(cache, binder, pods, seen)
    return dict(binds=binds, wall_ms=wall_ms, raised=raised,
                notes=list(tr.meta.get("degraded", [])) if tr else [])


def degrade_solve_phase(cuda_solver, card, shape=DRILL_SHAPE,
                        device="cuda") -> int:
    """The breaker cycle of tests/test_chaos.py's
    test_breaker_trips_to_host_path_and_recovers under the card's rule
    (chaos/breaker.py: a device failure on the card raises DeviceFailure
    after it is fed, and never runs the host path).  At DRILL_SHAPE: one
    session of a conf whose only allocate action is the host
    ``allocate`` (the binds every healthy session must give, and the
    host path's wall time at this shape), one session on the card, then
    under solve.device_error at rate 1 with a threshold-2 breaker on an
    injected clock two sessions that raise with nothing bound (+1
    failure at stage ``solve`` each, the breaker open after the second)
    and a third that the open breaker refuses without a dispatch
    attempt; with the plan off and the clock past the cooldown the
    half-open probe launches K1 (held against the plain version), binds
    as the control and closes the breaker.  Then solve.poison once: the
    session raises, its resident image is dropped, and the next session
    ships ``full`` and binds as the control.  Every session runs
    INCREMENTAL=0 (each one solves).  Returns the K1 launches."""
    from kube_batch_tpu_torch.actions.allocate import AllocateAction
    from kube_batch_tpu_torch.actions.tpu_allocate import TpuAllocateAction
    from kube_batch_tpu_torch.api import pod_key
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_cache

    clk = [0.0]
    with incremental_arm(False), gc_posture(), \
            drill_breaker(2, lambda: clk[0]) as br, \
            LaunchLedger(cuda_solver, device) as ledger:
        tiers = _register(device)
        cache, binder = make_synthetic_cache(*shape)
        pods = {pod_key(t.pod): t.pod for job in cache.jobs.values()
                for t in job.tasks.values()}
        tpu = TpuAllocateAction(device=device, dtype=torch.float32)
        runs = {}
        runs["host"] = drill_session(cache, binder, pods, tiers,
                                     AllocateAction())
        runs["card"] = drill_session(cache, binder, pods, tiers, tpu)
        want = dict(runs["host"]["binds"])
        if not want or dict(runs["card"]["binds"]) != want:
            raise AssertionError("degrade-solve: the card's binds differ "
                                 "from the host allocate action's")
        held = ledger.hold(ledger.take(), "degrade-solve's card session")
        before = failures_by_stage()
        with fault_plan("solve.device_error") as plan:
            for i in (1, 2):
                runs[f"failed-{i}"] = drill_session(
                    cache, binder, pods, tiers, tpu, fails=True)
            states = br.state()
            injected = plan.injected().get("solve.device_error", 0)
            runs["open"] = drill_session(cache, binder, pods, tiers, tpu,
                                         fails=True)
            injected_open = plan.injected().get("solve.device_error", 0)
        failed = stage_delta(before)
        if ledger.take():
            raise AssertionError("degrade-solve: K1 launched under the fault")
        clk[0] = 31.0
        runs["probe"] = drill_session(cache, binder, pods, tiers, tpu)
        probe = ledger.hold(ledger.take(), "degrade-solve's half-open probe")
        probe_state = br.state()
        shipper = getattr(cache, "_ship_cache")
        with fault_plan("solve.poison", budget=1):
            runs["poison"] = drill_session(cache, binder, pods, tiers, tpu,
                                           fails=True)
        dropped = shipper._state is None
        poisoned = ledger.take()
        runs["after-poison"] = drill_session(cache, binder, pods, tiers, tpu)
        next_mode = shipper.last_mode
        after = ledger.hold(ledger.take() + poisoned,
                            "degrade-solve's poisoned and next sessions")
        calls = list(br.calls)
    raising = ("failed-1", "failed-2", "open", "poison")
    for name, run in runs.items():
        expect = {} if name in raising else want
        if dict(run["binds"]) != expect:
            raise AssertionError(f"degrade-solve: the {name} session bound "
                                 f"{len(run['binds'])} pods, expected "
                                 f"{len(expect)}")
    if (failed != {"solve": 2} or injected != 2 or states != "open"
            or injected_open != injected or probe_state != "closed"
            or "breaker is open" not in runs["open"]["raised"]
            or not dropped or next_mode != "full"
            or probe["held"]["plain"] + probe["held"]["byte_equal"] != 1):
        raise AssertionError(
            f"degrade-solve: failures {failed}, injected {injected} / "
            f"{injected_open}, breaker {states} -> {probe_state}, image "
            f"dropped {dropped}, next ship {next_mode}, probe {probe}")
    launches = sum(sum(h["held"].values()) for h in (held, probe, after))
    phase("degrade-solve", shape=list(shape), binds=len(want),
          healthy_binds_equal_host_control=True,
          raised={name: runs[name]["raised"] for name in raising},
          binds_while_failing=0,
          failures_by_stage=failed, injected=injected,
          breaker_after_two=states, dispatch_attempts_while_open=(
              injected_open - injected),
          probe_launches=1, probe_held=probe, breaker_after_probe=probe_state,
          poison_image_dropped=dropped, next_ship_mode=next_mode,
          breaker_calls=calls,
          wall_ms={name: run["wall_ms"] for name, run in runs.items()},
          degraded_notes={name: run["notes"] for name, run in runs.items()
                          if run["notes"]},
          launches=launches, card=card)
    return launches


def degrade_deadline_phase(cuda_solver, card, device="cuda") -> int:
    """The solve deadline at the north star, on the session phase's C
    walk cache (its backlog echoed back): two warm sessions with
    KUBE_BATCH_TPU_SOLVE_DEADLINE_MS below K1's measured time (100 ms, or
    half the session phase's K1 median if lower), then one without it.
    Each late, valid result is applied (binds equal the session phase's
    last warm session), the deadline counter moves +1 per session, the
    breaker counts 2 consecutive failures and stays closed, and the
    healthy session resets them to 0.  Every launch is held against the
    plain version.  Returns the K1 launches."""
    from kube_batch_tpu_torch.chaos.breaker import SOLVE_DEADLINE_ENV
    from kube_batch_tpu_torch.metrics import metrics as m
    arm = KEPT["session"]
    want = dict(arm["binds"][-1])
    kernel_ms = float(np.median([r[3] for r in arm["runs"][1:]]))
    deadline_ms = min(100.0, kernel_ms / 2)
    runs, consecutive, counted = [], [], []
    with incremental_arm(False), gc_posture(), drill_breaker() as br, \
            LaunchLedger(cuda_solver, device) as ledger:
        for i in range(3):
            env = ({SOLVE_DEADLINE_ENV: repr(deadline_ms)} if i < 2 else {})
            before = m.solve_deadline_exceeded.value()
            with env_arm(env):
                run = drill_session(arm["cache"], arm["binder"], arm["pods"],
                                    arm["tiers"], arm["action"])
            if SOLVE_DEADLINE_ENV in os.environ:
                del os.environ[SOLVE_DEADLINE_ENV]
            counted.append(int(m.solve_deadline_exceeded.value() - before))
            consecutive.append((br._failures, br.state()))
            run["solve_ms"] = arm["action"].last.stages["dispatch_fetch"] * 1e3
            runs.append(run)
        held = ledger.hold(ledger.take(), "degrade-deadline")
    if any(dict(r["binds"]) != want for r in runs):
        raise AssertionError("degrade-deadline: a late result's binds differ "
                             "from the session phase's")
    if counted != [1, 1, 0] or consecutive != [(1, "closed"), (2, "closed"),
                                               (0, "closed")] \
            or sum(held["held"].values()) != 3:
        raise AssertionError(f"degrade-deadline: counted {counted}, breaker "
                             f"{consecutive}, held {held}")
    phase("degrade-deadline", shape=list(NORTH_STAR), deadline_ms=deadline_ms,
          session_kernel_ms_median=kernel_ms, binds=len(want),
          binds_equal_no_deadline=True, deadline_counted=counted,
          breaker_after_each=consecutive,
          solve_ms=[r["solve_ms"] for r in runs],
          wall_ms=[r["wall_ms"] for r in runs],
          notes=[r["notes"] for r in runs], held=held, card=card)
    return 3


def degrade_evict_phase(cuda_solver, card, shape=NORTH_STAR,
                        device="cuda") -> int:
    """The eviction storm at the north star (evict_cycle, a fresh
    make_churn_cache, FUSED=0 as in the evict phase) with
    evict_solve.device_error at rate 1, under the card's rule: the
    scanner's batched dispatch fails in the first eviction action
    (reclaim), one failure at stage ``evict_solve`` is fed to the
    breaker, and the session raises DeviceFailure with nothing evicted
    and nothing bound (tpu-allocate never launches).  Prints the
    action's time to the raise beside the evict phase's per-action
    medians.  Returns the K1 launches (none)."""
    seq = KEPT["evict"]
    before = failures_by_stage()
    with drill_breaker(10 ** 6) as br, \
            fault_plan("evict_solve.device_error") as plan:
        out = evict_cycle(cuda_solver, shape, True, device=device,
                          fails=True)
        injected = plan.injected().get("evict_solve.device_error", 0)
        calls = list(br.calls)
    failed = stage_delta(before)
    if (injected != 1 or failed != {"evict_solve": 1}
            or calls != ["failure"] or out["evicts"] or out["binds"]
            or out["launches"] or not out["raised"].startswith("reclaim")):
        raise AssertionError(
            f"degrade-evict: injected {injected}, failures {failed}, "
            f"breaker {calls}, {len(out['evicts'])} evicted, "
            f"{len(out['binds'])} bound, {out['launches']} launches, "
            f"raised {out['raised']}")
    phase("degrade-evict", shape=list(shape), raised=out["raised"],
          evictions=0, binds=0, failures_by_stage=failed,
          breaker_calls=calls, action_ms=out["action_ms"],
          evict_phase_action_ms={
              ("batched" if on else "sequential"): {
                  k: float(np.median(v)) for k, v in arm.items()}
              for on, arm in seq["action_ms"].items()},
          launches=out["launches"], card=card)
    return out["launches"]


def degrade_topo_phase(cuda_solver, card, device="cuda", dims=TOPO_DIMS,
                       slice_shape=TOPO_SLICE) -> int:
    """The topology cell (4,096 hosts, defrag) with the device box scan
    made to raise (ops/topo_solver.box_scan wrapped for the drill) in one
    session before the protocol's two cycles, under the card's rule:
    topo-allocate raises DeviceFailure with nothing evicted and nothing
    bound, one failure at stage ``topo`` and one degraded note.  The
    protocol then runs on the same cache with the scan restored, and the
    slice lands on one box with the numpy oracle arm's binds, victims,
    fragmentation and statuses: the failed session left no trace.
    Returns the K1 launches (none in this cell)."""
    from kube_batch_tpu_torch.ops import topo_solver
    oracle = KEPT["topo"]
    real = topo_solver.box_scan

    def box_scan(*_a, **_k):
        raise RuntimeError("drill: device box scan failed")

    @contextlib.contextmanager
    def fault():
        topo_solver.box_scan = box_scan
        try:
            yield
        finally:
            topo_solver.box_scan = real

    before = failures_by_stage()
    with drill_breaker(10 ** 6) as br:
        out = topo_arm(cuda_solver, device, True, True, dims=dims,
                       slice_shape=slice_shape, fault=fault)
        calls = list(br.calls)
    failed_session = out["failed"]
    failed = stage_delta(before)
    for key in ("binds", "evicts", "frag_after", "statuses"):
        if out[key] != oracle[key]:
            raise AssertionError(f"degrade-topo: the {key} differ from the "
                                 f"numpy oracle arm's")
    shape = tuple(int(v) for v in slice_shape.split("x"))
    if (failed != {"topo": 1} or len(failed_session["notes"]) != 1
            or failed_session["evicts"] or failed_session["binds"]
            or not failed_session["raised"].startswith("topo-allocate")
            or calls[:1] != ["failure"]
            or not is_box(out["slice_hosts"], dims, shape)):
        raise AssertionError(f"degrade-topo: failures {failed}, failed "
                             f"session {failed_session}, breaker {calls}, "
                             f"slice {out['slice_hosts'][:8]}")
    launches = sum(c["launches"] for c in out["cycles"])
    phase("degrade-topo", dims=list(dims), slice=slice_shape,
          raised=failed_session["raised"], failed_session_evictions=0,
          failed_session_binds=0, slice_box=True,
          then_equal_to_oracle=True, evictions=len(out["evicts"]),
          failures_by_stage=failed,
          degraded_notes=failed_session["notes"], breaker_calls=calls,
          action_ms=[c["action_ms"] for c in out["cycles"]],
          launches=launches, card=card)
    return launches


def degrade_fused_phase(cuda_solver, card, device="cuda") -> int:
    """The quiet shipped-conf session at the north star (fused-quiet's
    FUSED=1 cache, its backlog echoed back) with fused.device_error
    injected once: the fused dispatch fails, each family re-dispatches
    (one ``evict`` and one ``solve`` dispatch), the breaker sees one
    failure then tpu-allocate's success, K1's re-dispatched launch is
    held against the plain version and the binds and end state equal
    the FUSED=0 arm's.  Returns the K1 launches."""
    kept = KEPT["fused_quiet"]
    arm, control = kept["arm"], kept["control"]
    with incremental_arm(False), gc_posture(), fused_arm(True), \
            drill_breaker() as br, LaunchLedger(cuda_solver, device) as ledger, \
            fault_plan("fused.device_error", budget=1) as plan:
        seen = len(arm["binder"].channel)
        run = stamped_session(arm["cache"], kept["actions"], kept["tiers"])
        binds = echo_binds(arm["cache"], arm["binder"], arm["pods"], seen)
        records = ledger.take()
        injected = plan.injected().get("fused.device_error", 0)
        calls = list(br.calls)
        state = br.state()
    held = ledger.hold(records, "degrade-fused's re-dispatch")
    delta = run["delta"]
    if dict(binds) != dict(control["binds"]) \
            or run["state"] != control["state"]:
        raise AssertionError("degrade-fused: binds or end state differ from "
                             "the FUSED=0 arm's")
    if (injected != 1 or delta["dispatches"] != {"evict": 1, "solve": 1}
            or calls != ["failure", "success"] or state != "closed"
            or len(records) != 1
            or delta["fallback"].get("device_failures") != 1):
        raise AssertionError(f"degrade-fused: injected {injected}, "
                             f"{delta}, breaker {calls} {state}, "
                             f"{len(records)} launches")
    phase("degrade-fused", shape=list(NORTH_STAR), binds=len(binds),
          binds_equal_control=True, dispatches=delta["dispatches"],
          legs=delta["legs"], fallback=delta["fallback"],
          breaker_calls=calls, launch_ms=[LaunchLedger.launch_ms(r)
                                          for r in records],
          held=held, wall_ms=run["wall_ms"], action_ms=run["action_ms"],
          card=card)
    return len(records)


def degrade_shard_phase(cuda_solver, card, device="cuda",
                        shape=TENANCY_SHAPE) -> int:
    """The tenancy cell's concurrent arm (tenancy_arm, 10,000 nodes, 4
    shards, CONCURRENT_SHARDS=1, one measured round) with
    solve.device_error in its warm pass, under the card's rule, in two
    arms: the seed and rate of tests/test_concurrent_shards.py's
    test_device_error_mid_pipeline_degrades_one_shard (11, 0.25), and
    the first dispatch alone (rate 1, budget 1: shard 0, which has no
    predecessor in its round).  A hit session raises in its shard's
    retire half: that shard backs off, and the failure is fed once under
    stage ``solve``.  A hit session that a predecessor's commit then
    conflicts is discarded and rerun fresh on the card before its
    failure is fed, as in the reference (at most one feed per
    injection).  The other shards bind in the same pass, their launches
    on their own streams; retried, the failed shards bind too, no shard
    is failing after the measured round, every tenant is bound, nothing
    stays in flight, and every launch is held against the plain version.
    Returns the K1 launches."""
    from kube_batch_tpu_torch.chaos import plan as chaos_plan
    from kube_batch_tpu_torch.ops.solver import solver_inflight
    launches = 0
    for name, plan, rounds in (
            ("seed-11", chaos_plan.FaultPlan(
                seed=11, rate=0.25, sites=("solve.device_error",)), 1),
            ("first-dispatch", chaos_plan.FaultPlan(
                seed=1, rate=1.0, budget=1,
                sites=("solve.device_error",)), 1)):
        before = failures_by_stage()
        with drill_breaker(10 ** 6) as br:
            out = tenancy_arm(cuda_solver, True, device, rounds=rounds,
                              chaos=plan, **shape)
            calls = list(br.calls)
        failed = stage_delta(before)
        injected = plan.injected().get("solve.device_error", 0)
        tenants = sorted({key.split("-t")[-1].split("-")[0]
                          for binds in out["fingerprints"]
                          for key, _node in binds if "/storm-" in key})
        fed = failed.get("solve", 0)
        if (not injected or set(failed) - {"solve"} or fed > injected
                or calls.count("failure") != fed or out["failures"]
                or (name == "first-dispatch" and fed != 1)
                or solver_inflight() != 0
                or (name == "first-dispatch" and out["failed_shards"] != [0])
                or tenants != [str(t) for t in range(shape["n_queues"])]):
            raise AssertionError(
                f"degrade-shard {name}: injected {injected}, failures "
                f"{failed}, breaker {calls}, failed shards "
                f"{out['failed_shards']}, failing after {out['failures']}, "
                f"in flight {solver_inflight()}, tenants bound {tenants}")
        by_shard = out["launches_by_shard"]
        handles = [h for v in by_shard.values() for h, _ in v]
        if device == "cuda" and (None in by_shard
                                 or len(set(handles)) != len(handles)):
            raise AssertionError(f"degrade-shard {name}: launches not each "
                                 f"on its shard's own stream: {by_shard}")
        launches += sum(out["launches"]) + out["warm_launches"]
        phase("degrade-shard", arm=name, nodes=shape["n_nodes"],
              tenants=shape["n_queues"], rounds=rounds, injected=injected,
              failed_shards=out["failed_shards"],
              conflict_reruns=out["pipeline"].get("conflict_rerun", 0),
              failures_by_stage=failed, tenants_bound=tenants,
              inflight=solver_inflight(),
              warm_launches=out["warm_launches"],
              launches_per_round=out["launches"],
              launches_by_shard={str(k): v for k, v in
                                 out["launches_by_shard"].items()},
              walls_ms=out["walls_ms"], breaker_calls=calls,
              vs_plain=held_summary(out["held"]), card=card)
    return launches


def profile_phase(cuda_solver, card, out_dir="chiprun_out/profile",
                  device="cuda") -> int:
    """One warm north-star session (the session phase's C walk cache)
    with KUBE_BATCH_TPU_PROFILE set: the torch.profiler Chrome trace of
    tpu-allocate, its size, K1's device time in the trace against the
    launch's CUDA events (within 5%), the device's busy time (the union
    of kernel, copy and set intervals) and its idle share over the
    session's wall time, the top 5 device operations by time, and the
    solver.dispatch / solver.fetch span totals of the session's flight
    recorder trace.  The idle share's denominator is the session phase's
    unprofiled warm median on the same cache (the profiler's start and
    stop lengthen the profiled session; its own share is printed too).
    The launch is held against the plain version.
    Returns the K1 launches."""
    import glob

    from kube_batch_tpu_torch.trace import export, flight_recorder
    arm = KEPT["session"]
    want = dict(arm["binds"][-1])
    old = set(glob.glob(os.path.join(out_dir, "session-*.json")))
    with incremental_arm(False), gc_posture(), \
            env_arm({"KUBE_BATCH_TPU_PROFILE": out_dir}), \
            LaunchLedger(cuda_solver, device) as ledger:
        run = drill_session(arm["cache"], arm["binder"], arm["pods"],
                            arm["tiers"], arm["action"])
        sid = flight_recorder.latest().sid
        records = ledger.take()
    held = ledger.hold(records, "the profiled session")
    if dict(run["binds"]) != want or len(records) != 1:
        raise AssertionError("profile: the profiled session's binds or "
                             "launches differ")
    (path,) = set(glob.glob(os.path.join(out_dir, "session-*.json"))) - old
    with open(path) as fh:
        doc = json.load(fh)
    device = [ev for ev in doc["traceEvents"] if ev.get("ph") == "X"
              and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        raise AssertionError("profile: the trace holds no device time")
    spans_ = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
                    for ev in device)
    busy_us, end = 0.0, -math.inf
    for a, b in spans_:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = {}
    for ev in device:
        by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + ev["dur"]
    k1_ms = sum(v for k, v in by_name.items() if "solve_session" in k) / 1e3
    event_ms = LaunchLedger.launch_ms(records[0])
    if not k1_ms or abs(k1_ms - event_ms) > 0.05 * event_ms:
        raise AssertionError(f"profile: K1 {k1_ms} ms in the trace against "
                             f"{event_ms} ms by CUDA events")
    totals = export.span_totals(flight_recorder.get(sid))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    # The profiler's own start and stop lengthen the profiled session;
    # the device does the same work in the unprofiled warm sessions of
    # the session phase on this cache, whose median wall is the share's
    # denominator.
    warm_ms = float(np.median([r[1] for r in arm["runs"][1:]])) * 1e3
    phase("profile", shape=list(NORTH_STAR), trace=path,
          trace_bytes=os.path.getsize(path), k1_ms_trace=k1_ms,
          k1_ms_events=event_ms, device_busy_ms=busy_us / 1e3,
          session_wall_ms_unprofiled_median=warm_ms,
          device_idle_share=1 - busy_us / 1e3 / warm_ms,
          session_wall_ms_profiled=run["wall_ms"],
          device_idle_share_profiled=1 - busy_us / 1e3 / run["wall_ms"],
          k1_share_of_device=k1_ms / (busy_us / 1e3),
          top5_device_ms=[[name[:120], dur / 1e3] for name, dur in top],
          span_ms={k: totals.get(k, 0.0) for k in (
              "solver.dispatch", "solver.fetch", "dispatch", "device_wait",
              "ship", "tensorize", "apply")},
          held=held, card=card)
    return len(records)


# ---------------------------------------------------------------------------
# The daemon: boot warmup, K1's build cache, the HTTP surfaces
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
DAEMON_DIR = os.path.join(REPO, "build", "daemon")
# The pod lineage tracks every pod of the north star in the daemon, so
# its /metrics counts binds by queue (kube_batch_slo_time_to_bind's
# count per queue); the default ring holds 2,048 pods.
DAEMON_ENV = {"KUBE_BATCH_TPU_LINEAGE_RING": "65536"}


def write_cluster_state(path, shape=NORTH_STAR) -> None:
    """make_synthetic_cache's cluster as a cluster-state file, as far as
    load_cluster_state's format carries it (no creation times, no
    uids): nodes of 16 CPU / 64 GiB, queues of weight 1 + q % 4, gang
    groups of minMember 4/5 of their pods striped over the queues, and
    the same pod requests."""
    n_tasks, n_nodes, n_jobs, n_queues = shape
    per_job = max(1, n_tasks // n_jobs)
    cpus = ["250m", "500m", "1", "2"]
    mems = ["512Mi", "1Gi", "2Gi", "4Gi"]
    state = dict(
        nodes=[{"name": f"n{i:05d}", "allocatable": {
            "cpu": "16", "memory": "64Gi", "pods": 110}}
            for i in range(n_nodes)],
        queues=[{"name": f"q{q}", "weight": 1 + q % 4}
                for q in range(n_queues)],
        podGroups=[{"name": f"pg{j}", "namespace": "bench",
                    "minMember": max(1, per_job * 4 // 5),
                    "queue": f"q{j % n_queues}"} for j in range(n_jobs)],
        pods=[{"name": f"p{i:06d}", "namespace": "bench",
               "group": f"pg{min(i // per_job, n_jobs - 1)}",
               "requests": {"cpu": cpus[i % 4],
                            "memory": mems[(i // 2) % 4]}}
              for i in range(n_tasks)])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(state, fh)


def parse_metrics(text: str) -> dict:
    """{'name{labels}': value} of a Prometheus text exposition."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def metric_total(parsed: dict, name: str) -> float:
    return sum(v for k, v in parsed.items()
               if k == name or k.startswith(name + "{"))


def metric_by(parsed: dict, name: str, label: str) -> dict:
    """{label value: value} of one labelled series."""
    out = {}
    prefix = f'{name}{{{label}="'
    for k, v in parsed.items():
        if k.startswith(prefix):
            out[k[len(prefix):].split('"', 1)[0]] = v
    return out


def span_split(doc: dict, floor_ms: float = 1.0) -> dict:
    """Milliseconds by span name of a /debug/trace document (Chrome
    trace events), the spans of at least ``floor_ms`` in all."""
    out = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "X":
            out[ev["name"]] = out.get(ev["name"], 0.0) + ev["dur"] / 1e3
    return {k: v for k, v in sorted(out.items()) if v >= floor_ms}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# Runs kube_batch_tpu_torch.cli.main as ``python -m`` runs it (runpy,
# as __main__), with ServerRuntime.stop wrapped to write where every pod
# landed ({"namespace/name": node}) to argv[1] once the runtime stopped.
# argv[2] is "cpu" for a rehearsal on the CPU (the daemon itself has no
# device flag), else empty; the daemon's flags follow.  Over the HTTP
# edge (--master) the map is the daemon's mirror, read (flushed) before
# the stop releases its shard leases, and argv[1] + ".edge.json" gets
# the edge's own numbers: the reflectors' LIST + SYNC seconds
# (RemoteCluster.start), ingest bytes and mirrored objects by resource,
# each bind_pods_many call's (and each single bind_pod's) wall, pods,
# failures and the keys it bound, and the wall-clock time
# at which every pod of the mirror was first seen bound (``visible_at``,
# polled every 0.1 s).  Measurement only: nothing of the runtime's
# behaviour changes.
DAEMON_LAUNCHER = """
import json, runpy, sys, threading, time
out, device = sys.argv[1], sys.argv[2]
sys.argv = sys.argv[2:]
if device:
    import torch
    import kube_batch_tpu_torch.device as kdev
    kdev.resolve_device = lambda d=None: torch.device(device)
from kube_batch_tpu_torch.cli import server
from kube_batch_tpu_torch.edge import client as edge_client
edge = dict(binds=[], visible_at=None)
start, bind_many, bind_one = (edge_client.RemoteCluster.start,
                              edge_client.RemoteCluster.bind_pods_many,
                              edge_client.RemoteCluster.bind_pod)
def watch_visible(remote):
    while not remote._stop.is_set():
        remote.flush_pending()
        with remote.lock:
            pods = list(remote.pods.values())
        if pods and all(p.spec.node_name for p in pods):
            if edge["visible_at"] is None:
                edge["visible_at"] = time.time()
        else:
            edge["visible_at"] = None
        time.sleep(0.1)
def timed_start(self, *a, **kw):
    t0 = time.perf_counter()
    out_ = start(self, *a, **kw)
    edge["list_sync_s"] = time.perf_counter() - t0
    edge["list_bytes"] = self.ingest_bytes()
    threading.Thread(target=watch_visible, args=(self,),
                     daemon=True).start()
    return out_
def key(pod):
    return pod.metadata.namespace + "/" + pod.metadata.name
def timed_bind_many(self, pairs, *a, **kw):
    pairs = list(pairs)
    t0 = time.perf_counter()
    failures = bind_many(self, pairs, *a, **kw)
    failed = {key(f[0]) for f in failures}
    edge["binds"].append(dict(at=time.time(), pods=len(pairs),
                              failures=len(failures),
                              wall_s=time.perf_counter() - t0,
                              keys=[key(p) for p, _h in pairs
                                    if key(p) not in failed]))
    return failures
def timed_bind_one(self, namespace, name, hostname):
    t0 = time.perf_counter()
    bind_one(self, namespace, name, hostname)
    edge["binds"].append(dict(at=time.time(), pods=1, failures=0,
                              wall_s=time.perf_counter() - t0,
                              keys=[namespace + "/" + name]))
edge_client.RemoteCluster.start = timed_start
edge_client.RemoteCluster.bind_pods_many = timed_bind_many
edge_client.RemoteCluster.bind_pod = timed_bind_one
stop = server.ServerRuntime.stop
def stop_and_write(self):
    remote = isinstance(self.cluster, edge_client.RemoteCluster)
    if remote:
        self.cluster.flush_pending()
        with self.cluster.lock:
            placed = {k: p.spec.node_name
                      for k, p in self.cluster.pods.items()}
        edge.update(ingest_bytes=self.cluster.ingest_bytes(),
                    mirrored=self.cluster.mirrored_objects())
    stop(self)
    if not remote:
        placed = {k: p.spec.node_name
                  for k, p in list(self.cluster.pods.items())}
    with open(out, "w") as fh:
        json.dump(placed, fh)
    if remote:
        with open(out + ".edge.json", "w") as fh:
            json.dump(edge, fh)
server.ServerRuntime.stop = stop_and_write
runpy.run_module("kube_batch_tpu_torch.cli.main", run_name="__main__",
                 alter_sys=True)
"""


class Daemon:
    """One boot of the daemon's entry point (kube_batch_tpu_torch.cli.main,
    run as ``python -m`` runs it: DAEMON_LAUNCHER) on the card, its output
    in build/daemon/<name>.log and its placements in
    build/daemon/<name>.placements.json; ``stop`` sends SIGTERM and waits
    for a clean exit."""

    def __init__(self, name: str, argv: list, device: str = "cuda",
                 env=None):
        port = free_port()
        self.name = name
        self.base = f"http://127.0.0.1:{port}"
        self.log_path = os.path.join(DAEMON_DIR, f"{name}.log")
        self.placements_path = os.path.join(DAEMON_DIR,
                                            f"{name}.placements.json")
        for stale in (self.placements_path,
                      self.placements_path + ".edge.json"):
            if os.path.exists(stale):
                os.remove(stale)
        self.log = open(self.log_path, "w")
        self.signalled = False
        self.began = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", DAEMON_LAUNCHER, self.placements_path,
             "" if device == "cuda" else device, *argv,
             "--listen-address", f"127.0.0.1:{port}"],
            stdout=self.log, stderr=subprocess.STDOUT, cwd=REPO,
            env=dict(os.environ, **DAEMON_ENV, **(env or {})))

    def placements(self) -> dict:
        """{"namespace/name": node} the stopped daemon wrote."""
        with open(self.placements_path) as fh:
            return json.load(fh)

    def edge_stats(self) -> dict:
        """The edge's numbers the stopped daemon wrote (DAEMON_LAUNCHER;
        only over --master)."""
        with open(self.placements_path + ".edge.json") as fh:
            return json.load(fh)

    def tail(self) -> str:
        if not self.log.closed:
            self.log.flush()
        with open(self.log_path) as fh:
            return fh.read()[-3000:]

    def get(self, path: str):
        """(status, body text) of GET ``path``; (None, "") while the
        server does not answer."""
        import urllib.error
        import urllib.request
        try:
            with urllib.request.urlopen(self.base + path, timeout=10) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read().decode()
        except OSError:
            return None, ""

    def json(self, path: str):
        status, body = self.get(path)
        if status != 200:
            raise AssertionError(f"daemon {self.name}: GET {path} -> "
                                 f"{status}")
        return json.loads(body)

    def metrics(self) -> dict:
        status, body = self.get("/metrics")
        if status != 200:
            raise AssertionError(f"daemon {self.name}: /metrics -> {status}")
        return parse_metrics(body)

    def wait(self, what: str, check, seconds: float):
        """Poll ``check()`` until it returns a truthy value; raise when the
        daemon exits or ``seconds`` pass."""
        deadline = time.monotonic() + seconds
        while True:
            got = check()
            if got:
                return got
            if self.proc.poll() is not None:
                raise AssertionError(
                    f"daemon {self.name} exited with {self.proc.returncode} "
                    f"before {what}:\n{self.tail()}")
            if time.monotonic() > deadline:
                raise AssertionError(f"daemon {self.name}: no {what} in "
                                     f"{seconds} s:\n{self.tail()}")
            time.sleep(0.2)

    def terminate(self) -> None:
        """Send SIGTERM, once: a second SIGTERM that lands while the
        daemon's interpreter finalizes (which restores the default
        handlers) kills it with -15 instead of letting it exit 0."""
        import signal
        if not self.signalled:
            self.signalled = True
            self.proc.send_signal(signal.SIGTERM)

    def stop(self, seconds: float = 60.0) -> float:
        """SIGTERM (unless ``terminate`` sent it), then the seconds to a
        clean exit (exit code 0)."""
        t0 = time.perf_counter()
        self.terminate()
        try:
            rc = self.proc.wait(seconds)
        except subprocess.TimeoutExpired:
            self.kill()
            raise AssertionError(f"daemon {self.name} ignored SIGTERM for "
                                 f"{seconds} s:\n{self.tail()}")
        self.log.close()
        if rc != 0:
            raise AssertionError(f"daemon {self.name} exited with {rc}:\n"
                                 f"{self.tail()}")
        return time.perf_counter() - t0

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        self.log.close()


def first_session(d: Daemon):
    """The daemon's oldest recorded session (/debug/sessions lists the
    newest first; read once the first one ended, it is the first), or
    None."""
    status, body = d.get("/debug/sessions")
    sessions = json.loads(body)["sessions"] if status == 200 else []
    return sessions[-1] if sessions else None


def library_stamp(path) -> tuple:
    """(exists, mtime ns) of the kernel library."""
    try:
        return True, os.stat(path).st_mtime_ns
    except OSError:
        return False, None


def k1_launches_by_route(parsed: dict) -> int:
    """The session solves of a daemon's /metrics that launched K1 on the
    card: the allocate family's ``cuda`` and ``candidates`` routes and
    the fused program's dispatches with a ``solve`` leg."""
    routes = "kube_batch_solver_route_total"
    total = 0.0
    for k, v in parsed.items():
        if k.startswith(routes + "{"):
            family = k.split('family="', 1)[1].split('"', 1)[0]
            choice = k.split('choice="', 1)[1].split('"', 1)[0]
            if (family == "allocate" and choice in ("cuda", "candidates")) \
                    or (family == "fused" and "solve" in choice.split("+")):
                total += v
    return int(total)


def daemon_boot(name: str, state_path: str, cache_dir: str, warm: bool,
                shape: tuple, boot_s: float, device: str = "cuda") -> dict:
    """One boot of the daemon against ``state_path`` with its K1 build in
    ``cache_dir``, and with --warmup-buckets at ``shape`` when ``warm``:
    boot -> /healthz, the first session's end and its stage split
    (/debug/sessions), the warmup's end and its members (the manifest),
    every pod bound (/metrics, binds by queue), the tenant table once
    nothing is pending (/debug/tenants), the counters (compile-cache hits
    and misses, device failures, deadline overruns, tensorizer limits,
    the routes that launched K1), then SIGTERM and where every pod
    landed (``placements``)."""
    from kube_batch_tpu_torch.ops import compile_cache as cc
    from kube_batch_tpu_torch.ops import cuda_solver
    n_tasks = shape[0]
    lib = cuda_solver.library_path(cache_dir)
    before = library_stamp(lib)
    argv = ["--cluster-state", state_path, "--compile-cache-dir", cache_dir]
    if warm:
        argv += ["--warmup-buckets", "x".join(map(str, shape))]
    d = Daemon(name, argv, device)
    try:
        healthy = d.wait("/healthz", lambda: d.get("/healthz") == (200, "ok")
                         and time.time(), boot_s)
        first = d.wait("the first session", lambda: first_session(d), boot_s)
        counts_first = d.metrics()
        split = span_split(d.json(f"/debug/trace?session={first['session']}"))
        warmed = {}
        if warm:
            def manifest():
                doc = cc.read_manifest(cache_dir)["warmed"]
                mine = [e for e in doc.values()
                        if e.get("warmed_at", 0) >= d.began]
                return mine or None
            warmed = d.wait("the warmup's manifest", manifest, boot_s)
        metrics = d.wait(
            "every bind", lambda: (lambda m: m if metric_total(
                m, "kube_batch_slo_time_to_bind_seconds_count") >= n_tasks
                else None)(d.metrics()), boot_s)

        def settled():
            doc = d.json("/debug/tenants")
            rows = doc["queues"]
            return doc if rows and all(
                r["pending_jobs"] == 0 for r in rows.values()) else None

        tenants = d.wait("an empty backlog in /debug/tenants", settled, 60)
        metrics = d.metrics()
        stop_s = d.stop()
        placements = d.placements()
    except BaseException:
        d.kill()
        raise
    after = library_stamp(lib)
    by_queue = {q: int(v) for q, v in metric_by(
        metrics, "kube_batch_slo_time_to_bind_seconds_count",
        "queue").items()}
    out = dict(
        boot=name, warmup=warm,
        library_before=before[0],
        library_rebuilt=before != after,
        healthy_s=healthy - d.began,
        first_session_end_s=(first["start"] + first["duration_ms"] / 1e3
                             - d.began),
        first_session_phases_ms=first["phases_ms"],
        first_session_spans_ms=split,
        first_session_ms=first["duration_ms"],
        compile_cache_at_first_session=dict(
            hits=int(metric_total(counts_first,
                                  "kube_batch_compile_cache_hits_total")),
            misses=int(metric_total(
                counts_first, "kube_batch_compile_cache_misses_total"))),
        compile_cache=dict(
            hits=int(metric_total(metrics,
                                  "kube_batch_compile_cache_hits_total")),
            misses=int(metric_total(
                metrics, "kube_batch_compile_cache_misses_total"))),
        guards=dict(
            device_failures=int(metric_total(
                metrics, "kube_batch_device_solve_failures_total")),
            deadline_overruns=int(metric_total(
                metrics, "kube_batch_solve_deadline_exceeded_total")),
            tensorize_limits=int(metric_total(
                metrics, "kube_batch_tensorize_limit_total"))),
        binds_by_queue=by_queue,
        tenants={q: {k: r[k] for k in ("share", "deserved_share",
                                       "allocated_share", "pending_jobs")}
                 for q, r in sorted(tenants["queues"].items())},
        stop_s=stop_s, placements=placements,
        k1_launches=k1_launches_by_route(metrics) if device == "cuda" else 0)
    if warm:
        out["warmup_done_s"] = max(e["warmed_at"] for e in warmed) - d.began
        out["warmup_compile_ms"] = {e["solver"]: e["compile_ms"]
                                    for e in warmed}
        out["library"] = next((e["library"] for e in warmed
                               if e["solver"] == "cuda"), None)
        # The warmup's K1 members: the full axis, the gathered rows and
        # the fused program's allocate leg (no route count: setup).
        if device == "cuda":
            out["k1_launches"] += sum(
                e["solver"] in ("cuda", "candidate", "fused") for e in warmed)
    return out


def placements_differ(got: dict, want: dict) -> int:
    """How many pods of ``got`` and ``want`` ({"namespace/name": node})
    are not on the same node in both, a pod missing from one included."""
    return sum(got.get(k) != want.get(k) for k in set(got) | set(want))


def daemon_phase(cuda_solver, card, shape=NORTH_STAR, device="cuda",
                 edge_server=False) -> int:
    """The daemon on the card, booted three times against one
    cluster-state file of ``shape`` (write_cluster_state): (1) cold, with
    --warmup-buckets at ``shape`` and --compile-cache-dir the directory
    the rest of this script loads K1 from (build/torch_kernels), so on a
    fresh checkout its boot pays the one nvcc build of the run (where a
    library is there already, it loads it: ``library_before``); (2) the
    same again, which must load K1 without nvcc (the manifest's
    ``library`` is ``loaded``, the library file untouched); (3) a control
    without --warmup-buckets, whose first live solve is a compile-cache
    miss.  A warmed boot's first live solve is a hit when the warmup's
    K1 member ended before it, a miss when it raced the warmup (counted
    as the reference counts it; the cold boot's races the nvcc build);
    both are printed.  Each boot must bind every pod with no device
    failure, deadline overrun or tensorizer limit.  Every pod must land
    on the node one in-process Scheduler cycle of the plain route on the
    host CPU gives it, on a cache loaded from the same file
    (in_process_cycle): the daemons' K1 decisions held pod for pod
    against the plain version; binds by queue and the tenant table must
    be equal too.  ``device`` is where the boots run (a rehearsal on the
    CPU builds and launches nothing).  Returns 0: the phase launches K1
    only in the daemons' processes; their launches, read from each
    daemon's /metrics routes and warmup manifest, are kept in
    KEPT["daemon_launches"] for the kernels line."""
    state_path = os.path.join(DAEMON_DIR, "cluster-state.json")
    t0 = time.perf_counter()
    write_cluster_state(state_path, shape)
    state_s = time.perf_counter() - t0
    if edge_server:
        # daemon-edge's API server loads the same file in its own
        # process meanwhile (KEPT["edge_server"]).
        KEPT["edge_server"] = EdgeServer("edge-server", state_path)
    cache_dir = str(cuda_solver.BUILD_DIR)
    # The reference cycle runs in a thread beside the cold boot, whose
    # numbers are its load and its nvcc build's; the warm boot and the
    # control, which are compared, run alone.
    ref = {}

    def reference():
        try:
            ref["cycle"] = in_process_cycle(state_path)
        except BaseException as exc:  # re-raised below, after the join
            ref["error"] = exc

    thread = threading.Thread(target=reference, name="daemon-reference")
    thread.start()
    try:
        boots = [daemon_boot("cold", state_path, cache_dir, True, shape, 600,
                             device)]
    finally:
        thread.join()
    if "error" in ref:
        raise ref["error"]
    boots += [daemon_boot("warm", state_path, cache_dir, True, shape, 300,
                          device),
              daemon_boot("control", state_path, cache_dir, False, shape,
                          300, device)]
    cycle = ref["cycle"]
    # daemon-edge holds its boot against the same cycle.
    KEPT["daemon_cycle"] = dict(cycle)
    placed = cycle.pop("placements")
    cycle.pop("pg_phases")
    problems = []
    for b in boots:
        b["placements_differ"] = placements_differ(b.pop("placements"),
                                                   placed)
        phase("daemon-boot", **b, card=card)
        if b["placements_differ"]:
            problems.append(f"{b['boot']}: {b['placements_differ']} pods "
                            f"landed elsewhere than in-process")
        if b["binds_by_queue"] != cycle["binds_by_queue"]:
            problems.append(f"{b['boot']} binds by queue "
                            f"{b['binds_by_queue']} != in-process "
                            f"{cycle['binds_by_queue']}")
        if b["tenants"] != cycle["tenants"]:
            problems.append(f"{b['boot']} tenants {b['tenants']} != "
                            f"in-process {cycle['tenants']}")
        if any(b["guards"].values()):
            problems.append(f"{b['boot']} guards {b['guards']}")
    cold, warm, control = boots
    n_placed = sum(1 for v in placed.values() if v)
    if n_placed != shape[0]:
        problems.append(f"in-process binds {n_placed}")
    # (A rehearsal on the CPU builds no library.)
    if device == "cuda" and (
            warm["library"] != "loaded" or warm["library_rebuilt"]
            or control["library_rebuilt"]):
        problems.append(
            f"library: warm {warm['library']} rebuilt "
            f"{warm['library_rebuilt']}, control rebuilt "
            f"{control['library_rebuilt']}")
    if control["compile_cache_at_first_session"] != dict(hits=0, misses=1):
        problems.append(f"control: the first live solve was not a miss: "
                        f"{control['compile_cache_at_first_session']}")
    if problems:
        raise AssertionError("daemon: " + "; ".join(problems))
    KEPT["daemon_launches"] = sum(b["k1_launches"] for b in boots)
    phase("daemon", shape=list(shape), state_file_s=state_s,
          library_before=cold["library_before"],
          built_by=cold["library"], second_boot_library=warm["library"],
          first_solve={b["boot"]: "hit" if b[
              "compile_cache_at_first_session"]["hits"] else "miss"
              for b in boots},
          first_session_end_s={b["boot"]: b["first_session_end_s"]
                               for b in boots},
          first_session_ms={b["boot"]: b["first_session_ms"] for b in boots},
          healthy_s={b["boot"]: b["healthy_s"] for b in boots},
          warmup_done_s={b["boot"]: b.get("warmup_done_s") for b in boots},
          binds_by_queue=cycle["binds_by_queue"], placements_held=n_placed,
          placements_equal_in_process_cpu=True,
          in_process_load_s=cycle["load_s"],
          in_process_cycle_s=cycle["cycle_s"], launches=0,
          k1_launches_in_daemons={b["boot"]: b["k1_launches"]
                                  for b in boots}, card=card)
    return 0


def in_process_cycle(state_path: str) -> dict:
    """The daemon phase's reference: one Scheduler cycle with the plain
    route on the host CPU, on a cache loaded from ``state_path`` as the
    daemon loads it; where every pod landed, its binds by queue, and the
    tenant table and pod-group phases a second cycle leaves with nothing
    pending.  Launches nothing on the card, so it runs beside the cold
    boot (daemon_phase)."""
    from kube_batch_tpu_torch.cache import Cluster, new_scheduler_cache
    from kube_batch_tpu_torch.apis.scheduling.v1alpha1 import \
        GroupNameAnnotationKey
    from kube_batch_tpu_torch.cli.server import load_cluster_state
    from kube_batch_tpu_torch.metrics.tenants import tenant_table
    from kube_batch_tpu_torch.scheduler import Scheduler

    t0 = time.perf_counter()
    cluster = Cluster()
    load_cluster_state(cluster, state_path)
    cache = new_scheduler_cache(cluster)
    sched = Scheduler(cache, schedule_period=3600, device="cpu")
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not sched.cycle():
        raise AssertionError("daemon: the in-process cycle failed")
    cycle_s = time.perf_counter() - t0
    queue_of = {key: pg.spec.queue for key, pg in cluster.pod_groups.items()}
    by_queue = {}
    for pod in cluster.pods.values():
        if pod.spec.node_name:
            group = pod.metadata.annotations[GroupNameAnnotationKey]
            q = queue_of[f"{pod.metadata.namespace}/{group}"]
            by_queue[q] = by_queue.get(q, 0) + 1
    placements = {k: p.spec.node_name for k, p in cluster.pods.items()}
    sched.cycle()  # publishes the tenant table with nothing pending
    rows = tenant_table.snapshot()["queues"]
    return dict(
        binds_by_queue=by_queue, load_s=load_s, cycle_s=cycle_s,
        placements=placements,
        pg_phases={k: pg.status.phase
                   for k, pg in cluster.pod_groups.items()},
        tenants={q: {k: r[k] for k in ("share", "deserved_share",
                                       "allocated_share", "pending_jobs")}
                 for q, r in sorted(rows.items())})


class EdgeServer:
    """The port's API server, ``python -m kube_batch_tpu_torch.edge.server``,
    in a process of its own on a free port, preloaded from a
    cluster-state file when ``state_path`` is given; its output in
    build/daemon/<name>.log.  ``items`` reads its store over HTTP (the
    native wire): the truth the edge phases hold the daemons to."""

    LIVE = set()    # stopped at exit, whatever failed (stop_live)

    def __init__(self, name: str, state_path=None):
        port = free_port()
        self.name = name
        self.url = f"http://127.0.0.1:{port}"
        os.makedirs(DAEMON_DIR, exist_ok=True)
        self.log_path = os.path.join(DAEMON_DIR, f"{name}.log")
        self.log = open(self.log_path, "w")
        argv = [sys.executable, "-m", "kube_batch_tpu_torch.edge.server",
                "--port", str(port)]
        if state_path:
            argv += ["--cluster-state", state_path]
        self.began = time.time()
        self.proc = subprocess.Popen(argv, stdout=self.log,
                                     stderr=subprocess.STDOUT, cwd=REPO)
        EdgeServer.LIVE.add(self)

    def get(self, path: str, timeout: float = 300.0):
        import urllib.request
        with urllib.request.urlopen(self.url + path, timeout=timeout) as r:
            return json.loads(r.read())

    def items(self, resource: str) -> dict:
        """{key: native wire document} of one resource's store."""
        out = {}
        for doc in self.get(f"/v1/{resource}")["items"]:
            md = doc["metadata"]
            key = (md["name"] if resource in ("nodes", "queues")
                   else f"{md['namespace']}/{md['name']}")
            out[key] = doc
        return out

    def lease_holder(self, namespace: str, name: str) -> str:
        record = self.get(f"/v1/leases/{namespace}/{name}")["record"]
        return (record or {}).get("holderIdentity") or ""

    def wait_ready(self, seconds: float) -> float:
        """Poll until the server answers (it binds its port once the
        cluster-state file is loaded); the wall-clock time it did."""
        deadline = time.monotonic() + seconds
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(f"{self.name} exited with "
                                     f"{self.proc.returncode}")
            try:
                self.get("/v1/queues", timeout=10)
                return time.time()
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise AssertionError(f"{self.name}: no answer in "
                                     f"{seconds} s")
            time.sleep(0.2)

    def stop(self) -> None:
        EdgeServer.LIVE.discard(self)
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)
        self.log.close()

    @classmethod
    def stop_live(cls) -> None:
        for server in list(cls.LIVE):
            server.stop()


def truth_of(server: EdgeServer) -> dict:
    """What the API server's store holds: every pod's node ("" when
    unbound), group and queue (through its pod group), binds by queue,
    every pod group's phase, and how many nodes hold more than their
    allocatable (CPU, memory or pod count, exact compares)."""
    from kube_batch_tpu_torch.api import Resource
    from kube_batch_tpu_torch.apis.scheduling.v1alpha1 import \
        GroupNameAnnotationKey
    pods = server.items("pods")
    groups = server.items("podgroups")
    nodes = server.items("nodes")
    placed, group_of, queue_of, by_queue, used = {}, {}, {}, {}, {}
    for key, doc in pods.items():
        md = doc["metadata"]
        group = f"{md['namespace']}/" \
                f"{md['annotations'].get(GroupNameAnnotationKey, '')}"
        node = doc["spec"]["node_name"] or ""
        q = groups[group]["spec"]["queue"] if group in groups else ""
        placed[key], group_of[key], queue_of[key] = node, group, q
        if node:
            by_queue[q] = by_queue.get(q, 0) + 1
            have = used.setdefault(node, [Resource.empty(), 0])
            for c in doc["spec"]["containers"]:
                have[0].add(Resource.from_resource_list(c["requests"]))
            have[1] += 1
    over = 0
    for name, (res, count) in used.items():
        alloc = nodes[name]["status"]["allocatable"]
        cap = Resource.from_resource_list(alloc)
        if (res.milli_cpu > cap.milli_cpu or res.memory > cap.memory
                or count > int(alloc.get("pods", count))):
            over += 1
    return dict(placed=placed, group_of=group_of, queue_of=queue_of,
                by_queue=by_queue, groups=groups,
                pg_phases={k: g["status"]["phase"]
                           for k, g in groups.items()},
                over_allocatable=over)


def first_difference(got: dict, want: dict, truth: dict) -> str:
    """The first pod (in key order) that is not on the node ``want``
    gives it, with its job and that job's order key (priority class,
    creation time and uid of its pod group: the job order's ties)."""
    for key in sorted(set(got) | set(want)):
        if got.get(key) != want.get(key):
            job = truth["group_of"].get(key, "")
            md = truth["groups"].get(job, {}).get("metadata", {})
            spec = truth["groups"].get(job, {}).get("spec", {})
            order = (spec.get("priority_class_name"),
                     md.get("creation_timestamp"), md.get("uid"))
            return (f"first differing pod {key}: on {got.get(key)!r}, the "
                    f"in-process cycle's {want.get(key)!r}; job {job}, "
                    f"order key {order}")
    return ""


def daemon_edge_phase(cuda_solver, card, shape=NORTH_STAR,
                      device="cuda") -> int:
    """The daemon over the network edge, as a deployment runs it: the
    port's API server (EdgeServer) holds the daemon phase's cluster-state
    file, and one boot of the daemon with ``--master`` at it and
    ``--compile-cache-dir`` the directory K1 is built in (no
    ``--warmup-buckets``; the library is there, so nothing runs nvcc)
    lists and watches the whole cluster over HTTP, runs its sessions
    with K1 on the card, binds every pod and writes every pod-group
    status back over HTTP, and sees its binds come back on the watch.
    Read: boot -> /healthz; the reflectors' LIST + SYNC seconds and
    bytes (DAEMON_LAUNCHER); the first session's wall, its phases and
    spans; bind_pods_many's wall and pods in that session; the seconds
    from its end until every pod in the daemon's mirror is bound
    (``visible_ms``); K1's launches by route; the guards (device
    failures, deadline overruns, tensorizer limits), which must be 0.
    Held, against the API server's store read over HTTP (the truth, not
    the mirror): every pod on the node the daemon phase's in-process
    cycle of the plain route gives it, binds by queue equal to that
    cycle's, every pod group's phase equal to its; no node over its
    allocatable; the mirror equal to the truth.  A difference fails with
    the first differing pod, its job and that job's order key.  Returns
    0: K1 launches only in the daemon's process; its launches join
    KEPT["daemon_launches"] (the kernels line's ``launches_in_daemons``).
    """
    cycle = KEPT.get("daemon_cycle")
    if cycle is None:
        raise AssertionError("daemon-edge: run the daemon phase first; "
                             "its in-process cycle is the reference")
    state_path = os.path.join(DAEMON_DIR, "cluster-state.json")
    cache_dir = str(cuda_solver.BUILD_DIR)
    n_tasks = shape[0]
    server = KEPT.pop("edge_server", None) or EdgeServer("edge-server",
                                                         state_path)
    d = None
    began = time.time()
    try:
        ready = server.wait_ready(600)
        d = Daemon("edge", ["--master", server.url,
                            "--compile-cache-dir", cache_dir], device)
        healthy = d.wait("/healthz", lambda: d.get("/healthz") == (200, "ok")
                         and time.time(), 600)
        first = d.wait("the first session", lambda: first_session(d), 600)
        split = span_split(d.json(f"/debug/trace?session={first['session']}"))
        d.wait("every bind", lambda: metric_total(
            d.metrics(), "kube_batch_slo_time_to_bind_seconds_count")
            >= n_tasks, 600)

        def settled():
            truth = truth_of(server)
            return truth if truth["pg_phases"] == cycle["pg_phases"] \
                and all(truth["placed"].values()) else None

        try:
            truth = d.wait("the pod groups' phases of the in-process cycle",
                           settled, 120)
        except AssertionError:
            truth = truth_of(server)  # held below, difference named
        metrics = d.metrics()
        stop_s = d.stop()
        mirror = d.placements()
        edge = d.edge_stats()
    except BaseException:
        if d is not None:
            d.kill()
        raise
    finally:
        server.stop()
    first_end = first["start"] + first["duration_ms"] / 1e3
    in_first = [b for b in edge["binds"]
                if first["start"] <= b["at"] <= first_end]
    guards = dict(
        device_failures=int(metric_total(
            metrics, "kube_batch_device_solve_failures_total")),
        deadline_overruns=int(metric_total(
            metrics, "kube_batch_solve_deadline_exceeded_total")),
        tensorize_limits=int(metric_total(
            metrics, "kube_batch_tensorize_limit_total")))
    launches = k1_launches_by_route(metrics) if device == "cuda" else 0
    problems = []
    moved = placements_differ(truth["placed"], cycle["placements"])
    if moved:
        problems.append(f"{moved} pods off the in-process cycle's node: "
                        + first_difference(truth["placed"],
                                           cycle["placements"], truth))
    if truth["by_queue"] != cycle["binds_by_queue"]:
        problems.append(f"binds by queue {truth['by_queue']} != in-process "
                        f"{cycle['binds_by_queue']}")
    phases_differ = sorted(k for k in set(truth["pg_phases"])
                           | set(cycle["pg_phases"])
                           if truth["pg_phases"].get(k)
                           != cycle["pg_phases"].get(k))
    if phases_differ:
        k = phases_differ[0]
        problems.append(f"{len(phases_differ)} pod-group phases differ, "
                        f"first {k}: {truth['pg_phases'].get(k)!r} over the "
                        f"wire, {cycle['pg_phases'].get(k)!r} in process")
    if placements_differ(mirror, truth["placed"]):
        problems.append("the daemon's mirror differs from the server's "
                        "store: " + first_difference(mirror, truth["placed"],
                                                     truth))
    if truth["over_allocatable"]:
        problems.append(f"{truth['over_allocatable']} nodes over their "
                        f"allocatable")
    if any(guards.values()):
        problems.append(f"guards {guards}")
    sent = [k for b in edge["binds"] for k in b["keys"]]
    if len(sent) != n_tasks or set(sent) != set(truth["placed"]):
        problems.append(f"bind egress: {len(sent)} binds of "
                        f"{len(set(sent))} pods for {n_tasks}")
    if edge["visible_at"] is None:
        problems.append("the mirror never showed every pod bound")
    if device == "cuda" and not launches:
        problems.append("K1 was not launched in the daemon")
    if problems:
        raise AssertionError("daemon-edge: " + "; ".join(problems))
    KEPT["daemon_launches"] = KEPT.get("daemon_launches", 0) + launches
    phase("daemon-edge", shape=list(shape),
          # The server loads the file from its start (beside the daemon
          # phase's boots in a full run) until it answers.
          server_up_s=ready - server.began,
          server_wait_s=max(0.0, ready - began),
          healthy_s=healthy - d.began, list_sync_s=edge["list_sync_s"],
          list_bytes=edge["list_bytes"], ingest_bytes=edge["ingest_bytes"],
          mirrored=edge["mirrored"],
          first_session_end_s=first_end - d.began,
          first_session_ms=first["duration_ms"],
          first_session_phases_ms=first["phases_ms"],
          first_session_spans_ms=split,
          bind_egress=dict(calls=len(in_first),
                           pods=sum(b["pods"] for b in in_first),
                           wall_ms=sum(b["wall_s"] for b in in_first) * 1e3),
          bind_calls_all=len(edge["binds"]),
          visible_ms=(edge["visible_at"] - first_end) * 1e3,
          visible_after_egress_ms=(edge["visible_at"] - max(
              b["at"] for b in edge["binds"])) * 1e3,
          binds_by_queue=truth["by_queue"], placements_held=n_tasks,
          placements_equal_in_process_cpu=True,
          pod_group_phases_equal=len(truth["pg_phases"]),
          k1_launches=launches, guards=guards, stop_s=stop_s, card=card)
    return 0


FEDERATION_LEASE_S = 3.0
# Each shard of the federation phase holds one queue.
FEDERATION_SHARD_MAP = "q0:0|q1:1|q2:2|q3:3"
# Replica A loses every claim on shards 2 and 3 as if replica B had
# won those races (the lease.cas_conflict chaos site), so that the two
# replicas split the four shards two and two whatever their boot times.
FEDERATION_CHAOS_A = ("seed=1,rate=1.0,sites=lease.cas_conflict:2"
                      "|lease.cas_conflict:3")


def federation_cluster(url: str, shape) -> dict:
    """The drill shape's synthetic cluster (write_cluster_state's
    nodes, queues, gangs and requests), each pod labelled with its
    queue (edge/wire_shard.QUEUE_LABEL, so the server filters the
    replicas' unassigned streams), plus one pod per queue that fits no
    node (64 CPUs): it stays Pending, so each replica has pending pods
    of its own and foreign ones to keep out of its mirror.  Submitted
    over REST; returns {pod key: queue}."""
    from kube_batch_tpu_torch.api.objects import (Container, Node, NodeSpec,
                                                  NodeStatus, ObjectMeta,
                                                  Pod, PodSpec)
    from kube_batch_tpu_torch.apis.scheduling import v1alpha1
    from kube_batch_tpu_torch.edge import QUEUE_LABEL, RemoteCluster
    n_tasks, n_nodes, n_jobs, n_queues = shape
    per_job = max(1, n_tasks // n_jobs)
    cpus = ["250m", "500m", "1", "2"]
    mems = ["512Mi", "1Gi", "2Gi", "4Gi"]
    rest = RemoteCluster(url)
    for i in range(n_nodes):
        alloc = {"cpu": "16", "memory": "64Gi", "pods": 110}
        rest.create_node(Node(metadata=ObjectMeta(name=f"n{i:05d}"),
                              spec=NodeSpec(),
                              status=NodeStatus(allocatable=alloc,
                                                capacity=dict(alloc))))
    for q in range(n_queues):
        rest.create_queue(v1alpha1.Queue(
            metadata=ObjectMeta(name=f"q{q}"),
            spec=v1alpha1.QueueSpec(weight=1 + q % 4)))
    groups = [(f"pg{j}", f"q{j % n_queues}", max(1, per_job * 4 // 5))
              for j in range(n_jobs)]
    groups += [(f"stuck{q}", f"q{q}", 1) for q in range(n_queues)]
    for name, queue, min_member in groups:
        rest.create_pod_group(v1alpha1.PodGroup(
            metadata=ObjectMeta(name=name, namespace="bench"),
            spec=v1alpha1.PodGroupSpec(min_member=min_member, queue=queue)))
    queue_of = {}

    def pod(name, group, queue, requests):
        queue_of[f"bench/{name}"] = queue
        rest.create_pod(Pod(
            metadata=ObjectMeta(
                name=name, namespace="bench",
                annotations={v1alpha1.GroupNameAnnotationKey: group},
                labels={QUEUE_LABEL: queue}),
            spec=PodSpec(containers=[Container(requests=requests)])))

    for i in range(n_tasks):
        j = min(i // per_job, n_jobs - 1)
        pod(f"p{i:06d}", f"pg{j}", f"q{j % n_queues}",
            {"cpu": cpus[i % 4], "memory": mems[(i // 2) % 4]})
    for q in range(n_queues):
        pod(f"stuck{q}", f"stuck{q}", f"q{q}", {"cpu": "64",
                                                "memory": "1Gi"})
    return queue_of


def edge_federation_phase(cuda_solver, card, shape=DRILL_SHAPE,
                          device="cuda",
                          lease_s: float = FEDERATION_LEASE_S) -> int:
    """Replica federation over the edge: one API server (EdgeServer,
    federation_cluster submitted over REST) and two daemons on the one
    card, each booted with ``--master`` at it, ``--tenancy-shards 4``
    and ``--replica-federation`` (shard leases of ``lease_s``,
    FEDERATION_LEASE_S on the card; one queue per shard).  Replica A boots first with the chaos plan's
    lease.cas_conflict at shards 2 and 3 (FEDERATION_CHAOS_A), B once A
    holds 0 and 1.  Once every schedulable pod is bound in the server's
    store, both are stopped at once.  Held: each shard's lease, in the
    server's store, is held by exactly one replica, the one whose
    /debug/shards says it owns it, and the two own disjoint shards
    covering all four; each replica's mirror (DAEMON_LAUNCHER, read
    before the stop releases its leases) holds exactly its own queues'
    unbound pods and every bound pod, none of a foreign queue unbound;
    every pod but the four that fit no node is bound, exactly once (the
    replicas' bind egress adds up to the binds); no node over its
    allocatable; each replica's binds (/metrics, by queue) only in its
    own queues; both replicas launched K1; the guards 0 in both.  No
    pod-for-pod hold: two replicas race for node capacity, so their
    placements are not a single cycle's.  Returns 0; the launches join
    KEPT["daemon_launches"]."""
    n_tasks = shape[0]
    cache_dir = str(cuda_solver.BUILD_DIR)
    argv = ["--master", None, "--tenancy-shards", "4",
            "--replica-federation", "--lock-object-namespace", "kube-system",
            "--shard-lease-duration", str(lease_s),
            "--schedule-period", "0.2", "--compile-cache-dir", cache_dir]
    server = EdgeServer("federation-server")
    replicas = {}
    try:
        server.wait_ready(120)
        argv[1] = server.url
        t0 = time.perf_counter()
        queue_of = federation_cluster(server.url, shape)
        submit_s = time.perf_counter() - t0

        def holders():
            return [server.lease_holder("kube-system",
                                        f"kube-batch-shard-{i}")
                    for i in range(4)]

        env = {"KUBE_BATCH_TPU_SHARD_MAP": FEDERATION_SHARD_MAP}
        replicas["a"] = Daemon("federation-a", list(argv), device,
                               env=dict(env, KUBE_BATCH_TPU_CHAOS=(
                                   FEDERATION_CHAOS_A)))
        replicas["a"].wait("shards 0 and 1", lambda: (lambda h: all(
            h[:2]) and not any(h[2:]))(holders()), 300)
        replicas["b"] = Daemon("federation-b", list(argv), device, env=env)
        replicas["b"].wait("every shard held", lambda: all(holders()), 300)
        pending = {k for k in queue_of if k.startswith("bench/stuck")}

        def all_bound():
            truth = truth_of(server)
            return truth if sum(1 for v in truth["placed"].values()
                                if v) == n_tasks else None

        truth = replicas["b"].wait("every schedulable pod bound", all_bound,
                                   300)
        shards = {name: d.json("/debug/shards") for name, d in
                  replicas.items()}
        lease_holders = holders()
        metrics = {name: d.metrics() for name, d in replicas.items()}
        for d in replicas.values():     # both at once: see the docstring
            d.terminate()
        stop_s = {name: d.stop() for name, d in replicas.items()}
        mirrors = {name: d.placements() for name, d in replicas.items()}
        edges = {name: d.edge_stats() for name, d in replicas.items()}
    except BaseException:
        for d in replicas.values():
            d.kill()
        raise
    finally:
        server.stop()
    problems = []
    owned = {}
    for name, doc in shards.items():
        owned[name] = sorted(int(s) for s, row in doc["shards"].items()
                             if row.get("owned_here"))
    if sorted(owned["a"] + owned["b"]) != [0, 1, 2, 3]:
        problems.append(f"shards owned {owned}")
    ident = {}
    for name in owned:
        held = {lease_holders[s] for s in owned[name]}
        if len(held) != 1 or "" in held:
            problems.append(f"replica {name}'s shards {owned[name]} have "
                            f"lease holders {held}")
        ident[name] = next(iter(held), "")
    if ident.get("a") == ident.get("b"):
        problems.append(f"one holder for both replicas: {ident}")
    own_queues = {name: {f"q{s}" for s in owned[name]} for name in owned}
    bound = {k for k, v in truth["placed"].items() if v}
    for name, mirror in mirrors.items():
        want = bound | {k for k in pending
                        if queue_of[k] in own_queues[name]}
        if set(mirror) != want:
            extra = sorted(set(mirror) - want)
            missing = sorted(want - set(mirror))
            problems.append(f"replica {name}'s mirror: {len(extra)} pods "
                            f"not its own (first {extra[:1]}), {len(missing)}"
                            f" missing (first {missing[:1]})")
        foreign = [k for k, v in mirror.items()
                   if not v and queue_of.get(k) not in own_queues[name]]
        if foreign:
            problems.append(f"replica {name} mirrors foreign pending pods "
                            f"{foreign[:3]}")
    if set(truth["placed"]) - bound != pending:
        problems.append(f"unbound pods {sorted(set(truth['placed']) - bound)[:5]}")
    # Binds by queue per replica, from each replica's own bind egress
    # (its /metrics time-to-bind samples count the other's binds too,
    # once their watch echo proves them).
    sent = {name: [k for b in e["binds"] for k in b["keys"]]
            for name, e in edges.items()}
    by_queue = {}
    for name, keys in sent.items():
        for k in keys:
            q = queue_of.get(k, "")
            by_queue.setdefault(name, {})[q] = \
                by_queue.setdefault(name, {}).get(q, 0) + 1
        if not set(by_queue.get(name, {})) <= own_queues[name]:
            problems.append(f"replica {name} bound in queues "
                            f"{by_queue.get(name)}, owns "
                            f"{sorted(own_queues[name])}")
    everyone = sent["a"] + sent["b"]
    if len(everyone) != n_tasks or set(everyone) != bound:
        problems.append(f"bind egress: {len(sent['a'])} + {len(sent['b'])} "
                        f"binds, {len(set(everyone))} distinct, for "
                        f"{len(bound)} bound pods")
    if truth["over_allocatable"]:
        problems.append(f"{truth['over_allocatable']} nodes over their "
                        f"allocatable")
    guards, launches = {}, {}
    for name, m in metrics.items():
        guards[name] = dict(
            device_failures=int(metric_total(
                m, "kube_batch_device_solve_failures_total")),
            deadline_overruns=int(metric_total(
                m, "kube_batch_solve_deadline_exceeded_total")),
            tensorize_limits=int(metric_total(
                m, "kube_batch_tensorize_limit_total")))
        if any(guards[name].values()):
            problems.append(f"replica {name} guards {guards[name]}")
        launches[name] = k1_launches_by_route(m) if device == "cuda" else 0
        if device == "cuda" and not launches[name]:
            problems.append(f"replica {name} did not launch K1")
    if problems:
        raise AssertionError("edge-federation: " + "; ".join(problems))
    KEPT["daemon_launches"] = (KEPT.get("daemon_launches", 0)
                               + sum(launches.values()))
    phase("edge-federation", shape=list(shape), submit_s=submit_s,
          shards_owned=owned, binds_by_queue=by_queue,
          bind_calls={name: len(e["binds"]) for name, e in edges.items()},
          mirrored={name: e["mirrored"] for name, e in edges.items()},
          ingest_bytes={name: e["ingest_bytes"] for name, e in edges.items()},
          list_sync_s={name: e["list_sync_s"] for name, e in edges.items()},
          scope_dropped={name: metric_total(
              m, "kube_batch_ingest_dropped_total")
              for name, m in metrics.items()},
          lease_s=lease_s, lease_transitions={name: {
              k.split("{", 1)[1].rstrip("}"): v for k, v in m.items()
              if k.startswith("kube_batch_shard_lease_transitions_total{")}
              for name, m in metrics.items()},
          k1_launches=launches, guards=guards, stop_s=stop_s, card=card)
    return 0


def warmup_phase(cuda_solver, card, device="cuda", shape=NORTH_STAR) -> int:
    """SolverWarmup in process at ``shape`` (the north star), on the
    session phase's C walk cache, then one live tpu-allocate session
    there.  The in-process
    signatures are forgotten first (compile_cache.reset_seen), so the
    session's solve is a hit only because the warmup noted its key.
    Every K1 launch of the phase — the warmup's three (the full axis, the
    gathered rows, the fused program's allocate leg) and the session's —
    is held against the plain version through LaunchLedger; the session
    binds what the session phase's last warm session bound.  Prints the
    session's wall time beside the session phase's cold and warm ones
    (this process is warm already: the daemon phase measures a cold
    boot).  Returns the K1 launches."""
    from kube_batch_tpu_torch.metrics import metrics as m
    from kube_batch_tpu_torch.models.tensor_snapshot import \
        solver_config_from_tiers
    from kube_batch_tpu_torch.ops import compile_cache as cc
    arm = KEPT["session"]
    cfg = solver_config_from_tiers(arm["tiers"])
    want = dict(arm["binds"][-1])
    with incremental_arm(False), LaunchLedger(cuda_solver, device) as ledger:
        cc.reset_seen()
        t0 = time.perf_counter()
        w = cc.SolverWarmup([cc.BucketSpec(*shape)], cfg=cfg,
                            device=device).start()
        w.join(300)
        warm_s = time.perf_counter() - t0
        if not w.done or w.errors:
            raise AssertionError(f"warmup: done {w.done}, errors {w.errors}")
        warm_records = ledger.take()
        h0, m0 = m.compile_cache_counts()
        with gc_posture():
            run = drill_session(arm["cache"], arm["binder"], arm["pods"],
                                arm["tiers"], arm["action"])
        h1, m1 = m.compile_cache_counts()
        session_records = ledger.take()
        held = ledger.hold(warm_records + session_records, "warmup")
    if (h1 - h0, m1 - m0) != (1, 0) or len(session_records) != 1 \
            or len(warm_records) != 3:
        raise AssertionError(f"warmup: the session's hits/misses "
                             f"{(h1 - h0, m1 - m0)}, launches "
                             f"{len(warm_records)} + {len(session_records)}")
    if dict(run["binds"]) != want:
        raise AssertionError("warmup: the session's binds differ from the "
                             "session phase's")
    runs = arm["runs"]
    phase("warmup", shape=list(shape), warmup_s=warm_s,
          members_ms={r.solver: r.compile_ms for r in w.records},
          session_hits=h1 - h0, session_misses=m1 - m0,
          wall_ms_after_warmup=run["wall_ms"],
          session_phase_cold_wall_ms=runs[0][1] * 1e3,
          session_phase_warm_wall_ms_median=float(
              np.median([r[1] for r in runs[1:]])) * 1e3,
          binds=len(want), held=held,
          launches=len(warm_records) + len(session_records), card=card)
    return len(warm_records) + len(session_records)


# One past the tensorizer's 64 host-port keys.
PORT_KEYS = 65


def tensorize_limit_phase(cuda_solver, card, shape=DRILL_SHAPE,
                          device="cuda") -> int:
    """A session at one of the tensorizer's limits, on the card and on
    the CPU: make_synthetic_cache(*shape) plus one job of PORT_KEYS pods,
    each asking for its own host port.  The tensorizer cannot stage it,
    so tpu-allocate runs the host allocate action on either device (the
    reference's boundary, kept on the card): on the card it must move
    kube_batch_tensorize_limit_total{reason="host_ports",
    site="tpu-allocate"} by 1, note it on the session trace, launch no
    kernel, bind what the CPU binds, and leave every other guard at 0
    and the breaker closed.  Returns 0 (no K1 launch)."""
    from kube_batch_tpu_torch.actions.tpu_allocate import TpuAllocateAction
    from kube_batch_tpu_torch.api import (Container, ContainerPort,
                                          ObjectMeta, Pod, PodSpec,
                                          PodStatus, pod_key)
    from kube_batch_tpu_torch.apis.scheduling import v1alpha1
    from kube_batch_tpu_torch.chaos.breaker import device_breaker
    from kube_batch_tpu_torch.metrics import metrics as m
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_cache

    runs = {}
    for label, dev in (("card", device), ("cpu", "cpu")):
        tiers = _register(dev)
        cache, binder = make_synthetic_cache(*shape)
        cache.add_pod_group(v1alpha1.PodGroup(
            metadata=ObjectMeta(name="ports", namespace="bench"),
            spec=v1alpha1.PodGroupSpec(min_member=1, queue="q0")))
        for i in range(PORT_KEYS):
            cache.add_pod(Pod(
                metadata=ObjectMeta(
                    name=f"ports-{i}", namespace="bench", uid=f"ports-{i}",
                    annotations={v1alpha1.GroupNameAnnotationKey: "ports"},
                    creation_timestamp=float(shape[0] + i)),
                spec=PodSpec(containers=[Container(
                    requests={"cpu": "100m", "memory": "128Mi"},
                    ports=[ContainerPort(host_port=20000 + i)])]),
                status=PodStatus(phase="Pending")))
        pods = {pod_key(t.pod): t.pod for job in cache.jobs.values()
                for t in job.tasks.values()}
        before, limits = fused_counters(), m.tensorize_limit_counts()
        with incremental_arm(False), LaunchLedger(cuda_solver, dev) as ledger:
            run = drill_session(cache, binder, pods, tiers,
                                TpuAllocateAction(device=dev,
                                                  dtype=torch.float32))
        now = m.tensorize_limit_counts()
        run["limits"] = {k: v - limits.get(k, 0) for k, v in now.items()
                         if v != limits.get(k, 0)}
        run["fallback"] = counters_delta(before, fused_counters())["fallback"]
        run["launches"] = len(ledger.take())
        runs[label] = run
    card_run, cpu_run = runs["card"], runs["cpu"]
    if not card_run["binds"] or dict(card_run["binds"]) != dict(
            cpu_run["binds"]):
        raise AssertionError("tensorize-limit: the card's binds differ from "
                             "the CPU's")
    for label, run in runs.items():
        if run["limits"] != {"host_ports/tpu-allocate": 1} \
                or run["fallback"] != {"tensorize_limits": 1} \
                or run["launches"] or not any(
                    "tensorizer limit" in n for n in run["notes"]):
            raise AssertionError(
                f"tensorize-limit on the {label}: limits {run['limits']}, "
                f"guards "
                f"{run['fallback']}, launches {run['launches']}, notes "
                f"{run['notes']}")
    if device_breaker().state() != "closed":
        raise AssertionError("tensorize-limit: the breaker is not closed")
    phase("tensorize-limit", shape=list(shape), port_keys=PORT_KEYS,
          binds=len(card_run["binds"]), binds_equal_cpu=True,
          limits=card_run["limits"], guards=card_run["fallback"],
          notes=card_run["notes"], launches=0,
          wall_ms={label: run["wall_ms"] for label, run in runs.items()},
          card=card)
    return 0


# ---- the verification harnesses (kube_batch_tpu_torch/tools/) --------------

# scenario_gen's sweep: one seed per kind (kinds cycle; seed = index).
SCENARIO_SEEDS = 5
# The scenarios whose batched arm on the card must equal the port's
# batched arm on the CPU, bind for bind.
SCENARIOS_VS_CPU = (("frag_pressure", 0), ("churn_storm", 2))
# chaos_soak's shapes: the reference's chaos-smoke (8 nodes, 10 cycles),
# in process and over the edge, its seeds swept 1, 2, ... in order until
# every required site has fired (CHAOS_SEED_CAP at most).  On the card a
# failed device stage aborts the session, so preempt's commit flush is
# reached less often while a plan is active, and commit.flush_error
# needs more seeds than the reference's two (seed 8 under the card's
# rule on the CPU).  A seed may diverge from its oracle only as the
# reference's own soak does at this shape (seeds 6 and 8 of 1-8): the
# fault-free scheduler started on the truth each fault phase left must
# reach the chaos arm's maps (chaos_soak.fault_free_from).  Then one
# oracle + chaos pair at 2,000 nodes whose fault budget keeps the
# chaos-smoke's 60 per 8 nodes, so that the per-node
# topology.bad_coords site does not spend it in the first cycle and the
# device sites fire in every fault cycle at the reference's rates.
CHAOS_SEED_CAP = 16
CHAOS_LARGE = dict(seed=1, nodes=2_000, budget=15_000)
# replica_soak at the reference's soak-replicas shape.
REPLICA_SOAK = dict(replicas=3, shards=3, churn_rounds=12, edge=True)


def scenarios_phase(cuda_solver, card, device="cuda",
                    seeds=SCENARIO_SEEDS) -> int:
    """scenario_gen's sweep on ``device``: ``seeds`` scenarios (one per
    kind), each in its batched and its sequential arm, with the replay
    round trip.  Every scenario must be error-free, its arms identical
    (compare_arms), the breaker never tripped; the replay bit-identical.
    Then scenarios-vs-cpu: the batched arm of SCENARIOS_VS_CPU on
    ``device`` and on the CPU must bind, keep and delete the same pods.
    Every session-kernel launch is held against the plain version.
    Returns the launches."""
    from kube_batch_tpu_torch.tools import scenario_gen as sg
    began = time.perf_counter()
    with LaunchLedger(cuda_solver, device) as ledger:
        sweep = sg.run_sweep(seeds, 4, with_replay=True, device=device)
        records = ledger.take()
        vs_cpu = []
        for kind, seed in SCENARIOS_VS_CPU:
            spec = sg.gen_scenario(kind, seed)
            arms = {dev: sg.run_arm(spec, sequential=False, device=dev)
                    for dev in (device, "cpu")}
            for key in ("bind_map", "pods", "deletes"):
                if arms[device][key] != arms["cpu"][key]:
                    raise AssertionError(f"scenarios-vs-cpu {kind} {seed}: "
                                         f"the {key} on {device} differs "
                                         f"from the CPU's")
            vs_cpu.append(dict(kind=kind, seed=seed,
                               binds=len(arms["cpu"]["bind_map"]),
                               deletes=len(arms["cpu"]["deletes"]),
                               launches=arms[device]["launches"]))
        records += ledger.take()
    held = ledger.hold(records, "scenarios")
    for row in sweep["scenarios"]:
        phase("scenario", **row)
    phase("scenario-replay", **sweep.get("replay", {}))
    phase("scenarios-vs-cpu", device=device, runs=vs_cpu, identical=True)
    if not sweep["ok"]:
        failed = [(r["kind"], r["seed"], r["errors"])
                  for r in sweep["scenarios"] if r["errors"]]
        raise AssertionError(f"scenarios: {failed}, replay "
                             f"{sweep.get('replay')}")
    launches = sum(r["launches"]["batched"] + r["launches"]["sequential"]
                   for r in sweep["scenarios"])
    if device == "cuda" and not all(
            r["launches"]["batched"] and r["launches"]["sequential"]
            for r in sweep["scenarios"]):
        raise AssertionError("scenarios: an arm launched no session kernel")
    phase("scenarios", device=device, seeds=seeds,
          kinds=[r["kind"] for r in sweep["scenarios"]],
          breaker_trips=sum(r["breaker_trips"] for r in sweep["scenarios"]),
          sweep_launches=launches, wall_s=time.perf_counter() - began,
          **held_fields(held), card=card)
    return len(records)


def held_fields(held: dict) -> dict:
    """LaunchLedger.hold's summary for a phase line: how many launches
    were held each way, the plain versions' median and total ms."""
    ms = held["plain_ms"]
    return dict(held=held["held"], max_abs_err=held["max_abs_err"],
                plain_ms_median=float(np.median(ms)) if ms else None,
                plain_ms_total=float(sum(ms)))


def soak_lines(name: str, artifact: dict) -> None:
    """One chaos-soak-seed line per chaos arm of ``artifact``."""
    for row in artifact["seeds"]:
        phase("chaos-soak-seed", run=name, **{
            k: row[k] for k in (
                "seed", "injected", "injected_total", "failed_cycles",
                "drain_cycles", "drain_failed_cycles", "loop_deaths",
                "double_binds", "lost_evictions", "breaker", "launches",
                "mirror_wait_s", "wall_s", "errors", "diverged",
                "path_problems")})


def soak_faults(artifact: dict) -> list:
    """A soak artifact's problems, less each seed's divergence from its
    oracle where the fault-free scheduler from the faults' state reaches
    the chaos arm's maps (``path_problems`` empty)."""
    excused = {f"seed {row['seed']}: {err}" for row in artifact["seeds"]
               if row["path_problems"] == [] for err in row["diverged"]}
    return [p for p in artifact["problems"] if p not in excused]


def chaos_soak_phase(cuda_solver, card, device="cuda") -> int:
    """chaos_soak on ``device``: the chaos-smoke shape's seeds 1, 2, ...
    swept in order until every FAKE_SITES site fired (CHAOS_SEED_CAP at
    most), the same over the edge until every EDGE_SITES site fired, and CHAOS_LARGE's oracle + chaos pair at
    2,000 nodes, then run_overhead_ab.  Every chaos arm must survive every
    cycle, accept no double bind, and converge to its oracle (schedule
    equivalence over the edge) or diverge only by its path (soak_faults).
    On the card no failed device stage may run the host path (the host
    allocate action never runs); each arm's breaker trips, probes and
    seconds waited are printed.  Afterwards the fault plan is off and the
    breaker closed.  Every session-kernel launch is held against the
    plain version.  Returns the launches."""
    import kube_batch_tpu_torch.chaos.breaker as brk
    from kube_batch_tpu_torch.actions import allocate
    from kube_batch_tpu_torch.chaos import plan as chaos_plan
    from kube_batch_tpu_torch.tools import chaos_soak as soak
    host_allocate = [0]
    real_execute = allocate.AllocateAction.execute

    def execute(self, ssn):
        host_allocate[0] += 1
        return real_execute(self, ssn)

    allocate.AllocateAction.execute = execute
    runs, launches, faults = {}, 0, {}
    try:
        with LaunchLedger(cuda_solver, device) as ledger:
            sweep = dict(seeds=range(1, CHAOS_SEED_CAP + 1),
                         until_all_sites=True)
            for name, kw in (
                    ("fake", sweep),
                    ("edge", dict(edge=True, **sweep)),
                    ("large", dict(seeds=[CHAOS_LARGE["seed"]],
                                   nodes=CHAOS_LARGE["nodes"],
                                   budget=CHAOS_LARGE["budget"],
                                   require_all_sites=False))):
                began = time.perf_counter()
                art = soak.run_soak(**{"nodes": 8, "cycles": 10,
                                       "device": device, **kw})
                wall_s = time.perf_counter() - began
                held = ledger.hold(ledger.take(), f"chaos-soak {name}")
                launches += sum(held["held"].values())
                runs[name] = art
                faults[name] = soak_faults(art)
                soak_lines(name, art)
                phase("chaos-soak-run", run=name, seeds=len(art["seeds"]),
                      nodes=art["nodes"], budget=art["budget"],
                      oracle=art["oracle"],
                      breaker_cooldown_s=art["breaker_cooldown_s"],
                      sites_fired=art["sites_fired"],
                      diverged=[row["seed"] for row in art["seeds"]
                                if row["diverged"]],
                      faults=faults[name], wall_s=wall_s,
                      **held_fields(held))
            ab = soak.run_overhead_ab(device=device)
            held = ledger.hold(ledger.take(), "chaos-soak overhead A/B")
            launches += sum(held["held"].values())
    finally:
        allocate.AllocateAction.execute = real_execute
    bad = {name: f for name, f in faults.items() if f}
    if bad:
        raise AssertionError(f"chaos-soak: {bad}")
    if not brk.host_path_allowed(device) and host_allocate[0]:
        raise AssertionError(f"chaos-soak: a failed device stage ran the "
                             f"host allocate action {host_allocate[0]} "
                             f"times on the card")
    state = brk.device_breaker().state()
    if chaos_plan.PLAN is not None or state != "closed":
        raise AssertionError(f"chaos-soak: left the plan "
                             f"{chaos_plan.PLAN} and the breaker {state}")
    arms = [row for art in runs.values() for row in art["seeds"]]
    kept = [row for row in arms if not row["diverged"]]
    phase("chaos-soak", device=device, arms=len(arms),
          converged=len(kept),
          diverged_by_path=[(row["seed"], row["lost_evictions"])
                            for row in arms if row["diverged"]],
          loop_deaths=sum(r["loop_deaths"] for r in arms),
          double_binds=sum(r["double_binds"] for r in arms),
          lost_evictions=sum(r["lost_evictions"] for r in kept),
          breaker_trips=sum(r["breaker"]["trips"] for r in arms),
          breaker_probes=sum(r["breaker"]["probes"] for r in arms),
          breaker_waited_s=sum(r["breaker"]["waited_s"] for r in arms),
          host_allocate=host_allocate[0], overhead_ab=ab,
          launches=launches, plan="off", breaker=state, card=card)
    return launches


def replica_soak_phase(cuda_solver, card, device="cuda") -> int:
    """replica_soak on ``device`` at REPLICA_SOAK (three replicas in this
    process, the last over the edge, lease faults, a mid-run kill with
    crash semantics) and its skewed-load check: every invariant must
    hold, the orphaned shards stolen within the lease duration and its
    slack, and the adopting replica's sessions key-ledger hits with no
    new miss.  Every session-kernel launch is held against the plain
    version.  Returns the launches."""
    from kube_batch_tpu_torch.tools import replica_soak as rs
    began = time.perf_counter()
    with LaunchLedger(cuda_solver, device) as ledger:
        art = rs.run_soak(device=device, **REPLICA_SOAK)
        skew = rs.run_skewed_load_check(device=device)
        records = ledger.take()
    held = ledger.hold(records, "replica-soak")
    phase("replica-soak", device=device, ok=art["ok"] and skew["ok"],
          problems=art["problems"] + skew["problems"],
          **{k: art[k] for k in (
              "replicas", "shards", "edge", "churn_rounds", "binds",
              "rejected_rebinds", "orphaned_shards", "reclaim_s",
              "lease_duration_s", "compile_cache", "shard_sessions",
              "shard_binds", "edge_stale_entries", "launches")},
          skewed_load=skew, wall_s=time.perf_counter() - began,
          **held_fields(held), card=card)
    if not (art["ok"] and skew["ok"]):
        raise AssertionError(f"replica-soak: {art['problems']} "
                             f"{skew['problems']}")
    if device == "cuda" and not art["launches"]:
        raise AssertionError("replica-soak: no session kernel launched")
    return len(records)


def tools_phases(cuda_solver, card, device="cuda") -> int:
    """The three harness phases in order: scenarios and replica-soak
    guarded (no fallback counter may move), chaos-soak, which injects
    device faults, checked on its own (see chaos_soak_phase)."""
    launches = guarded(scenarios_phase, cuda_solver, card, device=device)
    launches += chaos_soak_phase(cuda_solver, card, device=device)
    launches += guarded(replica_soak_phase, cuda_solver, card,
                        device=device)
    return launches


# The mesh phase: 4 shards of the node axis on the one card.  Its full
# width crosses the mesh gate's node count (SHARD_NODES, 16,384) with no
# FORCE_SHARD; the small shape is where the shard mode is held against
# its plain version, the session and fused shapes where the action and
# the fused program run on the mesh.
MESH_SHARDS = 4
MESH_SHAPE = (50_000, 16_384, 2_000, 4)
MESH_SMALL = (2_000, 512, 80, 4)
MESH_SESSION = (2_000, 256, 80, 4)
MESH_FUSED = (2_000, 256, 80, 4)
MESH_TOPO = (8, 8, 8)
# The candidate-row solve's backlog (the reference's cycle-floor case).
CANDIDATE_TASKS = 20
# The exchange-deadline drills' spin bound (ms) and the late shard's delay
# in units of it: twice it must fail, a quarter must solve, and near it
# either outcome is right as long as every shard stops.
MESH_DRILL_SPIN_MS = 200
MESH_DRILL_LATE = (2.0, 0.25, 0.9, 1.0, 1.1)


def same_result(a, b, where: str) -> int:
    """Two (SolveResult, ...) or (assignment, kind, order[, step]) held
    byte for byte; returns the max abs difference (0) or raises."""
    def rows(x):
        r = x[0] if hasattr(x[0], "assignment") else x
        if hasattr(r, "assignment"):
            r = (r.assignment, r.kind, r.order, r.step)
        return [np.asarray(t.cpu() if hasattr(t, "cpu") else t)
                .astype(np.int64).reshape(-1) for t in r]
    err = 0
    for name, x, y in zip(("assignment", "kind", "order", "step"),
                          rows(a), rows(b)):
        if x.shape != y.shape:
            raise AssertionError(f"{where}: {name} shapes {x.shape} != "
                                 f"{y.shape}")
        if x.size:
            err = max(err, int(np.abs(x - y).max()))
    if err:
        raise AssertionError(f"{where}: max abs err {err}")
    return err


def mesh_fused_arm(device, mesh_on: bool, shape=MESH_FUSED) -> dict:
    """One fused shipped-conf session on make_churn_cache(*shape) on
    ``device``, on the forced mesh (``mesh_on``) or on one device:
    state, victims in order, binds, and the resident image's layout."""
    from kube_batch_tpu_torch.models.synthetic import make_churn_cache
    from kube_batch_tpu_torch.scheduler import load_scheduler_conf
    _register(device)
    actions, tiers = load_scheduler_conf(shipped_conf())
    cache, binder = make_churn_cache(*shape)
    with fused_arm(True, storm=True), env_arm(
            {"KUBE_BATCH_TPU_SCAN_MIN_NODES": "0"}):
        got = stamped_session(cache, actions, tiers)
    return dict(state=got["state"], evicts=list(cache.evictor.evicts),
                binds=dict(binder.binds), wall_ms=got["wall_ms"],
                layout=type(cache._ship_cache._state).__name__)


@contextlib.contextmanager
def late_shard_arm(cuda_solver, spin_ms: int, late: tuple):
    """Every sharded solve in the block launches shard ``late[0]``
    ``late[1]`` ms after the others, with the spin bound at ``spin_ms``
    (a drill; the program has no other switch for this fault).  The
    wrapper stands in the module for the real function, whose counts it
    carries and hands back."""
    real = cuda_solver.solve_allocate_cuda_sharded

    def late_shard(inp, cfg, **kw):
        kw.setdefault("spin_ms", spin_ms)
        kw.setdefault("late", late)
        return real(inp, cfg, **kw)

    late_shard.__dict__.update(real.__dict__)
    cuda_solver.solve_allocate_cuda_sharded = late_shard
    try:
        yield
    finally:
        real.__dict__.update(late_shard.__dict__)
        cuda_solver.solve_allocate_cuda_sharded = real


def mesh_drills(cuda_solver, mesh, sharded_small, scfg, want,
                session) -> dict:
    """K1's shard mode under faults, on the card, after the mesh phase's
    counted path.  (1) A late shard, with the spin bound at
    MESH_DRILL_SPIN_MS: launched MESH_DRILL_LATE bounds after the others,
    each solve ends (waited for at most 30 s, else the process leaves);
    at twice the bound the fetch's check raises DeviceFailure, at a
    quarter it solves, near it either; a solve that ends equals ``want``.
    (2) A forced-mesh tpu-allocate session at ``session`` with the last
    shard launched after twice the bound: it raises DeviceFailure, feeds
    the breaker once and drops the per-shard resident image; the next
    session ships in full, solves on the mesh, feeds a success and binds.
    (3) Two threads that dispatch sharded solves at once (the boot
    warmup beside the scheduler): every solve equals ``want``."""
    from kube_batch_tpu_torch.actions.tpu_allocate import TpuAllocateAction
    from kube_batch_tpu_torch.chaos.breaker import DeviceFailure
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_cache
    from kube_batch_tpu_torch.ops import solver as solver_mod
    from kube_batch_tpu_torch.parallel import use_mesh
    shard_fn = cuda_solver.solve_allocate_cuda_sharded
    spin = MESH_DRILL_SPIN_MS
    late_runs = []
    for frac in MESH_DRILL_LATE:
        t0 = time.perf_counter()
        res, _ = shard_fn(sharded_small, scfg, spin_ms=spin,
                          late=(MESH_SHARDS - 1, frac * spin))
        wait_device(f"the shard mode with a shard {frac} bounds late", 30.0)
        ms = (time.perf_counter() - t0) * 1e3
        try:
            solver_mod._check_not_aborted(res.kind.cpu().numpy())
            same_result((res,), (want,), f"a shard {frac} bounds late")
            outcome = "solved"
        except DeviceFailure:
            outcome = "gave_up"
        late_runs.append((frac, outcome, ms))
    if late_runs[0][1] != "gave_up" or late_runs[1][1] != "solved":
        raise AssertionError(f"late shards: {late_runs}")

    tiers = _register("cuda")
    action = TpuAllocateAction(device="cuda", dtype=torch.float32)
    cache, binder = make_synthetic_cache(*session)
    with use_mesh(mesh), env_arm({solver_mod.FORCE_SHARD_ENV: "1"}), \
            drill_breaker(10 ** 6) as br:
        solver_mod.refresh_shard_knobs()
        before = failures_by_stage()
        t0 = time.perf_counter()
        with late_shard_arm(cuda_solver, spin, (MESH_SHARDS - 1, 2 * spin)):
            try:
                mesh_session(cache, tiers, action)
                raised = None
            except DeviceFailure as exc:
                raised = str(exc)
        wait_device("the late-shard session", 30.0)
        fail_ms = (time.perf_counter() - t0) * 1e3
        state = cache._ship_cache._state
        fed, calls = stage_delta(before), list(br.calls)
        binds = len(binder.binds)
        mesh_session(cache, tiers, action)
        after = (cache._ship_cache.last_mode,
                 type(cache._ship_cache._state).__name__,
                 list(br.calls[len(calls):]), len(binder.binds) > binds)
    solver_mod.refresh_shard_knobs()
    if raised is None or fed != {"solve": 1} or calls != ["failure"] \
            or state is not None or binds \
            or after != ("full", "_ShardShipState", ["success"], True):
        raise AssertionError(
            f"the late-shard session: raised={raised!r} fed={fed} "
            f"calls={calls} image={type(state).__name__} binds={binds}, "
            f"then {after}")

    got, errors = [], []
    start = threading.Barrier(2)

    def dispatch():
        try:
            start.wait()
            for _ in range(3):
                got.append(shard_fn(sharded_small, scfg)[0])
        except BaseException as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    threads = [threading.Thread(target=dispatch) for _ in range(2)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wait_device("two threads' sharded solves", 30.0)
    both_ms = (time.perf_counter() - t0) * 1e3
    if errors:
        raise errors[0]
    for i, res in enumerate(got):
        solver_mod._check_not_aborted(res.kind.cpu().numpy())
        same_result((res,), (want,), f"concurrent sharded solve {i}")
    return dict(drill_spin_ms=spin, late_shard=late_runs,
                late_session_ms=fail_ms, late_session_raised=raised,
                concurrent_solves=len(got), concurrent_ms=both_ms)


def degrade_mesh_phase(cuda_solver, card) -> int:
    """The mesh's drills (mesh_drills) on MESH_SHARDS shards of the card,
    held against single-device K1 at MESH_SMALL (seed 3, the shape the
    mesh phase holds the shard mode against its plain version at).
    Returns 0: K1's one launch here is the reference the drills compare
    with, and the shard mode's launches are the mesh phase's to count."""
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
    from kube_batch_tpu_torch.parallel import make_mesh
    from kube_batch_tpu_torch.parallel.mesh import shard_solver_inputs
    mesh = make_mesh(MESH_SHARDS, ["cuda"])
    sinp, scfg = make_synthetic_inputs(*MESH_SMALL, seed=3,
                                       dtype=torch.float32, device="cuda")
    want = cuda_solver.solve_allocate_cuda(sinp, scfg)[0]
    wait_device("single-device K1 for the mesh drills")
    t0 = time.perf_counter()
    drills = mesh_drills(cuda_solver, mesh, shard_solver_inputs(sinp, mesh),
                         scfg, want, MESH_SESSION)
    phase("degrade-mesh", shards=MESH_SHARDS, small_shape=list(MESH_SMALL),
          session_shape=list(MESH_SESSION), **drills,
          seconds=time.perf_counter() - t0, card=card)
    return 0


def mesh_phase(cuda_solver, card, device="cuda", shape=MESH_SHAPE,
               small=MESH_SMALL, session=MESH_SESSION, fused=MESH_FUSED,
               topo_dims=MESH_TOPO, candidate_tasks=CANDIDATE_TASKS) -> int:
    """The node-sharded mesh (parallel/) on MESH_SHARDS shards installed
    on one card (``parallel.mesh.use_mesh``).  The driven path, with K1's
    and its shard mode's counts set to 0 just before and read just
    after: the gate at ``shape`` (no FORCE_SHARD) routes the ship and
    the solve to the mesh, the shipper keeps the sharded layout and K1's
    shard mode solves; then, under FORCE_SHARD, tpu-allocate sessions at
    ``session`` through the per-shard shipper (a full ship, a clean ship
    that keeps the generation and reuses the solve, a delta ship), a
    candidate-row solve gathered per shard, and one fused shipped-conf
    session whose legs take their sharded routes.  No single-device K1
    launch may happen on that path.  Then every launch is held: the
    shard mode at ``shape`` byte for byte against single-device K1 on
    the same inputs (result and every shard's final node slice), every
    shard's replicated outputs equal, the sessions' and the candidate
    solve's launches against single-device K1, the shard mode at
    ``small`` against its plain version (solve_allocate_sharded_plain,
    on the host's CPU); the sharded eviction scan, the candidate
    gather, the origin-sharded box scan at ``topo_dims`` and the fused
    mesh session each equal their single-device results.  Prints the
    per-solve times (shard mode, single device, CUDA events), the
    exchange's µs per placement (the kernel's stamps), its host-memory
    bytes, and the launches.  Returns the shard mode's launches on the
    driven path; KEPT["mesh"] holds the kernels line's numbers.  On the
    CPU (``device="cpu"``) the same phase rehearses with the plain
    versions in place of both kernels."""
    from kube_batch_tpu_torch.models.shipping import DeviceResidentShipper
    from kube_batch_tpu_torch.models.synthetic import (SteadyChurn,
                                                       make_synthetic_cache,
                                                       make_synthetic_inputs)
    from kube_batch_tpu_torch.ops import evict_solver, prefilter
    from kube_batch_tpu_torch.ops import solver as solver_mod
    from kube_batch_tpu_torch.ops import topo_solver as ts
    from kube_batch_tpu_torch.ops.scan import ScanStatics
    from kube_batch_tpu_torch.parallel import make_mesh, use_mesh
    from kube_batch_tpu_torch.parallel.mesh import (gathered,
                                                    shard_solver_inputs)
    from kube_batch_tpu_torch.parallel.sharded_solver import \
        solve_allocate_sharded_plain
    cuda = device == "cuda"
    shard_fn = cuda_solver.solve_allocate_cuda_sharded
    single = (cuda_solver.solve_allocate_cuda if cuda
              else cuda_solver.solve_allocate_plain)

    def sync():
        if cuda:
            wait_device("the mesh phase's work")

    mesh = make_mesh(MESH_SHARDS, [device])
    # The gate decides on its own (SHARD_NODES, SHARD_BYTES as set; the
    # CPU rehearsal lowers SHARD_NODES to its small shape).
    os.environ.pop(solver_mod.FORCE_SHARD_ENV, None)
    solver_mod.refresh_shard_knobs()
    staging, cfg = make_synthetic_inputs(*shape, seed=0,
                                         dtype=torch.float32, device="cpu")
    # The fused session's single-device arm launches single-device K1:
    # before the counted window.
    chip_fused = mesh_fused_arm(device, False, fused)

    # ---- the driven path --------------------------------------------------
    shard_fn.launches = 0
    cuda_solver.solve_allocate_cuda.launches = 0
    times = {}
    with use_mesh(mesh):
        route, gate_mesh = solver_mod.choose_solver_mesh(staging)
        if (route, gate_mesh) != ("sharded", mesh):
            raise AssertionError(f"the mesh gate routed {shape} to {route}")
        shipper = DeviceResidentShipper(device)
        t0 = time.perf_counter()
        resident = shipper.ship(staging, cfg, torch.float32)
        sync()
        times["ship_ms"] = (time.perf_counter() - t0) * 1e3
        if type(shipper._state).__name__ != "_ShardShipState":
            raise AssertionError("the shipper did not keep the sharded "
                                 "layout")
        t0 = time.perf_counter()
        fetched = solver_mod.fetch_solve(solver_mod.dispatch_solve(resident,
                                                                   cfg))
        times["dispatch_fetch_ms"] = (time.perf_counter() - t0) * 1e3
        north_shards = tuple(shard_fn.last_shards)
        held_inputs = type(resident)(*(t.clone() for t in resident))

        # tpu-allocate on the forced mesh: full, clean, delta.
        with env_arm({solver_mod.FORCE_SHARD_ENV: "1"}):
            solver_mod.refresh_shard_knobs()
            tiers = _register(device)
            from kube_batch_tpu_torch.actions.tpu_allocate import \
                TpuAllocateAction
            action = TpuAllocateAction(device=device, dtype=torch.float32)
            cache, binder = make_synthetic_cache(*session)
            # A pending gang no node fits keeps a backlog, so a session
            # with nothing changed ships clean (the reference's reuse
            # protocol, tests/test_shard_ship.py).
            add_gang(cache, "mesh-hog", 1, cpu="4000")
            churn = SteadyChurn(cache, binder, session[0], session[3])
            records, modes = [], []
            for step in ("full", "echoed", "clean", "delta"):
                if step == "delta":
                    add_gang(cache, "mesh-delta", 4)
                mesh_session(cache, tiers, action)
                sh = cache._ship_cache
                modes.append((sh.last_mode, sh.generation,
                              bool(action.last.reused)))
                if not action.last.reused:
                    records.append(capture_launch(action))
                if step in ("full", "echoed"):
                    churn.echo()
            if (modes[0][0], modes[2], modes[3][0], modes[3][2]) != (
                    "full", ("clean", modes[1][1], True), "delta", False):
                raise AssertionError(f"the per-shard shipper went {modes}")
            # A candidate-row solve gathered per shard, on a small
            # backlog's sharded resident image at the full node width
            # (the prefilter's case: a micro session's few pending pods).
            cinp, ccfg = make_synthetic_inputs(
                candidate_tasks, shape[1], 4, 2, seed=3, dtype=torch.float32,
                device="cpu")
            snap = type("Snap", (), {})()
            snap.inputs, snap.config = cinp, ccfg
            snap.tasks = [None] * int(cinp.job_count.sum())
            cand = prefilter.derive_candidates(snap, "sharded", mesh)
            if cand is None or not cand.sharded:
                raise AssertionError(f"no sharded candidate set at "
                                     f"{candidate_tasks} x {shape[1]}")
            cres = DeviceResidentShipper(device).ship(cinp, ccfg,
                                                      torch.float32)
            cand_got = solver_mod.fetch_solve(solver_mod.dispatch_solve(
                cres, ccfg, candidates=cand))
            cand_inputs = type(cres)(*(t.clone() for t in cres))
            mesh_fused = mesh_fused_arm(device, True, fused)
        solver_mod.refresh_shard_knobs()
    launches = shard_fn.launches
    singles = cuda_solver.solve_allocate_cuda.launches
    if cuda and (launches == 0 or singles != 0):
        raise AssertionError(f"the mesh path launched the shard mode "
                             f"{launches} times and single-device K1 "
                             f"{singles} times")

    # ---- holds ------------------------------------------------------------
    whole = gathered(held_inputs)
    t0 = time.perf_counter()
    want = single(whole, cfg)
    sync()
    err = same_result(fetched[:3], (want[0].assignment, want[0].kind,
                                    want[0].order), "mesh fetch vs K1")
    if cuda:
        n_local = shape[1] // MESH_SHARDS
        first = north_shards[0][0]
        for s, (res, final) in enumerate(north_shards):
            same_result((res,), (first,), f"shard {s}'s replicated outputs")
            lo, hi = s * n_local, (s + 1) * n_local
            if not torch.equal(final.node_int, want[1].node_int[:, lo:hi]):
                raise AssertionError(f"shard {s}'s final node slice != K1's")
    for i, rec in enumerate(records):
        got = (rec.assignment, rec.kind, rec.order)
        ref = single(gathered(rec.inputs), rec.snap.config)[0]
        same_result(got, (ref.assignment, ref.kind, ref.order),
                    f"mesh session {i} vs K1")
    # The prefilter is exact: the gathered solve places as the full one.
    ref_full = single(gathered(cand_inputs), ccfg)[0]
    same_result(cand_got[:3], (ref_full.assignment, ref_full.kind,
                               ref_full.order), "mesh candidate solve vs K1")
    if (mesh_fused["layout"], chip_fused["layout"]) != (
            "_ShardShipState", "_ShipState"):
        raise AssertionError(f"fused layouts {mesh_fused['layout']} / "
                             f"{chip_fused['layout']}")
    for key in ("state", "evicts", "binds"):
        if mesh_fused[key] != chip_fused[key]:
            raise AssertionError(f"the fused mesh session's {key} != the "
                                 f"single-device session's")
    if not mesh_fused["evicts"]:
        raise AssertionError("the fused mesh session evicted nothing")

    # The sharded eviction scan against the single-device scan.
    r = staging.task_req.shape[1]
    np_pad, ns_pad = staging.task_ports.shape[1], staging.task_aff_req.shape[1]
    trows = np.zeros((8, 1 + r + np_pad + 4 * ns_pad), np.int32)
    for i in range(8):
        trows[i, 0] = int(staging.task_sig[i])
        trows[i, 1:1 + r] = staging.task_res[i].numpy()
    rng = np.random.RandomState(0)
    vic_node = rng.randint(0, shape[1], 64).astype(np.int32)
    vic_rank = rng.permutation(64).astype(np.int32)
    dev_t = [torch.as_tensor(a, device=device) for a in (trows, vic_node,
                                                        vic_rank)]
    statics = ScanStatics(*(getattr(held_inputs, f).clone()
                            for f in ScanStatics._fields))
    ev_sh = evict_solver.dispatch_evict_batch_solve(
        cfg, r, np_pad, ns_pad, statics, None, *dev_t, resident=held_inputs)
    dyn = torch.cat([whole.node_used, whole.node_count[:, None],
                     whole.node_ports.to(torch.int32), whole.node_selcnt],
                    dim=1).to(torch.int32)
    ev_1 = evict_solver.evict_batch_solve(
        cfg, r, np_pad, ns_pad, ScanStatics(*(getattr(whole, f)
                                              for f in ScanStatics._fields)),
        dyn, *dev_t)
    for a, b, what in ((ev_sh[0], ev_1[0], "scores"),
                       (ev_sh[1], ev_1[1], "victim order")):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"the sharded eviction {what} != one "
                                 f"device's")

    # The origin-sharded box scan against the single-device scan.
    from kube_batch_tpu_torch.models.synthetic import make_topo_cache
    from kube_batch_tpu_torch.models import topology
    tcache, _ = make_topo_cache(dims=topo_dims, slice_shape="2x2x2")
    view = topology.build_view(tcache.nodes)
    n = len(view.node_names)
    n_pad = -(-n // MESH_SHARDS) * MESH_SHARDS
    coords = np.full((n_pad, topology.COORD_WIDTH), -1, np.int32)
    coords[:n] = view.coords[:n]
    free = np.zeros(n_pad, bool)
    free[:n] = rng.random_sample(n) < 0.6
    evictable = ~free & (rng.random_sample(n_pad) < 0.5)
    vc = rng.randint(0, 4, n_pad).astype(np.int32)
    box = ts.BoxInputs(coords, free, evictable, vc, vc * 11)
    box_sh = ts.box_scan_sharded(box, 2, 2, 2, mesh).cpu()
    box_1 = ts.box_scan(ts.stage_box_inputs(box, device), 2, 2, 2).cpu()
    if not torch.equal(box_sh, box_1):
        raise AssertionError("the origin-sharded box scan != one device's")

    # The shard mode at the small shape against its plain version.
    sinp, scfg = make_synthetic_inputs(*small, seed=3, dtype=torch.float32,
                                       device=device)
    sharded_small = shard_solver_inputs(sinp, mesh)
    t0 = time.perf_counter()
    kout = (shard_fn(sharded_small, scfg) if cuda
            else solve_allocate_sharded_plain(sharded_small, scfg, mesh))
    sync()
    small_ms = (time.perf_counter() - t0) * 1e3
    host = shard_solver_inputs(type(sinp)(*(t.cpu() for t in sinp)),
                               make_mesh(MESH_SHARDS, ["cpu"]))
    t0 = time.perf_counter()
    pout = solve_allocate_sharded_plain(host, scfg)
    plain_ms = (time.perf_counter() - t0) * 1e3
    small_err = same_result(kout, pout, "shard mode vs its plain version")

    # ---- times --------------------------------------------------------------
    timing = dict(single_ms=None, shard_ms=None,
                  exchange_us_per_placement=None)
    if cuda:
        from kube_batch_tpu_torch.parallel.mesh import shard_mesh
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        runs = {"single": [], "shard": []}
        # One untimed launch of each first: the card has sat idle through
        # the plain version on the host, and its first launch after that
        # ran 40% slow in a trial.
        shard_fn(held_inputs, cfg)
        cuda_solver.solve_allocate_cuda(whole, cfg)
        for _ in range(2):
            for name in ("shard", "single"):
                start.record()
                if name == "shard":
                    shard_fn(held_inputs, cfg)
                else:
                    cuda_solver.solve_allocate_cuda(whole, cfg)
                stop.record()
                torch.cuda.synchronize()
                runs[name].append(start.elapsed_time(stop))
        stamps = [torch.zeros(len(cuda_solver.PHASES), dtype=torch.int64,
                              device=d) for d in shard_mesh(
                                  held_inputs).devices]
        start.record()
        shard_fn(held_inputs, cfg, stamps=stamps)
        stop.record()
        torch.cuda.synchronize()
        got = dict(zip(cuda_solver.PHASES, stamps[0].tolist()))
        per_us = got["total"] / (start.elapsed_time(stop) * 1e3)
        timing = dict(
            single_ms=float(np.median(runs["single"])),
            shard_ms=float(np.median(runs["shard"])),
            single_ms_all=runs["single"], shard_ms_all=runs["shard"],
            stamped_placements=got["placements"],
            exchange_us_per_placement=got["shard_exchange"] / per_us
            / max(got["placements"], 1),
            cluster_exchange_us_per_placement=got["cluster_exchange"]
            / per_us / max(got["placements"], 1),
            node_scan_us_per_placement=got["node_scan"] / per_us
            / max(got["placements"], 1))
    steps = int(want[0].step)
    bound = bound_of(cuda_solver, whole, want) if cuda else {}
    if cuda:
        # The shards share one card: the single-device bound, plus the
        # exchange's bytes (per placement each shard writes its 16-byte
        # slot and its CTA 0 reads all K slots), at the HBM rate.
        xbytes = steps * MESH_SHARDS * 16 * (1 + MESH_SHARDS)
        bound["bytes_moved"] += xbytes
        bound["bytes_bound_ms"] = bound["bytes_moved"] / HBM_BYTES_PER_S * 1e3
        bound["bound_ms"], bound["bound_by"] = max(
            (bound["bytes_bound_ms"], "bytes"),
            (bound["ops_bound_ms"], "operations"))
    KEPT["mesh"] = dict(launches=launches, ms=timing["shard_ms"],
                        max_abs_err=max(err, small_err), plain_ms=plain_ms,
                        small_ms=small_ms, **{k: bound.get(k) for k in (
                            "bound_ms", "bound_by")})
    phase("mesh", shape=list(shape), shards=MESH_SHARDS,
          devices=[str(d) for d in mesh.devices], steps=steps,
          launches=launches, single_launches_on_path=singles,
          exchange_bytes=shard_fn.last_exchange_bytes if cuda else 0,
          ship_modes=modes, max_abs_err=err, small_shape=list(small),
          small_ms=small_ms, plain_ms=plain_ms, small_max_abs_err=small_err,
          candidate_rows=cand.count, fused_wall_ms=dict(
              chip=chip_fused["wall_ms"], mesh=mesh_fused["wall_ms"]),
          fused_evictions=len(mesh_fused["evicts"]), **times, **timing,
          shard_build_s=cuda_solver._ShardKernel.build_seconds,
          shard_built=cuda_solver._ShardKernel.built, **bound, card=card)
    return launches


def mesh_kernel_entry(launches: int) -> dict:
    """The kernels line's entry of K1's shard mode (mesh_phase's
    numbers): its launches on the mesh path, its time per solve at
    MESH_SHAPE, the plain version's at MESH_SMALL, the bound."""
    got = KEPT["mesh"]
    return {
        "name": "solve_session_shard_mode", "route": "cuda",
        "source": "kube_batch_tpu_torch/csrc/solve_session.cu",
        "replaces": "kube_batch_tpu/ops/pallas_solver.py:60",
        "mode_of": "solve_session (K1) on the node-sharded mesh, in place of "
                   "kube_batch_tpu/parallel/sharded_solver.py:113",
        "launches": launches, "max_abs_err": got["max_abs_err"],
        "ms": got["ms"], "ms_shape": list(MESH_SHAPE),
        "plain_ms": got["plain_ms"], "plain_shape": list(MESH_SMALL),
        "small_ms": got["small_ms"], "bound_ms": got["bound_ms"],
        "bound_by": got["bound_by"], "library_ms": None}


def add_gang(cache, name: str, size: int, cpu: str = "250m") -> None:
    """One pending gang of ``size`` pods of ``cpu`` in queue q0 of a
    make_synthetic_cache cluster."""
    from kube_batch_tpu_torch.api.objects import (Container, ObjectMeta, Pod,
                                                  PodSpec, PodStatus)
    from kube_batch_tpu_torch.apis.scheduling import v1alpha1
    cache.add_pod_group(v1alpha1.PodGroup(
        metadata=ObjectMeta(name=name, namespace="bench"),
        spec=v1alpha1.PodGroupSpec(min_member=1, queue="q0")))
    for i in range(size):
        cache.add_pod(Pod(
            metadata=ObjectMeta(
                name=f"{name}-{i}", namespace="bench", uid=f"{name}-{i}",
                annotations={v1alpha1.GroupNameAnnotationKey: name},
                creation_timestamp=1e6 + i),
            spec=PodSpec(containers=[Container(
                requests={"cpu": cpu, "memory": "512Mi"})]),
            status=PodStatus(phase="Pending")))


def mesh_session(cache, tiers, action) -> None:
    """open_session -> tpu-allocate -> close_session; raises unless the
    action solved on the device (a launch or a reused solve)."""
    from kube_batch_tpu_torch.framework import close_session, open_session
    action.last = None
    ssn = open_session(cache, tiers)
    try:
        action.execute(ssn)
    finally:
        close_session(ssn)
    if action.last is None:
        raise AssertionError("the mesh session solved nothing on the "
                             "device")


class Child:
    """``python3 chip_smoke.py <argv>`` (``program`` in place of this
    script, where given) in a process (and session) of its own beside
    this one's phases, its output in build/daemon/<name>.out and .err.
    ``join`` waits for it, relays its standard output and fails unless
    it exited 0; every child still running is stopped at exit, whatever
    failed (stop_live)."""

    LIVE = set()

    def __init__(self, name: str, argv: list, program=None):
        os.makedirs(DAEMON_DIR, exist_ok=True)
        self.name = name
        self.out_path = os.path.join(DAEMON_DIR, f"{name}.out")
        self.err_path = os.path.join(DAEMON_DIR, f"{name}.err")
        self.began = time.perf_counter()
        with open(self.out_path, "w") as out, open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, program or os.path.abspath(__file__),
                 *argv],
                stdout=out, stderr=err, cwd=REPO, start_new_session=True)
        self.ended = None
        threading.Thread(target=self._stamp_exit, daemon=True,
                         name=f"{name}-exit").start()
        Child.LIVE.add(self)

    def _stamp_exit(self) -> None:
        self.proc.wait()
        self.ended = time.perf_counter()

    def join(self, seconds: float) -> list:
        """Wait at most ``seconds``; relay the child's output lines and
        return its phase lines (parsed).  Raises if it ran over or exited
        with another code than 0."""
        joined = time.perf_counter()
        try:
            rc = self.proc.wait(seconds)
        except subprocess.TimeoutExpired:
            self.stop()
            raise AssertionError(f"{self.name}: still running after "
                                 f"{seconds} s")
        Child.LIVE.discard(self)
        with open(self.out_path) as f:
            lines = f.read().splitlines()
        for line in lines:
            print(line, flush=True)
        if rc:
            with open(self.err_path) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"{self.name} exited with {rc}:\n{tail}")
        phases = []
        for line in lines:
            with contextlib.suppress(ValueError):
                doc = json.loads(line)
                if isinstance(doc, dict) and "phase" in doc:
                    phases.append(doc)
        now = time.perf_counter()
        ended = self.ended or now
        # wall_s: from the start to the child's exit; waited_s: how long
        # this process waited for it at the join.
        phase("child", child=self.name, wall_s=ended - self.began,
              waited_s=max(0.0, ended - joined), joined_s=now - self.began)
        return phases

    def stop(self) -> None:
        """SIGKILL to the child's whole process group (its own daemons
        and servers too)."""
        Child.LIVE.discard(self)
        if self.proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(self.proc.pid, 9)
            self.proc.wait(30)

    @classmethod
    def stop_live(cls) -> None:
        for child in list(cls.LIVE):
            child.stop()


def north_star_plain(out_path: str, shape=NORTH_STAR, device="cuda") -> None:
    """The main path's plain version, run in a process of its own
    (``python3 chip_smoke.py north-star-plain OUT``) so that it runs
    beside the edge phases: make_synthetic_inputs(*shape, seed=0) in
    float32, a full ship through a resident shipper onto ``device`` (as
    the main path's first ship), then solve_allocate_plain there, timed.
    Saves the shipped inputs' digest (LaunchLedger.digest), the result
    and final buffers on the CPU and ``plain_ms`` to ``out_path``: the
    main path holds its launch against them once the digests agree
    (load_north_star_plain)."""
    from kube_batch_tpu_torch.models.shipping import resident_shipper
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
    from kube_batch_tpu_torch.ops import cuda_solver

    class Owner:
        pass

    inp, cfg = make_synthetic_inputs(*shape, seed=0, dtype=torch.float32,
                                     device=device)
    shipped = resident_shipper(Owner(), device).ship(inp, cfg)
    card = shipped.node_idle.device.type == "cuda"
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, final = cuda_solver.solve_allocate_plain(shipped, cfg)
    if card:
        torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    torch.save(dict(digest=LaunchLedger.digest(shipped, cfg),
                    res=[t.cpu() for t in res], final=[t.cpu() for t in final],
                    plain_ms=plain_ms, device=str(shipped.node_idle.device)),
               out_path)
    phase("north-star-plain", shape=list(shape),
          device=str(shipped.node_idle.device), plain_ms=plain_ms)


def load_north_star_plain(out_path: str, shipped, cfg):
    """north_star_plain's result as (SolveResult, FinalState) of CPU
    tensors and its ``plain_ms``; raises unless it ran on inputs
    byte-equal to ``shipped``."""
    from kube_batch_tpu_torch.ops.cuda_solver import FinalState
    from kube_batch_tpu_torch.ops.solver import SolveResult
    saved = torch.load(out_path)
    if saved["digest"] != LaunchLedger.digest(shipped, cfg):
        raise AssertionError("north-star-plain: its inputs differ from the "
                             "main path's full ship")
    return ((SolveResult(*saved["res"]), FinalState(*saved["final"])),
            saved["plain_ms"])


DRILL_PHASES = (degrade_deadline_phase, profile_phase, degrade_solve_phase,
                degrade_evict_phase, degrade_topo_phase, degrade_fused_phase,
                degrade_shard_phase, degrade_mesh_phase,
                tensorize_limit_phase)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["fused"]:
        return fused_only()
    if sys.argv[1:] == ["daemon"]:
        return daemon_only()
    if sys.argv[1:] == ["tools"]:
        return tools_only()
    if sys.argv[1:] == ["mesh"]:
        return mesh_only()
    if sys.argv[1:2] == ["north-star-plain"] and len(sys.argv) == 3:
        north_star_plain(sys.argv[2])
        return 0
    from kube_batch_tpu_torch.models.shipping import resident_shipper
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
    from kube_batch_tpu_torch.ops import cuda_solver
    from kube_batch_tpu_torch.ops.solver import dispatch_solve, fetch_solve

    card = card_line()
    kind_name = torch.cuda.get_device_name(0)
    phase("device", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())

    # The daemon boots first: its cold boot builds K1 into the directory
    # this process then loads it from.  Then the daemon over the network
    # edge, held against the daemon phase's in-process cycle, and replica
    # federation over the edge.
    daemon_launches = guarded(daemon_phase, cuda_solver, card,
                              edge_server=True)
    # The main path's plain version on the card runs in a process of its
    # own beside the two edge phases (north_star_plain), which leave the
    # host's cores mostly idle; the main path holds its launch against it.
    plain_path = os.path.join(DAEMON_DIR, "north-star-plain.pt")
    plain_child = Child("north-star-plain", ["north-star-plain", plain_path])
    # K1's shard mode is a library of its own: its nvcc runs there too, in
    # a thread (at exit the interpreter waits for it); the mesh phase
    # waits for it, and builds it itself if this build failed.
    shard_build = threading.Thread(target=cuda_solver.build_shard_kernel,
                                   name="shard-build")
    shard_build.start()
    guarded(daemon_edge_phase, cuda_solver, card)
    guarded(edge_federation_phase, cuda_solver, card)
    main_before = fused_counters()
    began = time.perf_counter()
    cuda_solver.build_kernel()
    phase("build", seconds=time.perf_counter() - began,
          built=cuda_solver._Kernel.built,
          library=str(cuda_solver._Kernel.path),
          ptxas=cuda_solver._Kernel.build_log.strip().splitlines()[-6:])
    if cuda_solver._Kernel.built:
        raise AssertionError("build: the script ran nvcc a second time "
                             "after the daemon's cold boot built K1")
    from kube_batch_tpu_torch import native
    phase("native", **native.status())
    if not native.status()["loaded"] \
            and not os.environ.get("KUBE_BATCH_TPU_NO_NATIVE"):
        raise AssertionError("the C host walk did not load")

    # The matrix's plain versions run on the host's CPU, as the holds run
    # them (the same code on the same values, faster there), in worker
    # processes while this process launches the kernel on each case and
    # drives the main path and the phases after it; they are compared
    # before the kernels line.
    cases = [(dtype, name, inp, cfg)
             for dtype in (torch.float32, torch.float64)
             for name, (inp, cfg) in matrix(dtype)]
    host_plains = HostPlains([(inp, cfg) for _, _, inp, cfg in cases])
    kouts = []
    for dtype, name, inp, cfg in cases:
        kouts.append(cuda_solver.solve_allocate_cuda(inp, cfg))
        wait_device(f"the kernel on {name}")

    # ---- the main path at the north-star shape ---------------------------
    inp, cfg = make_synthetic_inputs(*NORTH_STAR, seed=0,
                                     dtype=torch.float32)
    n_nodes = NORTH_STAR[1]
    churned = inp._replace(node_used=inp.node_used.clone(),
                           node_idle=inp.node_idle.clone())
    churned.node_used[:4, 0] += 500    # a few node rows change
    churned.node_idle[:4, 0] -= 500
    stagings = (("full", inp), ("delta", churned), ("clean", churned))

    class Owner:
        pass

    owner = Owner()
    cuda_solver.solve_allocate_cuda.launches = 0
    results = []
    for expect, staging in stagings:
        t0 = time.perf_counter()
        shipper = resident_shipper(owner)
        shipped = shipper.ship(staging, cfg)
        torch.cuda.synchronize()
        ship_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        fetched = fetch_solve(dispatch_solve(shipped, cfg))
        solve_ms = (time.perf_counter() - t0) * 1e3
        if expect == "full":
            # The full ship's inputs, kept before the delta ship rewrites
            # the resident leaves in place: the plain check below runs
            # on them (tenancy-streams' seed-0 solo launch is byte-equal).
            full = type(shipped)(*(t.clone() for t in shipped))
        results.append((shipped, fetched))
        phase("ship+solve", mode=shipper.last_mode, bytes=shipper.last_bytes,
              generation=shipper.generation, ship_ms=ship_ms,
              dispatch_fetch_ms=solve_ms)
        if shipper.last_mode != expect:
            raise AssertionError(f"expected a {expect} ship, got "
                                 f"{shipper.last_mode}")
    launches = cuda_solver.solve_allocate_cuda.launches
    if launches != len(stagings):
        raise AssertionError(f"the main path launched the kernel {launches} "
                             f"times for {len(stagings)} sessions")

    placed = []
    for shipped, (assignment, kind, order, ordered) in results:
        placed.append(validate(shipped, assignment, kind, order, ordered,
                               n_nodes))
    if results[1][1][0].tobytes() != results[2][1][0].tobytes():
        raise AssertionError("a clean ship changed the solve's result")

    # Once against the plain version on the card, on the full ship's
    # inputs (cloned above: the delta ship rewrote the resident leaves;
    # the plain child's are byte-equal to them): plain_ms is the card's
    # time for the plain version.
    shipped, fetched = full, results[0][1]
    kout = cuda_solver.solve_allocate_cuda(shipped, cfg)
    torch.cuda.synchronize()
    plain_child.join(600)
    pout, plain_ms = load_north_star_plain(plain_path, shipped, cfg)
    max_err = compare(kout, pout)
    if max_err:
        raise AssertionError(f"kernel != plain at the north-star shape: "
                             f"max abs err {max_err}")
    if not np.array_equal(fetched[0], kout[0].assignment.cpu().numpy()):
        raise AssertionError("dispatch/fetch result differs from the kernel")
    LaunchLedger.note_held(shipped, cfg, tuple(
        t.cpu().numpy() for t in (pout[0].assignment, pout[0].kind,
                                  pout[0].order)))
    steps = int(kout[0].step)
    # The same inputs with the cluster bound forced to 8, as on a card
    # that cannot host 16 CTAs: more rows in global memory, same answer.
    k8 = cuda_solver.solve_allocate_cuda(shipped, cfg, max_cluster=8)
    wait_device("the kernel at the north star with 8 CTAs")
    err8 = compare(k8, pout)
    if err8:
        raise AssertionError(f"kernel at 8 CTAs != plain at the north star: "
                             f"max abs err {err8}")
    phase("kernel-vs-plain", case="north-star-cluster-bound-8",
          dtype=str(torch.float32), steps=int(k8[0].step), max_abs_err=err8,
          **plan_fields(cuda_solver, shipped, cfg, 8))

    rounds = []
    for _ in range(7):
        t0 = time.perf_counter()
        fetch_solve(dispatch_solve(shipped, cfg))
        rounds.append((time.perf_counter() - t0) * 1e3)

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    reps = 3
    kernel_ms = []
    for _ in range(reps):
        start.record()
        cuda_solver.solve_allocate_cuda(shipped, cfg)
        stop.record()
        torch.cuda.synchronize()
        kernel_ms.append(start.elapsed_time(stop))
    kernel_ms = float(np.median(kernel_ms))
    phase("kernel-phases", **phase_split(cuda_solver, shipped, cfg))

    bound = bound_of(cuda_solver, shipped, kout)
    bound_ms, bound_by = bound["bound_ms"], bound["bound_by"]

    phase("main-path", shape=list(NORTH_STAR), placed=placed, steps=steps,
          launches=launches, dispatch_fetch_ms_median=float(np.median(rounds)),
          dispatch_fetch_ms_p90=float(np.percentile(rounds, 90)),
          dispatch_fetch_ms_all=rounds, kernel_ms=kernel_ms,
          plain_ms=plain_ms, **bound, card=card)

    no_fallback_since(main_before, "main-path")

    # From here the large holds of the plain version run in worker
    # processes beside the card work, checked before the kernels line.
    DeferredHolds.start()
    # The node-sharded mesh on 4 shards of the card: K1's shard mode.
    shard_build.join()
    mesh_launches = guarded(mesh_phase, cuda_solver, card)
    session_launches = guarded(session_phase, cuda_solver, card)
    # The verification harnesses (kube_batch_tpu_torch/tools/) run in a
    # process of their own (``python3 chip_smoke.py tools``) beside the
    # phases up to topo-vs-cpu, none of which gates on a time; their K1
    # launches and holds join this run's counts.
    tools_child = Child("tools", ["tools"])
    warmup_launches = guarded(warmup_phase, cuda_solver, card)
    guarded(session_vs_cpu_phase, cuda_solver)
    steady_launches = guarded(steady_phase, cuda_solver, card)
    evict_launches = guarded(evict_phase, cuda_solver, card)
    guarded(evict_vs_cpu_phase, cuda_solver)
    topo_launches = guarded(topo_phase, cuda_solver, card)
    guarded(topo_vs_cpu_phase, cuda_solver)
    tools_launches = tools_child_counts(tools_child.join(900))
    streams_launches = guarded(tenancy_streams_phase, cuda_solver, card)
    tenancy_launches = guarded(tenancy_phase, cuda_solver, card)
    backlog_launches = guarded(tenancy_backlog_phase, cuda_solver, card)
    loop_launches = guarded(scheduler_loop_phase, cuda_solver, card)
    fused_launches = sum(guarded(run, cuda_solver, card)
                         for run in FUSED_PHASES)
    # The drills inject their own faults and check exactly those; the
    # breaker is closed again after each.
    drill_launches = sum(run(cuda_solver, card) for run in DRILL_PHASES)
    DeferredHolds.drain()
    # The matrix's plain versions ran in their workers beside the phases
    # since the main path.
    for (dtype, name, inp, cfg), kout, pout in zip(
            cases, kouts, host_plains.results()):
        err = compare(kout, pout)
        if err:
            raise AssertionError(f"kernel != plain on {name} {dtype}: "
                                 f"max abs err {err}")
        phase("kernel-vs-plain", case=name, dtype=str(dtype),
              steps=int(kout[0].step), max_abs_err=err,
              **plan_fields(cuda_solver, inp, cfg))
    del cases, kouts

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "solve_session", "route": "cuda",
        "source": "kube_batch_tpu_torch/csrc/solve_session.cu",
        "replaces": "kube_batch_tpu/ops/pallas_solver.py:60",
        "launches": (daemon_launches + session_launches + warmup_launches
                     + steady_launches + evict_launches
                     + topo_launches + streams_launches + tenancy_launches
                     + backlog_launches + loop_launches + fused_launches
                     + drill_launches + tools_launches),
        # K1's launches in the daemons' own processes (their /metrics
        # routes and warmup manifests), held pod for pod by placement.
        "launches_in_daemons": KEPT.get("daemon_launches", 0),
        "held_vs_plain": LaunchLedger.counts["plain"],
        "held_byte_equal": LaunchLedger.counts["byte_equal"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}, mesh_kernel_entry(mesh_launches)]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def fused_only() -> int:
    """``python3 chip_smoke.py fused``: the build and the five fused
    phases alone (a shorter run while working on them); prints no
    kernels line and no result line."""
    from kube_batch_tpu_torch.ops import cuda_solver
    card = card_line()
    phase("device", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())
    began = time.perf_counter()
    cuda_solver.build_kernel()
    phase("build", seconds=time.perf_counter() - began)
    DeferredHolds.start()
    launches = sum(guarded(run, cuda_solver, card) for run in FUSED_PHASES)
    DeferredHolds.drain()
    phase("fused-only", launches=launches, held=LaunchLedger.counts)
    return 0


def daemon_only() -> int:
    """``python3 chip_smoke.py daemon``: the daemon phase, daemon-edge,
    edge-federation, the build (a load), a 2-session session phase,
    warmup and tensorize-limit alone (a shorter run while working on
    them); prints no kernels line and no result line."""
    from kube_batch_tpu_torch.ops import cuda_solver
    card = card_line()
    phase("device", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())
    launches = guarded(daemon_phase, cuda_solver, card, edge_server=True)
    guarded(daemon_edge_phase, cuda_solver, card)
    guarded(edge_federation_phase, cuda_solver, card)
    began = time.perf_counter()
    cuda_solver.build_kernel()
    phase("build", seconds=time.perf_counter() - began,
          built=cuda_solver._Kernel.built)
    DeferredHolds.start()
    launches += guarded(session_phase, cuda_solver, card, sessions=2)
    launches += guarded(warmup_phase, cuda_solver, card)
    launches += tensorize_limit_phase(cuda_solver, card)
    DeferredHolds.drain()
    phase("daemon-only", launches=launches, held=LaunchLedger.counts)
    return 0


def mesh_only() -> int:
    """``python3 chip_smoke.py mesh``: the build, the mesh phase and its
    drills alone (K1's shard mode on 4 shards of the card); prints the
    shard mode's kernels entry and no result line."""
    from kube_batch_tpu_torch.ops import cuda_solver
    card = card_line()
    phase("device", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())
    began = time.perf_counter()
    cuda_solver.build_kernel()
    phase("build", seconds=time.perf_counter() - began,
          built=cuda_solver._Kernel.built,
          ptxas=cuda_solver._Kernel.build_log.strip().splitlines()[-6:])
    launches = guarded(mesh_phase, cuda_solver, card)
    degrade_mesh_phase(cuda_solver, card)
    print(json.dumps({"kernels": [mesh_kernel_entry(launches)]}), flush=True)
    return 0


def tools_only() -> int:
    """``python3 chip_smoke.py tools``: the build and the three harness
    phases alone (scenarios, chaos-soak, replica-soak); prints no
    kernels line and no result line."""
    from kube_batch_tpu_torch.ops import cuda_solver
    card = card_line()
    phase("device", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())
    began = time.perf_counter()
    cuda_solver.build_kernel()
    phase("build", seconds=time.perf_counter() - began,
          built=cuda_solver._Kernel.built)
    launches = tools_phases(cuda_solver, card)
    phase("tools-only", launches=launches, held=LaunchLedger.counts)
    return 0


def tools_child_counts(phases: list) -> int:
    """The K1 launches of a ``tools`` child (its ``tools-only`` line);
    its holds join LaunchLedger.counts."""
    (done,) = [p for p in phases if p["phase"] == "tools-only"]
    for way, n in done["held"].items():
        LaunchLedger.counts[way] += n
    return done["launches"]


if __name__ == "__main__":
    import atexit
    atexit.register(EdgeServer.stop_live)
    atexit.register(Child.stop_live)
    sys.exit(main())
