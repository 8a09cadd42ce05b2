"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. device: the card's name and power limit; exits non-zero without CUDA;
  2. build: compiles csrc/solve_session.cu with nvcc and prints the seconds;
     native: the C host walk (native/fastpath.c, built with cc at import)
     must have loaded unless KUBE_BATCH_TPU_NO_NATIVE is set;
  3. kernel against plain: the session-solve kernel must equal its plain
     PyTorch version exactly (assignment, kind, order, step and the final
     node, job and queue buffers) on the test matrix and on cases that
     launch it as clusters of every size its plan takes, in float32 and
     float64; each line names the cluster size and shared memory;
  4. main path at the north-star shape (50k pods x 10k nodes x 2k jobs x
     4 queues, float32): full, delta and clean ships through the resident
     shipper, each followed by dispatch_solve -> fetch_solve on the cuda
     route with the kernel's launch count reset just before and read just
     after; the result is validated, compared once with the plain version
     on the card, and timed (7 warm dispatch -> fetch rounds, and the
     kernel alone with CUDA events); one more launch with the kernel's
     phase stamps on prints the phase split (`kernel-phases`: cluster
     size, shared memory, microseconds per phase, per placement, per
     pop); the same inputs with the cluster bound forced to 8 must equal
     the plain version too;
  5. session, the slice's main path at the north star, in two arms: the
     C host walk (the default) and the KUBE_BATCH_TPU_NO_NATIVE=1 control
     (native_arm), taking turns.  Per arm, make_synthetic_cache through
     the SchedulerCache's ingestion, then one cold and five warm sessions of
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
  6. session-vs-cpu: one 5k x 1k session on the card and on the CPU (the
     plain route) must give the same binds in the same order and the
     same pod-group statuses;
  7. steady and steady-hetero: the steady state at 1% churn per round,
     default arm against KUBE_BATCH_TPU_INCREMENTAL=0 (see steady_phase);
  8. evict: the eviction engine at the north star — the shipped
     four-action conf (reclaim, tpu-allocate, backfill, preempt) on
     make_churn_cache(50k, 10k, 2k, 4), one warm cycle per
     KUBE_BATCH_TPU_BATCH_EVICT arm then off/on/on/off on fresh caches;
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
     off/on/on/off: equal binds, events and lineage, a pipeline that
     overlapped, every shard's launches on its own view's stream, no
     shard failure and no host fallback, every launch held against the
     plain version (see tenancy_phase); then tenancy-backlog, the
     concurrent arm with one tenant's backlog at 2,500, 10,000 and
     30,000 pods against 4-pod neighbours: whether the next shard's
     begin half returns while that solve is still on the card
     (tenancy_backlog_phase);
 13. scheduler-loop: Scheduler(cache).run() on the card at 5k x 1k: the
     loop thread's first cycle binds, a churned pod wakes and binds,
     stop() within 5 s, each launch held against the plain version (see
     scheduler_loop_phase).
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
        worst = max(worst, int((a.long() - b.long()).abs().max()))
    return worst


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


def session_phase(cuda_solver, card) -> int:
    """The slice's main path at the north star, in both native arms: the
    C host walk and the NO_NATIVE=1 control (native_arm), each on its own
    make_synthetic_cache built through the cache's ingestion.  One cold
    and five warm sessions of open_session -> TpuAllocateAction(cuda,
    float32) -> close_session per arm, the arms taking turns (C first in
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
            for i in range(6):
                for on in ((True, False) if i % 2 == 0 else (False, True)):
                    with native_arm(on):
                        timed_session(cuda_solver, arms[on], tiers, i)
            for on in (True, False):
                with native_arm(on):
                    arms[on]["profile"] = apply_profile(
                        arms[on]["cache"], tiers, arms[on]["action"])
    summary = {on: arm_summary(arms[on], card) for on in (True, False)}
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
        t.clone() if isinstance(t, torch.Tensor) else t
        for t in last.inputs)))


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
    out = solve_vs_plain(cuda_solver, inputs, last.snap.config,
                         (last.assignment, last.kind, last.order),
                         None if cand is None else cand.remap, where)
    return dict(route=last.route, gathered=cand is not None, **out)


def solve_vs_plain(cuda_solver, inputs, cfg, got, remap=None,
                   where: str = "") -> dict:
    """A fetched solve ``got`` (assignment, kind, order) held against
    solve_allocate_plain on ``inputs``: equal exactly, or raise.
    ``remap`` maps gathered rows back to the full-space rows of a
    candidate-row solve's assignment."""
    t0 = time.perf_counter()
    res, _ = cuda_solver.solve_allocate_plain(inputs, cfg)
    if inputs.node_idle.is_cuda:
        torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    assignment = res.assignment.cpu().numpy().astype(np.int64)
    kind = res.kind.cpu().numpy().astype(np.int64)
    order = res.order.cpu().numpy().astype(np.int64)
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
    return dict(placed=int((kind > 0).sum()), steps=int(res.step),
                plain_ms=plain_ms, max_abs_err=err)


def held_summary(records) -> dict:
    """The phase-line summary of launches held against the plain
    version."""
    if not records:
        return dict(held=0)
    plain = sorted(r["plain_ms"] for r in records)
    return dict(held=len(records),
                max_abs_err=max(r["max_abs_err"] for r in records),
                gathered=sum(r["gathered"] for r in records),
                placed=[r["placed"] for r in records],
                plain_ms_median=float(np.median(plain)),
                plain_ms_total=float(sum(plain)))


def evict_cycle(cuda_solver, shape, batched: bool, device="cuda",
                check_plain=False) -> dict:
    """One session of the shipped four-action conf (reclaim, tpu-allocate,
    backfill, preempt) on a fresh make_churn_cache(*shape) on ``device``,
    float32, under the production GC posture (gc_posture).  Returns each
    action's host-clock time, the victims in order, the binds, the cache
    events, the evictions by action, the shared scanner's stats, the
    session's trace spans summed by name and the session kernel's
    launches (the count set to 0 just before the session and read just
    after).  With ``check_plain``, tpu-allocate's solve is held against
    the plain version right after the action, outside its clock
    (allocate_vs_plain; the record is under ``vs_plain``).  Raises if
    the tasks that stay on a node end over its allocatable
    (over_committed)."""
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
    with batch_evict_arm(batched), gc_posture():
        before = evictions_by_action()
        cuda_solver.solve_allocate_cuda.launches = 0
        sid = tspans.begin_session(bench="evict")
        ssn = open_session(cache, tiers)
        action_ms = {}
        vs_plain = None
        try:
            for a in actions:
                t0 = time.perf_counter()
                a.execute(ssn)
                if device == "cuda":
                    torch.cuda.synchronize()
                action_ms[a.name()] = (time.perf_counter() - t0) * 1e3
                if check_plain and a.name() == "tpu-allocate":
                    vs_plain = allocate_vs_plain(cuda_solver, a)
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
                evicts=list(cache.evictor.evicts),
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


def evict_phase(cuda_solver, card) -> int:
    """The eviction engine at the north star: the shipped four-action conf
    (reclaim, tpu-allocate, backfill, preempt) on make_churn_cache(50k,
    10k, 2k, 4) — every node full of low-priority Running pods and a
    10,000-pod high-priority pending wave split between the occupied
    queues (preempt) and a starved queue (reclaim) — float32 on the card.
    The protocol of bench.py measure_action_pipeline: one warm cycle per
    KUBE_BATCH_TPU_BATCH_EVICT arm, then off/on/on/off, each cycle on a
    fresh cache.  Both arms must evict, with the same victims in the same
    order and the same binds; each batched session makes exactly one
    batched dispatch, on the card; each session launches the session
    kernel exactly once; no node ends over its allocatable.  In each
    arm's warm cycle tpu-allocate's launch is held against the plain
    version on its inputs (allocate_vs_plain), and every timed cycle
    must end as its arm's warm cycle did.  Returns the kernel launches
    of all six cycles."""
    shape = NORTH_STAR
    per_arm = {True: {}, False: {}}
    footprint = {}
    launches = 0
    split = None
    stats = []
    replay = None
    vs_plain = {}
    spans = {True: {}, False: {}}
    for i, arm in enumerate((True, False, False, True, True, False)):
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
             dims=TOPO_DIMS, slice_shape=TOPO_SLICE) -> dict:
    """The reference's two-cycle fragmentation-pressure protocol
    (bench.py _run_topo_arm) on the port, under the production GC
    posture: make_topo_cache(pods=("pod-a",), dims, slice_shape), cycle 1,
    the evicted victims echoed as deletions, the fragmentation stats at
    truth, cycle 2.  ``defrag`` and ``batch`` set KUBE_BATCH_TPU_TOPO_DEFRAG
    and KUBE_BATCH_TPU_TOPO_BATCH (0: the numpy oracle)."""
    from kube_batch_tpu_torch.api import pod_key
    from kube_batch_tpu_torch.models.synthetic import make_topo_cache
    from kube_batch_tpu_torch.models.topology import build_view
    from kube_batch_tpu_torch.scheduler import load_scheduler_conf

    env = {"KUBE_BATCH_TPU_TOPO_BATCH": "1" if batch else "0",
           "KUBE_BATCH_TPU_TOPO_DEFRAG": "1" if defrag else "0"}
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
                for pg in cache.status_updater.pod_groups]
    return dict(build_s=build_s, cycles=[first, second], evicts=evicts,
                frag_after=frag_after, binds=binds, statuses=statuses,
                slice_hosts=[host for key, host in binds if "slice0" in key],
                topo_action=actions[0])


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
    for seed, (sh, st, (inp, cfg), got) in enumerate(zip(
            shippers, streams, staged, solo)):
        with torch.cuda.stream(st):
            phase("tenancy-streams-vs-plain", seed=seed, **solve_vs_plain(
                cuda_solver, sh.ship(inp, cfg), cfg, got[:3],
                where=f"the solo launch of seed {seed}"))

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
                churn_frac=0.05, gangs=None) -> dict:
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
    halves' timings and the records held against the plain version."""
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
        fallbacks = []
        real_fallback = tpu._run_host_fallback
        tpu._run_host_fallback = lambda ssn: (fallbacks.append(ssn.uid),
                                              real_fallback(ssn))
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

        def run_once():
            scheduler.run_once()
            if engine._failures:
                raise AssertionError(f"shard sessions failed: "
                                     f"{engine._failures}")
            if fallbacks:
                raise AssertionError(f"{len(fallbacks)} shard sessions "
                                     f"took the host fallback")

        gang = max(4, int(n_tasks * churn_frac) // max(n_queues, 1))
        gangs = tuple(gangs) if gangs is not None else (gang,) * n_queues
        try:
            with gc_posture(), _BeginProbe(ShardPipeline) as probe:
                for t in range(n_queues):
                    submit_gang(t, f"warm-{t}", 4)
                run_once()
                echo()
                run_once()
                echo()
                if device == "cuda":
                    torch.cuda.synchronize()
                events_mark = len(cache.events)
                overlap0 = shard_overlap_total_ms()
                pipe0 = shard_pipeline_counts()
                probe.reset()
                capturing[0] = True
                cuda_solver.solve_allocate_cuda.launches = 0
                cuda_solver.solve_allocate_cuda.stream_launches = {}
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
            del tpu._run_host_fallback
            del tpu.execute_begin
        if device == "cuda":
            wait_device("the tenancy rounds")
            torch.cuda.synchronize()
        timings = probe.timings()
        held = [record_vs_plain(cuda_solver, rec, "a tenancy shard session")
                for rec in captured]
        if device == "cuda" and len(held) != sum(launches):
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
            begin_timings=timings, held=held)


def tenancy_phase(cuda_solver, card, device="cuda",
                  shape=TENANCY_SHAPE) -> int:
    """The reference's concurrent-shard A/B through a real Scheduler and
    TenancyEngine at the north star's cluster size (tenancy_arm), arms
    CONCURRENT_SHARDS off/on/on/off on fresh caches.  Every round's binds,
    the event stream and the lineage bind samples must be equal across
    the four arms; the concurrent arms must have pipelined (stages
    overlapped, overlap time above 0, two in flight at once); every
    shard's launches must have gone to its own view's stream, a distinct
    stream per shard.  Prints per arm the round walls (median,
    nearest-rank p90), shard sessions per second, launches per round and
    the begin halves that returned while a predecessor's solve was still
    pending on the card, and every launch's record held against the
    plain version (tenancy_arm).  Returns the launches of the four
    arms."""
    arms = []
    for concurrent in (False, True, True, False):
        out = tenancy_arm(cuda_solver, concurrent, device, **shape)
        arms.append((concurrent, out))
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
    base = arms[0][1]
    if not base["fingerprints"][-1]:
        raise AssertionError("the tenancy cell bound nothing")
    for concurrent, out in arms[1:]:
        for key in ("fingerprints", "events", "samples"):
            if out[key] != base[key]:
                raise AssertionError(f"tenancy arms differ in {key} "
                                     f"(concurrent={concurrent})")
    shards = set(range(shape["n_queues"]))
    for concurrent, out in arms:
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
    launches = sum(sum(out["launches"]) for _, out in arms)
    phase("tenancy", nodes=shape["n_nodes"], tenants=shape["n_queues"],
          n_tasks=shape["n_tasks"], gangs=base["gangs"],
          rounds=len(base["walls_ms"]), identical_arms=True,
          binds_per_round=[len(f) for f in base["fingerprints"]],
          events=len(base["events"]), lineage_samples=len(base["samples"]),
          kernel_launches=launches,
          held_against_plain=sum(len(out["held"]) for _, out in arms),
          card=card)
    return launches


TENANCY_BACKLOGS = (2_500, 10_000, 30_000)


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
    real = solver.best_solve_allocate

    def traced(inp, cfg):
        launch_threads.append(threading.get_ident())
        return real(inp, cfg)

    solver.best_solve_allocate = traced
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
        solver.best_solve_allocate = real
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from kube_batch_tpu_torch.models.shipping import resident_shipper
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
    from kube_batch_tpu_torch.ops import cuda_solver
    from kube_batch_tpu_torch.ops.solver import dispatch_solve, fetch_solve

    card = card_line()
    kind_name = torch.cuda.get_device_name(0)
    phase("device", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())

    began = time.perf_counter()
    cuda_solver.build_kernel()
    phase("build", seconds=time.perf_counter() - began,
          ptxas=cuda_solver._Kernel.build_log.strip().splitlines()[-6:])
    from kube_batch_tpu_torch import native
    phase("native", **native.status())
    if not native.status()["loaded"] \
            and not os.environ.get("KUBE_BATCH_TPU_NO_NATIVE"):
        raise AssertionError("the C host walk did not load")

    for dtype in (torch.float32, torch.float64):
        for name, (inp, cfg) in matrix(dtype):
            kout = cuda_solver.solve_allocate_cuda(inp, cfg)
            wait_device(f"the kernel on {name}")
            pout = cuda_solver.solve_allocate_plain(inp, cfg)
            err = compare(kout, pout)
            if err:
                raise AssertionError(f"kernel != plain on {name} {dtype}: "
                                     f"max abs err {err}")
            phase("kernel-vs-plain", case=name, dtype=str(dtype),
                  steps=int(kout[0].step), max_abs_err=err,
                  **plan_fields(cuda_solver, inp, cfg))

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

    # Once against the plain version on the card.  The delta ship rewrote
    # the resident leaves in place, so the last shipped inputs are the
    # live ones.
    shipped, fetched = results[-1]
    kout = cuda_solver.solve_allocate_cuda(shipped, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pout = cuda_solver.solve_allocate_plain(shipped, cfg)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    max_err = compare(kout, pout)
    if max_err:
        raise AssertionError(f"kernel != plain at the north-star shape: "
                             f"max abs err {max_err}")
    if not np.array_equal(fetched[0], kout[0].assignment.cpu().numpy()):
        raise AssertionError("dispatch/fetch result differs from the kernel")
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

    session_launches = session_phase(cuda_solver, card)
    session_vs_cpu_phase(cuda_solver)
    steady_launches = steady_phase(cuda_solver, card)
    evict_launches = evict_phase(cuda_solver, card)
    evict_vs_cpu_phase(cuda_solver)
    topo_launches = topo_phase(cuda_solver, card)
    topo_vs_cpu_phase(cuda_solver)
    streams_launches = tenancy_streams_phase(cuda_solver, card)
    tenancy_launches = tenancy_phase(cuda_solver, card)
    backlog_launches = tenancy_backlog_phase(cuda_solver, card)
    loop_launches = scheduler_loop_phase(cuda_solver, card)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "solve_session", "route": "cuda",
        "source": "kube_batch_tpu_torch/csrc/solve_session.cu",
        "replaces": "kube_batch_tpu/ops/pallas_solver.py:60",
        "launches": (session_launches + steady_launches + evict_launches
                     + topo_launches + streams_launches + tenancy_launches
                     + backlog_launches + loop_launches),
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
