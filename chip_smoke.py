"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. device: the card's name and power limit; exits non-zero without CUDA;
  2. build: compiles csrc/solve_session.cu with nvcc and prints the seconds;
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
  5. session, the slice's main path at the north star: make_synthetic_
     cache through the SchedulerCache's ingestion, then one cold and five
     warm sessions of open_session -> TpuAllocateAction(cuda, float32) ->
     close_session, bound pods echoed back between them; each session
     must take the cuda route without the host fallback, launch the
     kernel once, bind exactly the kernel's placements (read off a direct
     launch on its shipped inputs), leave no node over its allocatable
     and no gang job below its minAvailable; prints the stage split,
     the wall time (median, p90) and the kernel's share;
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
     events.
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


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


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
def incremental_arm(on: bool):
    """Run the block with incremental sessions on (the default) or as the
    reference's KUBE_BATCH_TPU_INCREMENTAL=0 control; the knob is read at
    every call, so one process runs both arms."""
    old = os.environ.get("KUBE_BATCH_TPU_INCREMENTAL")
    if on:
        os.environ.pop("KUBE_BATCH_TPU_INCREMENTAL", None)
    else:
        os.environ["KUBE_BATCH_TPU_INCREMENTAL"] = "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("KUBE_BATCH_TPU_INCREMENTAL", None)
        else:
            os.environ["KUBE_BATCH_TPU_INCREMENTAL"] = old


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


def session_phase(cuda_solver, card) -> int:
    """The slice's main path at the north star: make_synthetic_cache
    through the cache's ingestion, then one cold and five warm sessions of
    open_session -> TpuAllocateAction(cuda, float32) -> close_session,
    every bound pod echoed back unchanged between sessions (bench.py
    measure_full_session), so each sees the same backlog.  Run as the
    KUBE_BATCH_TPU_INCREMENTAL=0 arm: with incremental sessions on, an
    unchanged backlog ships clean and reuses the previous solve, and this
    phase measures the full session.  Returns the kernel launches of
    those sessions."""
    with incremental_arm(False):
        return _session_phase(cuda_solver, card)


def _session_phase(cuda_solver, card) -> int:
    from kube_batch_tpu_torch.actions.tpu_allocate import TpuAllocateAction
    from kube_batch_tpu_torch.api import pod_key
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_cache

    tiers = _register("cuda")
    began = time.perf_counter()
    cache, binder = make_synthetic_cache(*NORTH_STAR)
    build_s = time.perf_counter() - began
    pods = {pod_key(t.pod): t.pod for job in cache.jobs.values()
            for t in job.tasks.values()}
    job_of = {pod_key(t.pod): t.job for job in cache.jobs.values()
              for t in job.tasks.values()}
    min_avail = {uid: job.min_available for uid, job in cache.jobs.items()}
    action = TpuAllocateAction(device="cuda", dtype=torch.float32)
    runs = []
    launches = 0
    for i in range(6):
        seen = len(binder.channel)
        cuda_solver.solve_allocate_cuda.launches = 0
        stages, wall = _run_session(cache, tiers, action)
        got = cuda_solver.solve_allocate_cuda.launches
        launches += got
        last = action.last
        binds = [(key, binder.binds[key]) for key in binder.channel[seen:]]
        if last.route != "cuda" or last.snap.needs_fallback:
            raise AssertionError(f"session {i}: route {last.route}, "
                                 f"fallback {last.snap.fallback_reason}")
        if got != 1:
            raise AssertionError(f"session {i} launched the kernel {got} "
                                 f"times")
        # The bind map read off a direct launch on the shipped inputs,
        # timed with CUDA events (the kernel's share of the session).
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        res, _ = cuda_solver.solve_allocate_cuda(last.inputs,
                                                 last.snap.config)
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
        # A map: the binder sees each gang job's tasks together, in the
        # order the jobs become ready, not in placement order.
        if len(dict(binds)) != len(binds) or dict(binds) != dict(expect):
            raise AssertionError(f"session {i}: the bind map differs from "
                                 f"the kernel's placements on its inputs")
        per_job = {}
        for key, _host in binds:
            per_job[job_of[key]] = per_job.get(job_of[key], 0) + 1
        short = [uid for uid, n in per_job.items() if n < min_avail[uid]]
        if short:
            raise AssertionError(f"session {i}: gang jobs bound below "
                                 f"minAvailable: {short[:3]}")
        runs.append((stages, wall, len(binds), kernel_ms))
        phase("session-run", session=i, cold=i == 0, wall_s=wall,
              binds=len(binds), launches=got, kernel_ms=kernel_ms,
              stages_ms={k: v * 1e3 for k, v in stages.items()})
        for key, _host in binds:  # echo back unchanged (outside the clock)
            cache.update_pod(pods[key], pods[key])
    warm = runs[1:]
    walls = [w for _s, w, _b, _k in warm]
    split = {k: float(np.median([s[k] for s, _w, _b, _k in warm])) * 1e3
             for k in warm[0][0]}
    kernel_med = float(np.median([k for _s, _w, _b, k in warm]))
    phase("session", shape=list(NORTH_STAR), build_s=build_s,
          cold_wall_ms=runs[0][1] * 1e3,
          warm_wall_ms_median=float(np.median(walls)) * 1e3,
          warm_wall_ms_p90=float(np.percentile(walls, 90)) * 1e3,
          warm_wall_ms_all=[w * 1e3 for w in walls],
          stage_ms_median=split,
          kernel_ms_median=kernel_med,
          kernel_share_of_session=kernel_med / (float(np.median(walls))
                                                * 1e3),
          binds_per_session=[b for _s, _w, b, _k in runs],
          launches=launches, route="cuda", card=card)
    return launches


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


@contextlib.contextmanager
def batch_evict_arm(on: bool):
    """KUBE_BATCH_TPU_BATCH_EVICT for the block: the batched eviction
    engine (1) or its sequential control (0)."""
    name = "KUBE_BATCH_TPU_BATCH_EVICT"
    old = os.environ.get(name)
    os.environ[name] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def allocate_vs_plain(cuda_solver, action) -> dict:
    """tpu-allocate's solve in an evict session held against the
    kernel's plain version on the same inputs: the assignment, kind and
    order that the action fetched from its launch must equal
    solve_allocate_plain's exactly (max abs err 0).  Run right after the
    action, before a later ship can rewrite the resident inputs.  A
    gathered (candidate-row) solve is compared on its gathered inputs,
    its placements mapped back to full-space rows."""
    from kube_batch_tpu_torch.ops.solver import _gather_candidate_inputs
    last = action.last
    if last is None or last.reused:
        raise AssertionError("tpu-allocate solved nothing on the device in "
                             "the evict session")
    inputs, cand = last.inputs, last.candidates
    dev = inputs.node_idle.device
    if cand is not None:
        inputs = _gather_candidate_inputs(
            inputs, torch.from_numpy(cand.idx).long().to(dev),
            torch.from_numpy(cand.valid).to(dev))
    t0 = time.perf_counter()
    res, _ = cuda_solver.solve_allocate_plain(inputs, last.snap.config)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    assignment = res.assignment.cpu().numpy().astype(np.int64)
    kind = res.kind.cpu().numpy().astype(np.int64)
    order = res.order.cpu().numpy().astype(np.int64)
    got_assignment = np.asarray(last.assignment, np.int64)
    if cand is not None:
        placed = kind > 0
        assignment = np.where(placed, cand.remap[np.clip(
            assignment, 0, len(cand.remap) - 1)], -1)
        got_assignment = np.where(placed, got_assignment, -1)
    err = 0
    for name, got, want in (("assignment", got_assignment, assignment),
                            ("kind", last.kind, kind),
                            ("order", last.order, order)):
        got = np.asarray(got, np.int64)
        if got.shape != want.shape:
            raise AssertionError(f"tpu-allocate's {name} has shape "
                                 f"{got.shape}, the plain version's "
                                 f"{want.shape}")
        if got.size:
            err = max(err, int(np.abs(got - want).max()))
    if err:
        raise AssertionError(f"tpu-allocate's launch in the evict session "
                             f"!= the plain version: max abs err {err}")
    return dict(route=last.route, gathered=cand is not None,
                placed=int((kind > 0).sum()), steps=int(res.step),
                plain_ms=plain_ms, max_abs_err=err)


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

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "solve_session", "route": "cuda",
        "source": "kube_batch_tpu_torch/csrc/solve_session.cu",
        "replaces": "kube_batch_tpu/ops/pallas_solver.py:60",
        "launches": session_launches + steady_launches + evict_launches,
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
