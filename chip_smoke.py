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
     pop).
The last two lines are the kernel table as JSON and
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero
before those lines.  Imports nothing of JAX and nothing of kube_batch_tpu.
"""

from __future__ import annotations

import json
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


def plan_fields(cuda_solver, inp, cfg) -> dict:
    """The cluster plan the kernel launched with for these inputs."""
    plan = cuda_solver.plan_of(inp, cfg)
    return dict(n=inp.node_idle.shape[0], cluster=plan.cluster, smem_bytes=plan.smem_bytes,
                rows_on_chip=f"{plan.smem_rows}/{plan.rows}",
                jsta_smem=plan.jsta_smem, jwork_smem=plan.jwork_smem)


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

    rounds = []
    for _ in range(7):
        t0 = time.perf_counter()
        fetch_solve(dispatch_solve(shipped, cfg))
        rounds.append((time.perf_counter() - t0) * 1e3)

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    ops = cuda_solver._operands(shipped)
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

    in_bytes = sum(t.numel() * t.element_size()
                   for t in (*ops.bufs, ops.task_data, ops.task_sig,
                             ops.sig_mask, ops.sig_bonus, ops.nport, ops.nsel,
                             ops.total, ops.score_shift))
    out_bytes = (kout[0].assignment.shape[0] * 4 * 4 + 4
                 + sum(t.numel() * t.element_size() for t in kout[1]))
    n_pad = ops.bufs.node_int.shape[1]
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = steps * n_pad * OPS_PER_NODE_SCAN / LANE_OPS_PER_S * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))

    phase("main-path", shape=list(NORTH_STAR), placed=placed, steps=steps,
          launches=launches, dispatch_fetch_ms_median=float(np.median(rounds)),
          dispatch_fetch_ms_p90=float(np.percentile(rounds, 90)),
          dispatch_fetch_ms_all=rounds, kernel_ms=kernel_ms,
          plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
          bytes_moved=in_bytes + out_bytes, bytes_bound_ms=bytes_ms,
          lane_ops=steps * n_pad * OPS_PER_NODE_SCAN, ops_bound_ms=ops_ms,
          card=card)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "solve_session", "route": "cuda",
        "source": "kube_batch_tpu_torch/csrc/solve_session.cu",
        "replaces": "kube_batch_tpu/ops/pallas_solver.py:60",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
