"""Time the session-solve kernel of this checkout against another
checkout's, on one CUDA card, in turns, at the north-star shape.

    git archive <commit> | tar -x -C build/parent   # any gitignored dir
    python3 kernel_ab.py build/parent

Each timing runs in its own process, which imports ``kube_batch_tpu_torch``
from the checkout it times, builds that checkout's kernel and times
`solve_allocate_cuda` with CUDA events (one warm-up launch, then 3).  The
order is other, this, this, other; then this checkout once more at each
cluster size in CLUSTER_SIZES that holds the north-star rows on chip, with
the phase stamps on.  Prints one JSON line per timing, the card's name and
power limit, then a JSON summary as the last line.  Needs a card; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

NORTH_STAR = (50_000, 10_000, 2_000, 4)
ROOT = Path(__file__).resolve().parent


def time_checkout(root: str, cluster: int | None) -> dict:
    """In this process: time the kernel of the checkout at ``root``."""
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
    from kube_batch_tpu_torch.ops import cuda_solver

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    if cluster is not None:
        cuda_solver.CLUSTER_SIZES = (cluster,)
    inp, cfg = make_synthetic_inputs(*NORTH_STAR, seed=0, dtype=torch.float32)
    cuda_solver.build_kernel()
    cuda_solver.solve_allocate_cuda(inp, cfg)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    ms = []
    for _ in range(3):
        start.record()
        result, _ = cuda_solver.solve_allocate_cuda(inp, cfg)
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
    out = dict(root=root, module=cuda_solver.__file__, ms=ms,
               median_ms=float(np.median(ms)), steps=int(result.step))
    if hasattr(cuda_solver, "cluster_plan"):
        n = inp.node_idle.shape[0]
        plan = cuda_solver.cluster_plan(n, 2, 0, 0, torch.float32,
                                        inp.job_ts.shape[0],
                                        inp.queue_ts.shape[0])
        out.update(cluster=plan.cluster, smem_bytes=plan.smem_bytes)
        stamps = torch.zeros(len(cuda_solver.PHASES), dtype=torch.int64,
                             device="cuda")
        cuda_solver.solve_allocate_cuda(inp, cfg, stamps=stamps)
        torch.cuda.synchronize()
        got = dict(zip(cuda_solver.PHASES, stamps.tolist()))
        cycles_per_ms = got["total"] / out["median_ms"]
        out["phases_ms"] = {k: got[k] / cycles_per_ms for k in got
                            if k not in ("placements", "pops", "total")}
        out.update(placements=got["placements"], pops=got["pops"])
    return out


def run(root: str, cluster: int | None = None) -> dict:
    cmd = [sys.executable, str(ROOT / "kernel_ab.py"), "--time", root]
    if cluster is not None:
        cmd += ["--cluster", str(cluster)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=300, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd} failed:\n{proc.stderr[-4000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(got), flush=True)
    return got


def on_chip(cuda_solver, c: int) -> bool:
    """Whether a cluster of c CTAs holds all of the north-star state
    (N=10,240, J=2,048, Q=8, R=2, no features) in shared memory."""
    import torch
    sizes = cuda_solver.CLUSTER_SIZES
    cuda_solver.CLUSTER_SIZES = (c,)
    try:
        plan = cuda_solver.cluster_plan(10_240, 2, 0, 0, torch.float32,
                                        2_048, 8)
    finally:
        cuda_solver.CLUSTER_SIZES = sizes
    return plan.smem_rows == plan.rows and plan.jsta_smem and plan.jwork_smem


def main() -> int:
    if "--time" in sys.argv:
        root = sys.argv[sys.argv.index("--time") + 1]
        cluster = (int(sys.argv[sys.argv.index("--cluster") + 1])
                   if "--cluster" in sys.argv else None)
        print(json.dumps(time_checkout(root, cluster)), flush=True)
        return 0
    other = sys.argv[1]
    this = str(ROOT)
    turns = [run(other), run(this), run(this), run(other)]
    sys.path.insert(0, this)
    from kube_batch_tpu_torch.ops import cuda_solver
    sizes = [run(this, c) for c in cuda_solver.CLUSTER_SIZES
             if on_chip(cuda_solver, c)]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(json.dumps({
        "card": card,
        "other_ms": [turns[0]["median_ms"], turns[3]["median_ms"]],
        "this_ms": [turns[1]["median_ms"], turns[2]["median_ms"]],
        "by_cluster": {s["cluster"]: s["median_ms"] for s in sizes}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
