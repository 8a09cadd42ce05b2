"""The verification harnesses (the repo's tools/ scenario_gen, replay,
chaos_soak and replica_soak), driving the port's Scheduler.

Each runs as ``python -m kube_batch_tpu_torch.tools.<name>`` with the
reference's flags plus ``--device {cuda,cpu}`` (the card by default:
``device.resolve_device`` raises without one), prints exactly one JSON
artifact line and exits non-zero on any violated invariant.  None of
them imports jax, kube_batch_tpu or the repo's tools/ package.
"""

import sys


def kernel_launches() -> int:
    """The session kernel's launches in this process (0 off the card)."""
    from ..ops import cuda_solver
    return int(cuda_solver.solve_allocate_cuda.launches)


def breaker_transitions(to: str) -> int:
    """Times the device breaker has moved to ``to`` ("open": a trip,
    "half-open": a probe) in this process."""
    from ..metrics import metrics
    return int(metrics.breaker_transitions.value("device_solve", to))


def add_device_flag(parser) -> None:
    """The ``--device`` flag every tool takes (the card by default)."""
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the Scheduler's actions run (default: "
                             "the card; exits 1 without one)")


def cli_device(args, prog: str):
    """``args.device`` resolved (``device.resolve_device``), or None after
    printing why to stderr: the tools never fall back to the CPU."""
    from ..device import resolve_device
    try:
        return resolve_device(args.device)
    except RuntimeError as exc:
        print(f"{prog}: {exc}", file=sys.stderr)
        return None
