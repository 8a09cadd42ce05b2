"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the port (kube_batch_tpu_torch).
Set-up (imports, the kernels' builds or loads, the cluster's ingest and
the warm-up waves) counts from the process start to the first timed
cycle; then the window runs for ``--seconds``; then the reference judges
a sample of the window's waves.  ``--trace 1`` profiles the window's
device activity and reports the per-layer metrics instead of the
end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit;
the same numbers end standard error.  The exit code is not 0, and no
result is printed, without a CUDA card (or with fewer than the cell asks
for), or when the process has loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# Whole top-level module names that may not be loaded in this process.
FORBIDDEN = ("jax", "jaxlib", "flax", "kube_batch_tpu")


def forbidden_loaded(modules=None) -> list:
    """Top-level names of ``modules`` (sys.modules) that are forbidden,
    compared whole: ``kube_batch_tpu_torch`` is not ``kube_batch_tpu``."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from . import cell
    _bench, entry, _config, _traffic = cell.load(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < int(entry["chips"]):
        print(f"portbench: {args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    result, window = cell.run(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda", t0=T0)
    leaked = forbidden_loaded()
    if leaked:
        print(f"portbench: the process loaded {', '.join(leaked)}",
              file=sys.stderr)
        return 3
    for line in cell.summary(window):
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
