"""The control of ``correct``: the plain reference put in the program's
place, its shares computed in bfloat16, the precision below the float32
that the configuration states, and judged by the same comparison against
the float32 reference.  It has to come out not correct.

    python3 -m portbench.control --workload kubemark50k.backlog \
        --seeds 1 2 3

For each seed it judges the window's first wave at the cell's own size
and prints one JSON line with every number compared and its limit.  The
benchmark's own runs never run it; it needs no card.
"""

import argparse
import json
import sys
import time

from . import cell, check, generator
from .reference import allocate


def control(workload: str, seed: int, config=None, traffic=None) -> dict:
    _bench, _entry, cfg, tfc = cell.load(workload)
    config = config or cfg
    traffic = traffic or tfc
    cluster = generator.make_cluster(config, seed)
    wave = generator.make_wave(traffic, len(cluster.queue_names), seed,
                               int(traffic["warmup_waves"]))
    w = config["nodeorder_weights"]
    weights = (w["leastrequested"], w["mostrequested"],
               w["balancedresource"])
    want = allocate.solve(cluster, wave, weights=weights,
                          share_dtype=config["share_precision"])
    low = allocate.solve(cluster, wave, weights=weights,
                         share_dtype="bfloat16")
    numbers = check.compare(cluster, wave, want,
                            check.observed_from(cluster, wave, low))
    correct, checks = check.verdict(numbers)
    return {"seed": seed, "correct": correct, "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for seed in args.seeds:
        t = time.perf_counter()
        out = control(args.workload, seed)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
