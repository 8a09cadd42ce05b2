"""The control of the storm cell's ``correct``: the plain reference put in
the program's place, its shares computed in bfloat16, the precision below
the float32 that the configuration states, and judged by the storm's
comparison (storm_check.py) against the float32 reference.  It has to
come out not correct.

    python3 -m portbench.control_storm --seeds 1 2 3

For each seed it judges the window's first cycle at the cell's own size,
every session of it, and prints one JSON line with every number compared
and its limit, and the seconds each reference took.  The benchmark's own
runs never run it; it needs no card.
"""

import argparse
import json
import sys
import time
from types import SimpleNamespace

from . import cell, generator, storm_check
from .reference import evict


def observed_from(cluster, residents, wave, decided):
    """What a program that decided as ``decided`` (the reference's
    sessions) would leave behind, session by session."""
    ns, rns = wave.namespace, residents.namespace
    statuses, out = {}, []
    for d in decided:
        statuses.update({key: SimpleNamespace(
            phase=phase, running=running, failed=failed,
            succeeded=succeeded)
            for key, (phase, running, failed, succeeded)
            in d.groups.items()})
        out.append(storm_check.Observed(
            victims=[(f"{rns}/{residents.names[r]}", a)
                     for r, a in d.victims],
            binds={f"{ns}/{p}": cluster.node_names[n]
                   for p, n in zip(wave.pod_names, d.node) if n >= 0},
            node_state=[(float(c), float(m), int(k)) for (c, m), k in
                        zip(d.node_used, d.node_pods)],
            statuses=dict(statuses)))
    return out


def control(workload: str, seed: int, config=None, traffic=None) -> dict:
    _bench, _entry, cfg, tfc = cell.load(workload)
    config = config or cfg
    traffic = traffic or tfc
    cluster = generator.make_cluster(config, seed)
    residents = storm_check.make_residents(config, cluster)
    wave = storm_check.make_wave(config, traffic, cluster, seed,
                                 int(traffic["warmup_cycles"]))
    w = config["nodeorder_weights"]
    kw = dict(weights=(w["leastrequested"], w["mostrequested"],
                       w["balancedresource"]),
              max_sessions=int(traffic["max_sessions"]))
    t0 = time.perf_counter()
    want = evict.run_cycle(cluster, residents, wave,
                           share_dtype=config["share_precision"], **kw)
    t1 = time.perf_counter()
    low = evict.run_cycle(cluster, residents, wave, share_dtype="bfloat16",
                          **kw)
    t2 = time.perf_counter()
    numbers = storm_check.compare(
        cluster, residents, wave, want,
        observed_from(cluster, residents, wave, low))
    correct, checks = storm_check.verdict(numbers)
    return {"seed": seed, "correct": correct, "checks": checks,
            "sessions": len(want), "reference_s": t1 - t0,
            "control_s": t2 - t1}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control_storm")
    p.add_argument("--workload", default="churn50k.storm")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
