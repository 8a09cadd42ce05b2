"""The chaos soak seed by seed, in the reference and in the port, on the CPU.

For each seed at one shape it runs one oracle + chaos pair three ways:
the reference's soak (tools/chaos_soak.py), the port's with the host path
allowed as on the CPU, and the port's under the card's rule (a failed
device stage raises and feeds the breaker, as on a CUDA device).  It
prints one JSON line per seed: whether each converged, the problems, the
``commit.flush_error`` injections, whether the port's host-rule problems
equal the reference's, whether the card's rule's equal them, and, where
the card's rule diverged, what the fault-free scheduler started on the
truth each fault phase left reaches (``fault_free_from``: no problems
means the chaos arm's drain reached the same maps).

    JAX_PLATFORMS=cpu python tests/soak_seed_sweep.py --seeds 1-60
    JAX_PLATFORMS=cpu python tests/soak_seed_sweep.py --seeds 1 \\
        --nodes 2000 --budget 15000
"""

import argparse
import json
import logging
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import kube_batch_tpu_torch.chaos.breaker as brk  # noqa: E402
from kube_batch_tpu_torch.tools import chaos_soak as soak  # noqa: E402
from tools import chaos_soak as ref_soak  # noqa: E402


def _seed_range(text: str) -> list:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def one_seed(seed: int, **shape) -> dict:
    want = ref_soak.run_soak([seed], require_all_sites=False, **shape)
    host = soak.run_soak([seed], require_all_sites=False, device="cpu",
                         **shape)
    allowed = brk.host_path_allowed
    brk.host_path_allowed = lambda device: False
    try:
        card = soak.run_soak([seed], require_all_sites=False, device="cpu",
                             **shape)
    finally:
        brk.host_path_allowed = allowed
    (arm,) = card["seeds"]
    return {
        "seed": seed,
        "reference_ok": want["ok"],
        "reference_flush": want["seeds"][0]["injected"].get(
            "commit.flush_error", 0),
        "host_rule_equals_reference": host["problems"] == want["problems"],
        "card_rule_ok": card["ok"],
        "card_rule_flush": arm["injected"].get("commit.flush_error", 0),
        "card_rule_equals_reference": [p.split(": ", 1)[1]
                                       for p in card["problems"]]
        == [p.split(": ", 1)[1] for p in want["problems"]],
        "card_rule_failed_cycles": arm["failed_cycles"],
        "card_rule_trips": arm["breaker"]["trips"],
        "card_rule_path_problems": arm["path_problems"],
        "reference_problems": want["problems"],
        "card_rule_problems": card["problems"],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", default="1-8", help="a seed or lo-hi")
    parser.add_argument("--nodes", type=int, default=8)
    parser.add_argument("--cycles", type=int, default=10)
    parser.add_argument("--budget", type=int, default=60)
    parser.add_argument("--edge", action="store_true")
    args = parser.parse_args(argv)
    logging.disable(logging.CRITICAL)
    for seed in _seed_range(args.seeds):
        print(json.dumps(one_seed(seed, nodes=args.nodes, cycles=args.cycles,
                                  budget=args.budget, edge=args.edge)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
