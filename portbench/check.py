"""The comparison that decides ``correct``: what one session did to one
wave, held against the plain reference's decision for the same wave.

Every number is a count of disagreements, so each limit is 0:
- ``bind_mismatches``: pods bound to another node than the reference's,
  or bound where it binds none, or left unbound where it binds one;
- ``node_mismatches``: nodes whose cpu, memory or pod count after the
  session, by the cache's own accounting, differ from the reference's;
- ``group_mismatches``: pod groups whose last pushed status (phase,
  running, failed, succeeded) differs from the reference's, or that got
  no status at all;
- ``gang_violations``: pod groups with some pods bound but fewer than
  minMember (the gang guarantee, whatever the reference says);
- ``out_of_scope``: waves the reference could not judge
  (reference/allocate.py ``OutOfScope``);
- ``unrun_waves``: waves drawn for the check that the window never ran.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

LIMITS = {"bind_mismatches": 0, "node_mismatches": 0,
          "group_mismatches": 0, "gang_violations": 0, "out_of_scope": 0,
          "unrun_waves": 0}


@dataclass
class Observed:
    """What the program did in one session: pod key -> node name, the
    cache's (milli-CPU, MiB, pods) per node in cluster order, pod group
    key -> last status."""
    binds: Dict[str, str]
    node_state: List[Tuple[float, float, int]]
    statuses: Dict[str, object]


def compare(cluster, wave, decision, observed: Observed) -> Dict[str, int]:
    index = {n: i for i, n in enumerate(cluster.node_names)}
    ns = wave.namespace
    got = np.asarray([index.get(observed.binds.get(f"{ns}/{p}"), -1)
                      for p in wave.pod_names], np.int64)
    state = np.asarray(observed.node_state, np.float64).reshape(-1, 3)
    want = np.concatenate([decision.node_used.astype(np.float64),
                           decision.node_pods[:, None].astype(np.float64)],
                          axis=1)
    bound = np.bincount(wave.pod_group[got >= 0],
                        minlength=len(wave.group_names))
    groups = 0
    for g, name in enumerate(wave.group_names):
        status = observed.statuses.get(f"{ns}/{name}")
        phase = ("Running" if decision.group_bound[g] >= wave.group_min[g]
                 else "Pending")
        if status is None or (status.phase, status.running, status.failed,
                              status.succeeded) != (phase, 0, 0, 0):
            groups += 1
    return {
        "bind_mismatches": int(np.count_nonzero(got != decision.node)),
        "node_mismatches": int(np.count_nonzero(np.any(state != want,
                                                       axis=1))),
        "group_mismatches": groups,
        "gang_violations": int(np.count_nonzero(
            (bound > 0) & (bound < wave.group_min))),
    }


def add(total: Dict[str, int], part: Dict[str, int]) -> Dict[str, int]:
    return {k: total.get(k, 0) + v for k, v in part.items()}


def verdict(numbers: Dict[str, int]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}) for every number compared."""
    checks = {k: {"value": numbers.get(k, 0), "limit": lim}
              for k, lim in LIMITS.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def observed_from(cluster, wave, decision) -> Observed:
    """What a program that decided as ``decision`` would leave behind: its
    binds, its nodes' accounting and its pod groups' statuses (the
    control puts a lower-precision reference in the program's place)."""
    from types import SimpleNamespace
    ns = wave.namespace
    binds = {f"{ns}/{p}": cluster.node_names[n]
             for p, n in zip(wave.pod_names, decision.node) if n >= 0}
    state = [(float(c), float(m), int(k)) for (c, m), k in
             zip(decision.node_used, decision.node_pods)]
    statuses = {f"{ns}/{name}": SimpleNamespace(
        phase="Running" if decision.group_bound[g] >= wave.group_min[g]
        else "Pending", running=0, failed=0, succeeded=0)
        for g, name in enumerate(wave.group_names)}
    return Observed(binds=binds, node_state=state, statuses=statuses)
