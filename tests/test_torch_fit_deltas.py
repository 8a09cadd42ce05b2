"""Fit-error diagnostics under tpu-allocate, the JAX package against the
port, on the CPU.

Twin of tests/test_fit_deltas.py: in each package the host allocate and
tpu-allocate record the same NodesFitDelta histogram and unschedulable
message, and the port's equal the JAX package's, on the three reference
cases (the 30-seed fuzz of no-candidate tasks among them).  Both packages
load the default conf whole (tpu-allocate, backfill).
"""

import random

from tests.test_torch_utils import build_cache, twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401


def _mark_dying(cache, uids):
    for uid in uids:
        task = list(cache.jobs[uid].tasks.values())[0]
        task.pod.metadata.deletion_timestamp = 1.0
        cache.update_pod(task.pod, task.pod)


def _after(p, action, spec, mark_dying=()):
    """One session of ``action`` on ``spec``: per job its fit error and
    fit-delta histogram, and the pipelined placements."""
    cache, _, _ = build_cache(spec, p.pkg)
    _mark_dying(cache, mark_dying)
    ssn = p.m.framework.open_session(cache, p.tiers())
    try:
        p.action(action).execute(ssn)
        deltas, pipelined = {}, {}
        for uid, job in ssn.jobs.items():
            deltas[uid] = (job.fit_error(),
                           {n: repr(d) for n, d in
                            sorted(job.nodes_fit_delta.items())})
            for t in job.task_status_index.get(
                    p.m.api.TaskStatus.Pipelined, {}).values():
                pipelined[t.uid] = t.node_name
        return deltas, pipelined
    finally:
        p.m.framework.close_session(ssn)


def _host_and_device(spec, mark_dying=()):
    def body(p):
        host = _after(p, "allocate", spec, mark_dying)
        dev = _after(p, "tpu_allocate", spec, mark_dying)
        assert dev == host
        return dev
    return twin(body)


def test_oversized_task_no_candidates_matches_host():
    spec = dict(queues=[("q1", 1)], pod_groups=[("pg1", "ns", 1, "q1")],
                nodes=[("n0", "4", "8Gi")],
                pods=[("ns", "big", "", "Pending", "8", "16Gi", "pg1")])
    deltas, _ = _host_and_device(spec)
    assert deltas["ns/pg1"][0] == "0 nodes are available"


def test_fuzz_no_candidate_task_jobs():
    for seed in range(30):
        rng = random.Random(1234 + seed)
        n_nodes = rng.randint(1, 4)
        node_cpu = rng.choice([4, 8])
        spec = dict(queues=[(f"q{i}", rng.randint(1, 3))
                            for i in range(rng.randint(1, 3))],
                    pod_groups=[], pods=[],
                    nodes=[(f"n{i}", str(node_cpu), "64G")
                           for i in range(n_nodes)])
        nq = len(spec["queues"])
        dying = []
        for j in range(rng.randint(1, 5)):
            size = rng.randint(1, 5)
            spec["pod_groups"].append(
                (f"pg{j}", "ns", rng.randint(1, size),
                 f"q{rng.randrange(nq)}"))
            if rng.random() < 0.6:
                spec["pods"].append(
                    ("ns", f"j{j}-run", f"n{rng.randrange(n_nodes)}",
                     "Running", str(rng.choice([1, 2, 3])), "1G", f"pg{j}"))
                if rng.random() < 0.7:
                    dying.append(f"ns/pg{j}")
            for i in range(size):
                cpu = (str(node_cpu * 2) if rng.random() < 0.25
                       else str(rng.choice([1, 2, 3])))
                spec["pods"].append(("ns", f"j{j}-p{i}", "", "Pending",
                                     cpu, "1G", f"pg{j}"))
        _host_and_device(spec, mark_dying=dying)


def test_pipelined_last_task_records_delta_like_host():
    spec = dict(queues=[("q1", 1)],
                pod_groups=[("old", "ns", 1, "q1"), ("new", "ns", 1, "q1")],
                pods=[("ns", "dying", "n1", "Running", "3", "3G", "old"),
                      ("ns", "fresh", "", "Pending", "3", "3G", "new")],
                nodes=[("n1", "4", "8G")])
    deltas, _ = _host_and_device(spec, mark_dying=["ns/old"])
    assert "insufficient cpu" in deltas["ns/new"][0]
