"""Incremental-session equivalence fuzz of the port (the repo's
tools/fuzz_incremental.py, driving kube_batch_tpu_torch).

The incremental machinery (the epoch-stamped clone pool in
SchedulerCache.snapshot, the per-job tensor blocks and node pack in
models/tensor_snapshot) must be invisible: a long-lived cache that has
served many churning sessions must schedule exactly like a cache freshly
rebuilt from the same cluster state.

Protocol per seed: drive a cluster state through N cycles.  Each cycle
applies random churn (pod create/delete, node update/taint, podgroup and
priority-class changes), runs one session of a randomly chosen action
list on (A) the long-lived cache fed only deltas and (B) a fresh cache
rebuilt from scratch, asserts identical bind maps and evictions, then
echoes A's binds back as Running pods — exercising exactly the
steady-state delta path.  The seeds draw the reference's clusters and
churn.

CLI::

    python -m kube_batch_tpu_torch.tools.fuzz_incremental [--seeds 20]
        [--start 7000] [--cycles 8] [--device cuda|cpu]

The device is the card unless ``--device cpu`` is given (float64 keys,
as the reference runs with x64).
"""

from __future__ import annotations

import argparse
import copy
import json
import random
import sys

import torch

from kube_batch_tpu_torch.tools import add_device_flag, cli_device


def make_driver_state(rng):
    """Plain lists of API objects: the cluster ground truth."""
    from kube_batch_tpu_torch.api import Node, NodeSpec, NodeStatus, ObjectMeta
    from kube_batch_tpu_torch.api.queue_info import Queue
    from kube_batch_tpu_torch.apis.scheduling import v1alpha1

    state = {"pods": {}, "nodes": {}, "pgs": {}, "queues": {}, "pcs": {},
             "next_pod": 0, "next_pg": 0}
    for q in range(rng.randint(1, 3)):
        state["queues"][f"q{q}"] = Queue(
            metadata=ObjectMeta(name=f"q{q}", creation_timestamp=float(q)),
            weight=rng.randint(1, 4))
    for i in range(rng.randint(3, 8)):
        name = f"n{i:03d}"
        alloc = {"cpu": str(rng.choice([4, 8, 16])),
                 "memory": f"{rng.choice([8, 16, 32])}Gi", "pods": 110}
        state["nodes"][name] = Node(
            metadata=ObjectMeta(name=name, uid=name,
                                labels={"kubernetes.io/hostname": name,
                                        "zone": f"z{i % 3}"}),
            spec=NodeSpec(),
            status=NodeStatus(allocatable=dict(alloc), capacity=dict(alloc)))
    return state


def add_job(state, rng, size=None):
    from kube_batch_tpu_torch.api import (Affinity, Container, ObjectMeta, Pod,
                                    PodSpec, PodStatus, Toleration)
    from kube_batch_tpu_torch.apis.scheduling import v1alpha1
    from kube_batch_tpu_torch.apis.scheduling.v1alpha1 import \
        GroupNameAnnotationKey

    size = size or rng.randint(1, 5)
    jid = state["next_pg"]
    state["next_pg"] += 1
    pg_name = f"pg{jid}"
    queue = rng.choice(sorted(state["queues"]))
    state["pgs"][f"ns/{pg_name}"] = v1alpha1.PodGroup(
        metadata=ObjectMeta(name=pg_name, namespace="ns",
                            creation_timestamp=float(jid)),
        spec=v1alpha1.PodGroupSpec(min_member=rng.randint(1, size),
                                   queue=queue))
    sig = rng.randrange(6)
    priority = rng.choice([None, None, 1, 5, 10])
    for _ in range(size):
        pid = state["next_pod"]
        state["next_pod"] += 1
        name = f"p{pid:05d}"
        selector = {"zone": f"z{sig % 3}"} if sig == 0 else {}
        tolerations = ([Toleration(key="dedicated", operator="Equal",
                                   value=f"t{sig % 2}", effect="")]
                       if sig in (1, 2) else [])
        affinity = (Affinity(preferred_node_terms=[(sig, {"zone": "z1"})])
                    if sig in (3, 4) else None)
        state["pods"][f"ns/{name}"] = Pod(
            metadata=ObjectMeta(
                name=name, namespace="ns", uid=name,
                labels={"grp": pg_name},
                annotations={GroupNameAnnotationKey: pg_name},
                creation_timestamp=float(pid)),
            spec=PodSpec(containers=[Container(
                requests={"cpu": str(rng.choice([1, 2, 3])),
                          "memory": f"{rng.choice([1, 2, 4])}Gi"})],
                node_selector=selector, tolerations=tolerations,
                affinity=affinity, priority=priority),
            status=PodStatus(phase="Pending"))


def churn(state, cache, rng):
    """Apply 1-4 random mutations to the driver state AND, as deltas, to
    the long-lived cache (the informer stream analog)."""
    import dataclasses as dc
    from kube_batch_tpu_torch.api import Taint

    for _ in range(rng.randint(1, 4)):
        op = rng.random()
        if op < 0.40:           # new job with pending pods
            before = dict(state["pods"])
            add_job(state, rng)
            for key, pod in state["pods"].items():
                if key not in before:
                    cache.add_pod(pod)
            new_pgs = [k for k in state["pgs"]
                       if k.split("/")[1] == f"pg{state['next_pg'] - 1}"]
            for k in new_pgs:
                cache.add_pod_group(state["pgs"][k])
        elif op < 0.65:         # delete a random pod
            if state["pods"]:
                key = rng.choice(sorted(state["pods"]))
                pod = state["pods"].pop(key)
                cache.delete_pod(pod)
        elif op < 0.75:         # delete a whole podgroup (+ its pods)
            if state["pgs"]:
                pgk = rng.choice(sorted(state["pgs"]))
                pg = state["pgs"].pop(pgk)
                pg_name = pg.metadata.name
                doomed = [k for k, p in state["pods"].items()
                          if p.metadata.labels.get("grp") == pg_name]
                for k in doomed:
                    cache.delete_pod(state["pods"].pop(k))
                cache.delete_pod_group(pg)
        elif op < 0.90:         # node label/taint flip
            if state["nodes"]:
                name = rng.choice(sorted(state["nodes"]))
                old = state["nodes"][name]
                labels = dict(old.metadata.labels)
                labels["zone"] = f"z{rng.randrange(3)}"
                taints = ([Taint(key="dedicated", value=f"t{rng.randrange(2)}",
                                 effect="NoSchedule")]
                          if rng.random() < 0.3 else [])
                new = dc.replace(
                    old,
                    metadata=dc.replace(old.metadata, labels=labels),
                    spec=dc.replace(old.spec, taints=taints))
                state["nodes"][name] = new
                cache.update_node(old, new)
        else:                   # priority class appears/changes
            from kube_batch_tpu_torch.api import PriorityClass, ObjectMeta
            pc = PriorityClass(metadata=ObjectMeta(name="hot"),
                               value=rng.randint(1, 100),
                               global_default=False)
            state["pcs"]["hot"] = pc
            cache.add_priority_class(pc)


def build_fresh_cache(state):
    from kube_batch_tpu_torch.cache import (FakeBinder, FakeEvictor,
                                      FakeStatusUpdater, FakeVolumeBinder,
                                      SchedulerCache)
    binder = FakeBinder()
    cache = SchedulerCache(binder=binder, evictor=FakeEvictor(),
                           status_updater=FakeStatusUpdater(),
                           volume_binder=FakeVolumeBinder())
    for q in state["queues"].values():
        cache.add_queue(copy.deepcopy(q))
    for pc in state["pcs"].values():
        cache.add_priority_class(copy.deepcopy(pc))
    for node in state["nodes"].values():
        cache.add_node(copy.deepcopy(node))
    for pg in state["pgs"].values():
        cache.add_pod_group(copy.deepcopy(pg))
    for pod in state["pods"].values():
        cache.add_pod(copy.deepcopy(pod))
    return cache, binder


_CONFS = ("tpu-allocate, backfill", "allocate, backfill",
          "allocate, preempt, backfill")


def run_session(cache, binder, evictor, conf_actions):
    """One scheduling cycle with the given action list (on the device and
    dtype the actions were registered with); returns the (binds,
    evicts) effect record."""
    from kube_batch_tpu_torch.framework import close_session, open_session
    from kube_batch_tpu_torch.scheduler import (DEFAULT_SCHEDULER_CONF,
                                                load_scheduler_conf)
    conf = DEFAULT_SCHEDULER_CONF.replace('"tpu-allocate, backfill"',
                                          f'"{conf_actions}"')
    assert f'"{conf_actions}"' in conf, "conf swap failed (default moved?)"
    actions, tiers = load_scheduler_conf(conf)
    ssn = open_session(cache, tiers)
    try:
        for action in actions:
            action.execute(ssn)
    finally:
        close_session(ssn)
    binds = dict(binder.binds)
    binder.binds.clear()
    evicts = list(evictor.evicts)
    evictor.evicts.clear()
    return binds, evicts


def echo_binds(state, cache, binds):
    """Informer echo: bound pods become Running on their node in both the
    driver truth and (as an update delta) the long-lived cache; PodGroup
    status writes echo back the same way (enabling pooled job reuse —
    part of what this fuzz must cover)."""
    import dataclasses as dc
    from kube_batch_tpu_torch.api import PodStatus

    for key, node in sorted(binds.items()):
        old = state["pods"].get(key)
        if old is None:
            continue
        new = dc.replace(old, spec=dc.replace(old.spec, node_name=node),
                         status=PodStatus(phase="Running"))
        state["pods"][key] = new
        cache.update_pod(old, new)
    updater = cache.status_updater
    if getattr(updater, "pod_groups", None):
        for pg in updater.pod_groups:
            if f"{pg.metadata.namespace}/{pg.metadata.name}" in state["pgs"]:
                # Status phase/conditions never influence placement (only
                # writes), so driver truth keeps the bare spec for B while
                # A's truth absorbs the echo — binds stay comparable while
                # the clone pool gets real coverage.
                cache.add_pod_group(pg)
        updater.pod_groups.clear()


def run_seed(seed: int, cycles: int) -> None:
    rng = random.Random(seed)
    state = make_driver_state(rng)
    for _ in range(rng.randint(2, 5)):
        add_job(state, rng)
    cache_a, binder_a = build_fresh_cache(state)  # long-lived incremental
    for cycle in range(cycles):
        churn(state, cache_a, rng)
        cache_b, binder_b = build_fresh_cache(state)  # oracle: fresh build
        conf_actions = rng.choice(_CONFS)
        binds_a = run_session(cache_a, binder_a, cache_a.evictor,
                              conf_actions)
        binds_b = run_session(cache_b, binder_b, cache_b.evictor,
                              conf_actions)
        assert binds_a == binds_b, (
            f"seed {seed} cycle {cycle} [{conf_actions}]: incremental "
            f"cache diverged\n"
            f"  incremental: {binds_a}\n"
            f"  fresh:       {binds_b}")
        echo_binds(state, cache_a, binds_a[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--start", type=int, default=7000)
    ap.add_argument("--cycles", type=int, default=8)
    add_device_flag(ap)
    ns = ap.parse_args(argv)
    device = cli_device(ns, "fuzz_incremental")
    if device is None:
        return 1
    from kube_batch_tpu_torch.actions.factory import register_default_actions
    from kube_batch_tpu_torch.ops import cuda_solver
    from kube_batch_tpu_torch.plugins.factory import register_default_plugins
    register_default_actions(device=device, dtype=torch.float64)
    register_default_plugins()
    before = cuda_solver.solve_allocate_cuda.launches
    failures = []
    for seed in range(ns.start, ns.start + ns.seeds):
        try:
            run_seed(seed, ns.cycles)
        except AssertionError as exc:
            failures.append(seed)
            print(f"FAIL seed {seed}: {exc}", file=sys.stderr, flush=True)
    print(json.dumps({"device": str(device), "seeds": ns.seeds,
                      "cycles": ns.cycles, "failures": failures,
                      "launches": cuda_solver.solve_allocate_cuda.launches
                      - before}, sort_keys=True))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
