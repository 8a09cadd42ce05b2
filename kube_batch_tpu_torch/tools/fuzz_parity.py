"""Extended host/device parity fuzz of the port (the repo's
tools/fuzz_parity.py, driving kube_batch_tpu_torch): run it after any
solver or tensorize change.

Random clusters mixing every feature the device path supports — node
labels and taints, pod selectors and tolerations, required and
preferred node affinity, host ports, required and preferred pod
(anti-)affinity, running pods, gangs, multi-queue weights — asserting
bind-map equality between the host allocate oracle and tpu-allocate per
seed, with float64 keys (``--x64 1``, the reference's x64 mode) and
float32 keys (``--x64 0``).  The clusters are the reference's, seed for
seed (the same builders and draws).

CLI::

    python -m kube_batch_tpu_torch.tools.fuzz_parity [--seeds 40]
        [--start 300] [--x64 0|1|both] [--device cuda|cpu]

The device is the card unless ``--device cpu`` is given; on the card
tpu-allocate launches K1, on the CPU it runs K1's plain version.
"""

from __future__ import annotations

import argparse
import json
import random
import sys

import torch

from kube_batch_tpu_torch.tools import add_device_flag, cli_device

DTYPES = {"1": torch.float64, "0": torch.float32}


def build_cache(spec):
    """spec: dict with queues [(name, weight)], pod_groups [(name, ns,
    min, queue)], pods [(ns, name, node, phase, cpu, mem, group)], nodes
    [(name, cpu, mem)] -> (cache, binder), built as the reference's
    parity suite builds it (tests/test_tpu_parity.build_cache)."""
    from kube_batch_tpu_torch.api import ObjectMeta
    from kube_batch_tpu_torch.api.objects import (Container, Node, NodeSpec,
                                                  NodeStatus, Pod, PodSpec,
                                                  PodStatus)
    from kube_batch_tpu_torch.api.queue_info import Queue
    from kube_batch_tpu_torch.apis.scheduling import v1alpha1
    from kube_batch_tpu_torch.cache import (FakeBinder, FakeEvictor,
                                            FakeStatusUpdater,
                                            FakeVolumeBinder, SchedulerCache)
    binder = FakeBinder()
    cache = SchedulerCache(binder=binder, evictor=FakeEvictor(),
                           status_updater=FakeStatusUpdater(),
                           volume_binder=FakeVolumeBinder())
    for i, (name, weight) in enumerate(spec["queues"]):
        cache.add_queue(Queue(
            metadata=ObjectMeta(name=name, creation_timestamp=float(i)),
            weight=weight))
    for name, ns, min_member, queue in spec["pod_groups"]:
        cache.add_pod_group(v1alpha1.PodGroup(
            metadata=ObjectMeta(name=name, namespace=ns),
            spec=v1alpha1.PodGroupSpec(min_member=min_member, queue=queue)))
    for name, cpu, mem in spec["nodes"]:
        alloc = {"cpu": cpu, "memory": mem, "pods": 110}
        cache.add_node(Node(metadata=ObjectMeta(name=name, uid=name,
                                                labels={}),
                            spec=NodeSpec(),
                            status=NodeStatus(allocatable=alloc,
                                              capacity=dict(alloc))))
    for i, (ns, name, node, phase, cpu, mem, group) in enumerate(
            spec["pods"]):
        cache.add_pod(Pod(
            metadata=ObjectMeta(
                name=name, namespace=ns, uid=f"{ns}-{name}",
                annotations=({v1alpha1.GroupNameAnnotationKey: group}
                             if group else {}),
                labels={}, creation_timestamp=float(i)),
            spec=PodSpec(node_name=node, node_selector={},
                         containers=[Container(
                             requests={"cpu": cpu, "memory": mem})]),
            status=PodStatus(phase=phase)))
    return cache, binder


def seed_cluster(seed: int):
    """(spec, mutate) of ``seed``: the reference's random cluster and its
    feature mutation, draw for draw."""
    from kube_batch_tpu_torch.api.objects import (Affinity, ContainerPort,
                                                  Taint, Toleration)
    rng = random.Random(seed)
    nq = rng.randint(1, 4)
    n_nodes = rng.randint(2, 8)
    spec = dict(queues=[(f"q{i}", rng.randint(1, 4)) for i in range(nq)],
                pod_groups=[], pods=[],
                nodes=[(f"n{i}", str(rng.choice([4, 8, 16])),
                        f"{rng.choice([8, 16, 32])}Gi")
                       for i in range(n_nodes)])
    for j in range(rng.randint(2, 8)):
        size = rng.randint(1, 6)
        spec["pod_groups"].append((f"pg{j}", "ns", rng.randint(1, size),
                                   f"q{rng.randrange(nq)}"))
        for i in range(size):
            running = rng.random() < 0.2
            spec["pods"].append(("ns", f"j{j}-p{i}",
                                 "n0" if running else "",
                                 "Running" if running else "Pending",
                                 str(rng.choice([1, 2, 3])),
                                 f"{rng.choice([1, 2, 4])}Gi", f"pg{j}"))

    def mutate(cache):
        r2 = random.Random(seed + 5000)
        for node in cache.nodes.values():
            if node.node is None:
                continue
            node.node.metadata.labels.update({
                "kubernetes.io/hostname": node.name,
                "zone": f"z{r2.randrange(3)}",
                "pool": f"pool{r2.randrange(2)}"})
            if r2.random() < 0.25:
                node.node.spec.taints.append(Taint(
                    key="dedicated", value=f"t{r2.randrange(2)}",
                    effect=r2.choice(["NoSchedule", "PreferNoSchedule"])))
        for job in list(cache.jobs.values()):
            for t in list(job.tasks.values()):
                t.pod.metadata.labels["grp"] = t.job.split("/")[-1]
                roll = r2.random()
                if roll < 0.2:
                    t.pod.spec.node_selector = {"zone": f"z{r2.randrange(3)}"}
                elif roll < 0.3:
                    t.pod.spec.affinity = Affinity(required_node_terms=[
                        {"pool": f"pool{r2.randrange(2)}"}])
                elif roll < 0.4:
                    t.pod.spec.affinity = Affinity(preferred_node_terms=[
                        (r2.choice([1, 5, 10]),
                         {"zone": f"z{r2.randrange(3)}"})])
                if r2.random() < 0.3:
                    t.pod.spec.tolerations = [Toleration(
                        key="dedicated", operator="Equal",
                        value=f"t{r2.randrange(2)}", effect="")]
                roll = r2.random()
                if roll < 0.12:
                    t.pod.spec.containers[0].ports = [
                        ContainerPort(host_port=r2.choice([80, 443]))]
                elif roll < 0.22:
                    aff = t.pod.spec.affinity or Affinity()
                    aff.required_pod_anti_affinity = [
                        {"grp": t.job.split("/")[-1]}]
                    t.pod.spec.affinity = aff
                elif roll < 0.32:
                    aff = t.pod.spec.affinity or Affinity()
                    aff.preferred_pod_affinity = [
                        (r2.choice([10, 50]), {"grp": f"pg{r2.randrange(7)}"})]
                    t.pod.spec.affinity = aff

    return spec, mutate


def run_seed(seed: int, device, dtype: torch.dtype) -> dict:
    """The host allocate action and tpu-allocate (on ``device`` with
    ``dtype`` keys) on the seed's cluster; raises AssertionError when
    their bind maps differ; returns the host's bind map."""
    from kube_batch_tpu_torch.actions.allocate import AllocateAction
    from kube_batch_tpu_torch.actions.factory import register_default_actions
    from kube_batch_tpu_torch.actions.tpu_allocate import TpuAllocateAction
    from kube_batch_tpu_torch.framework import close_session, open_session
    from kube_batch_tpu_torch.plugins.factory import register_default_plugins
    from kube_batch_tpu_torch.scheduler import (DEFAULT_SCHEDULER_CONF,
                                                parse_scheduler_conf)
    register_default_plugins()
    register_default_actions(device=device, dtype=dtype)
    spec, mutate = seed_cluster(seed)
    tiers = parse_scheduler_conf(DEFAULT_SCHEDULER_CONF).tiers
    results = []
    for make in (AllocateAction,
                 lambda: TpuAllocateAction(device=device, dtype=dtype)):
        cache, binder = build_cache(spec)
        mutate(cache)
        ssn = open_session(cache, tiers)
        try:
            make().execute(ssn)
        finally:
            close_session(ssn)
        results.append(dict(binder.binds))
    host, device_binds = results
    assert device_binds == host, (
        f"seed {seed}: tpu-allocate {device_binds} != allocate {host}")
    return host


def run(seeds, device, dtype: torch.dtype) -> dict:
    """Every seed in one float mode: {"mode", "seeds", "failures",
    "launches"} (K1's launches on the card)."""
    from kube_batch_tpu_torch.ops import cuda_solver
    before = cuda_solver.solve_allocate_cuda.launches
    failures = []
    for seed in seeds:
        try:
            run_seed(seed, device, dtype)
        except AssertionError as exc:
            failures.append(seed)
            print(f"  FAIL {exc}", file=sys.stderr, flush=True)
    return {"mode": "x64" if dtype == torch.float64 else "f32",
            "seeds": len(seeds), "failures": failures,
            "launches": cuda_solver.solve_allocate_cuda.launches - before}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--start", type=int, default=300)
    ap.add_argument("--x64", default="both", choices=["0", "1", "both"])
    add_device_flag(ap)
    ns = ap.parse_args(argv)
    device = cli_device(ns, "fuzz_parity")
    if device is None:
        return 1
    seeds = list(range(ns.start, ns.start + ns.seeds))
    modes = {"0": ["0"], "1": ["1"], "both": ["1", "0"]}[ns.x64]
    out = [run(seeds, device, DTYPES[m]) for m in modes]
    print(json.dumps({"device": str(device), "modes": out}, sort_keys=True))
    return 1 if any(m["failures"] for m in out) else 0


if __name__ == "__main__":
    raise SystemExit(main())
