"""The storm cell's deployment and its comparison: the residents and waves
of ``configs/churn50k.json`` and ``traffic/storm.json`` as plain arrays
and as API objects, and the numbers that decide ``correct`` for a storm
cycle, held against ``reference/evict.py`` session by session.

Every number is a count of disagreements, so each limit is 0:

- ``victim_mismatches``: victims, with the action that evicted them, that
  one side evicted in a session and the other did not;
- ``victim_order_mismatches``: places in a session's eviction order, over
  the victims both sides evicted, where the two differ;
- ``bind_mismatches``: preemptors bound in a session to another node than
  the reference's, or bound where it binds none, or left unbound where it
  binds one;
- ``node_mismatches``: nodes whose cpu, memory or pod count after a
  session, by the cache's own accounting, differ from the reference's;
- ``group_mismatches``: pod groups (the wave's and the residents') whose
  last pushed status (phase, running, failed, succeeded) after a session
  differs from the reference's;
- ``gang_violations``: the wave's pod groups with some pods bound but
  fewer than minMember after a session;
- ``out_of_scope``: cycles the reference could not judge
  (reference/evict.py ``OutOfScope``);
- ``unrun_cycles``: cycles drawn for the check that the window never ran.

A session one side ran and the other did not is held against an empty
session (nothing evicted, nothing bound, the nodes as the side's last
session left them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from . import generator

LIMITS = {"victim_mismatches": 0, "victim_order_mismatches": 0,
          "bind_mismatches": 0, "node_mismatches": 0,
          "group_mismatches": 0, "gang_violations": 0, "out_of_scope": 0,
          "unrun_cycles": 0}


@dataclass
class Residents:
    """The Running pods that fill the cluster, in their first order."""
    namespace: str
    names: List[str]
    node: np.ndarray            # [R] int64 node index
    job: np.ndarray             # [R] int64
    req: np.ndarray             # [R, 2] int64: milli-CPU, MiB
    ts: np.ndarray              # [R] float64 creation timestamps
    priority: int
    priority_class: str
    cpu: str
    memory: str
    job_names: List[str]
    job_queue: np.ndarray       # [J] int64 queue index
    job_min: np.ndarray         # [J] int64
    job_ts: np.ndarray          # [J] float64
    on_node: List[List[int]]    # node -> its residents, in order
    key_index: Dict[str, int]   # pod key -> resident index


def make_residents(config: dict, cluster) -> Residents:
    spec = config["residents"]
    n = len(cluster.node_names)
    r = int(spec["pods"])
    size = int(spec["job_size"])
    jobs = (r + size - 1) // size
    ns = spec["namespace"]
    width = len(str(r - 1))
    names = [f"r{i:0{width}d}" for i in range(r)]
    node = np.arange(r, dtype=np.int64) % n
    on_node: List[List[int]] = [[] for _ in range(n)]
    for i, k in enumerate(node.tolist()):
        on_node[k].append(i)
    req = np.empty((r, 2), np.int64)
    req[:, 0] = generator.milli_cpu(spec["cpu"])
    req[:, 1] = generator.memory_bytes(spec["memory"]) // generator.MIB
    jw = len(str(jobs - 1))
    return Residents(
        namespace=ns, names=names, node=node,
        job=np.arange(r, dtype=np.int64) // size, req=req,
        ts=np.arange(r, dtype=np.float64),
        priority=int(config["priority_classes"][spec["priority_class"]]),
        priority_class=spec["priority_class"], cpu=spec["cpu"],
        memory=spec["memory"],
        job_names=[f"rj{j:0{jw}d}" for j in range(jobs)],
        job_queue=np.arange(jobs, dtype=np.int64) % int(spec["queues"]),
        job_min=np.full((jobs,), int(spec["min_member"]), np.int64),
        job_ts=np.arange(jobs, dtype=np.float64),
        on_node=on_node,
        key_index={f"{ns}/{name}": i for i, name in enumerate(names)})


def make_wave(config: dict, traffic: dict, cluster, seed: int, index: int):
    """The burst generator's wave, its gangs sent to queues as the storm
    sends them: even gangs to the last (starved) queue, odd gangs round
    robin over the others; ``priority`` is its class's value."""
    q = len(cluster.queue_names)
    wave = generator.make_wave(traffic, q, seed, index)
    wave.priority = int(config["priority_classes"][traffic["priority_class"]])
    g = np.arange(len(wave.group_names), dtype=np.int64)
    wave.group_queue = np.where(g % 2 == 0, q - 1, (g // 2) % max(1, q - 1))
    return wave


def resident_objects(config: dict, residents: Residents, cluster):
    """(priority classes, the residents' pod groups, their Running pods)."""
    from kube_batch_tpu_torch.api import (Container, ObjectMeta, Pod,
                                          PodSpec, PodStatus)
    from kube_batch_tpu_torch.api.objects import PriorityClass
    from kube_batch_tpu_torch.apis.scheduling import v1alpha1
    ns = residents.namespace
    pcs = [PriorityClass(metadata=ObjectMeta(name=name, uid=f"pc-{name}"),
                         value=int(value))
           for name, value in config["priority_classes"].items()]
    groups = [v1alpha1.PodGroup(
        metadata=ObjectMeta(name=name, namespace=ns, uid=f"{ns}-{name}",
                            creation_timestamp=float(ts)),
        spec=v1alpha1.PodGroupSpec(
            min_member=int(m), queue=cluster.queue_names[int(q)],
            priority_class_name=residents.priority_class))
        for name, q, m, ts in zip(residents.job_names, residents.job_queue,
                                  residents.job_min, residents.job_ts)]
    annotation = v1alpha1.GroupNameAnnotationKey
    pods = [Pod(
        metadata=ObjectMeta(
            name=name, namespace=ns, uid=f"{ns}-{name}",
            annotations={annotation: residents.job_names[int(j)]},
            creation_timestamp=float(ts)),
        spec=PodSpec(node_name=cluster.node_names[int(n)],
                     priority=residents.priority,
                     priority_class_name=residents.priority_class,
                     containers=[Container(requests={
                         "cpu": residents.cpu, "memory": residents.memory})]),
        status=PodStatus(phase="Running"))
        for name, j, n, ts in zip(residents.names, residents.job,
                                  residents.node, residents.ts)]
    return pcs, groups, pods


def wave_objects(wave, cluster, traffic):
    """The wave as API objects: (pod groups, Pending pods) of its priority
    class, in submission order."""
    from kube_batch_tpu_torch.api import (Container, ObjectMeta, Pod,
                                          PodSpec, PodStatus)
    from kube_batch_tpu_torch.apis.scheduling import v1alpha1
    ns = wave.namespace
    pc = traffic["priority_class"]
    cpus, mems = traffic["cpu"], traffic["memory"]
    groups = [v1alpha1.PodGroup(
        metadata=ObjectMeta(name=name, namespace=ns, uid=f"{ns}-{name}",
                            creation_timestamp=float(ts)),
        spec=v1alpha1.PodGroupSpec(
            min_member=int(m), queue=cluster.queue_names[int(q)],
            priority_class_name=pc))
        for name, q, m, ts in zip(wave.group_names, wave.group_queue,
                                  wave.group_min, wave.group_ts)]
    annotation = v1alpha1.GroupNameAnnotationKey
    pods = [Pod(
        metadata=ObjectMeta(
            name=name, namespace=ns, uid=f"{ns}-{name}",
            annotations={annotation: wave.group_names[int(g)]},
            creation_timestamp=float(ts)),
        spec=PodSpec(priority_class_name=pc, containers=[Container(
            requests={"cpu": cpus[int(c)], "memory": mems[int(m)]})]),
        status=PodStatus(phase="Pending"))
        for name, g, c, m, ts in zip(wave.pod_names, wave.pod_group,
                                     wave.pod_cpu, wave.pod_mem, wave.pod_ts)]
    return groups, pods


@dataclass
class Observed:
    """What the program did in one session: [(victim pod key, action)] in
    eviction order, preemptor pod key -> node, the cache's (milli-CPU,
    MiB, pods) per node in cluster order, and every pod group's last
    pushed status so far."""
    victims: List[Tuple[str, str]]
    binds: Dict[str, str]
    node_state: List[Tuple[float, float, int]]
    statuses: Dict[str, object]


def _victims(observed: Observed):
    return [tuple(v) for v in observed.victims]


def _order_mismatches(got, want) -> int:
    common = set(got) & set(want)
    a = [v for v in got if v in common]
    b = [v for v in want if v in common]
    return sum(1 for x, y in zip(a, b) if x != y)


def compare(cluster, residents: Residents, wave, decided,
            observed: List[Observed]) -> Dict[str, int]:
    """The numbers of one cycle: ``decided`` is the reference's list of
    sessions (reference/evict.py ``SessionDecision``), ``observed`` the
    program's."""
    ns = wave.namespace
    rns = residents.namespace
    index = {n: i for i, n in enumerate(cluster.node_names)}
    keys = [f"{ns}/{p}" for p in wave.pod_names]
    out = {"victim_mismatches": 0, "victim_order_mismatches": 0,
           "bind_mismatches": 0, "node_mismatches": 0,
           "group_mismatches": 0, "gang_violations": 0}
    bound = np.zeros(len(wave.group_names), np.int64)
    got_state = want_state = None
    for s in range(max(len(decided), len(observed))):
        d = decided[s] if s < len(decided) else None
        o = observed[s] if s < len(observed) else None
        want_v = [] if d is None else [
            (f"{rns}/{residents.names[r]}", a) for r, a in d.victims]
        got_v = [] if o is None else _victims(o)
        out["victim_mismatches"] += len(set(got_v) ^ set(want_v))
        out["victim_order_mismatches"] += _order_mismatches(got_v, want_v)
        want_b = np.full(len(keys), -1, np.int64) if d is None else d.node
        got_b = np.full(len(keys), -1, np.int64) if o is None else \
            np.asarray([index.get(o.binds.get(k), -1) for k in keys],
                       np.int64)
        out["bind_mismatches"] += int(np.count_nonzero(got_b != want_b))
        bound += np.bincount(wave.pod_group[got_b >= 0],
                             minlength=len(wave.group_names))
        out["gang_violations"] += int(np.count_nonzero(
            (bound > 0) & (bound < wave.group_min)))
        if d is not None:
            want_state = np.concatenate(
                [d.node_used.astype(np.float64),
                 d.node_pods[:, None].astype(np.float64)], axis=1)
        if o is not None:
            got_state = np.asarray(o.node_state,
                                   np.float64).reshape(-1, 3)
        if got_state is None or want_state is None:
            out["node_mismatches"] += len(cluster.node_names)
        else:
            out["node_mismatches"] += int(np.count_nonzero(
                np.any(got_state != want_state, axis=1)))
        statuses = {} if o is None else o.statuses
        want_g = {} if d is None else d.groups
        for key, want in want_g.items():
            status = statuses.get(key)
            if status is None or (status.phase, status.running,
                                  status.failed, status.succeeded) != want:
                out["group_mismatches"] += 1
    return out


def add(total: Dict[str, int], part: Dict[str, int]) -> Dict[str, int]:
    return {k: total.get(k, 0) + part.get(k, 0)
            for k in set(total) | set(part)}


def verdict(numbers: Dict[str, int]):
    """(correct, {name: {"value", "limit"}}) for every number compared."""
    checks = {k: {"value": int(numbers.get(k, 0)), "limit": lim}
              for k, lim in LIMITS.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
