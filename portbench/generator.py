"""The general traffic generator: clusters and waves drawn from the seed.

A configuration file (``configs/<name>.json``) fixes the deployment: the
nodes, the queues and the scheduler conf.  A traffic file
(``traffic/<name>.json``) fixes the mix.  This module turns the two and a
seed into plain arrays, which both sides use: the informer builds the
program's API objects from them, and the reference reads them directly.

Every seed gives the same amount of work: the same nodes, the same set of
queue weights and, in every wave, each (cpu, memory) request pair equally
often.  The seed chooses only their order.

Quantities are in the scheduler's quanta: milli-CPU and MiB.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List

import numpy as np

MIB = 1 << 20
_BINARY = {"Ki": 1 << 10, "Mi": 1 << 20, "Gi": 1 << 30, "Ti": 1 << 40}
_QUANTITY = re.compile(r"^([0-9]+(?:\.[0-9]+)?)(m|Ki|Mi|Gi|Ti)?$")


def milli_cpu(quantity) -> int:
    """A CPU quantity ("250m", "2", 16) in milli-CPU."""
    m = _QUANTITY.match(str(quantity))
    if m is None or m.group(2) not in (None, "m"):
        raise ValueError(f"not a cpu quantity: {quantity!r}")
    value = float(m.group(1))
    return int(round(value if m.group(2) == "m" else value * 1000))


def memory_bytes(quantity) -> int:
    """A memory quantity ("512Mi", "64Gi") in bytes."""
    m = _QUANTITY.match(str(quantity))
    if m is None or m.group(2) in (None, "m"):
        raise ValueError(f"not a binary memory quantity: {quantity!r}")
    return int(round(float(m.group(1)) * _BINARY[m.group(2)]))


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for one stream of the run (``stream`` names
    it, such as the wave's index); any whole seed, however large."""
    return np.random.default_rng(
        np.random.SeedSequence(abs(int(seed)), spawn_key=tuple(stream)))


@dataclass
class Cluster:
    """Nodes in name order and queues in name order."""
    node_names: List[str]
    node_alloc: np.ndarray      # [N, 2] int64: milli-CPU, MiB
    node_pods: np.ndarray       # [N] int64: the pod cap
    node_alloc_raw: dict        # the allocatable as the node object states it
    queue_names: List[str]
    queue_weights: np.ndarray   # [Q] int64
    queue_ts: np.ndarray        # [Q] float64: creation timestamps


@dataclass
class Wave:
    """One wave of pending gangs, pods in submission order."""
    index: int
    namespace: str
    pod_names: List[str]
    pod_cpu: np.ndarray         # [P] int64: index into the traffic's cpu
    pod_mem: np.ndarray         # [P] int64: index into its memory
    pod_req: np.ndarray         # [P, 2] int64: milli-CPU, MiB
    pod_group: np.ndarray       # [P] int64
    pod_ts: np.ndarray          # [P] float64
    group_names: List[str]
    group_queue: np.ndarray     # [G] int64 queue index
    group_min: np.ndarray       # [G] int64
    group_ts: np.ndarray        # [G] float64

    @property
    def pods(self) -> int:
        return len(self.pod_names)


def make_cluster(config: dict, seed: int) -> Cluster:
    n = int(config["nodes"])
    alloc = config["node_allocatable"]
    width = len(str(n - 1))
    node_alloc = np.empty((n, 2), np.int64)
    node_alloc[:, 0] = milli_cpu(alloc["cpu"])
    node_alloc[:, 1] = memory_bytes(alloc["memory"]) // MIB
    q = int(config["queues"])
    weights = np.asarray(config["queue_weights"], np.int64)
    if weights.shape != (q,):
        raise ValueError("queue_weights needs one weight per queue")
    weights = rng_for(seed, 0).permutation(weights)
    return Cluster(
        node_names=[f"n{i:0{width}d}" for i in range(n)],
        node_alloc=node_alloc,
        node_pods=np.full((n,), int(alloc["pods"]), np.int64),
        node_alloc_raw=dict(alloc),
        queue_names=[f"q{i}" for i in range(q)],
        queue_weights=weights,
        queue_ts=np.arange(q, dtype=np.float64))


def make_wave(traffic: dict, n_queues: int, seed: int, index: int) -> Wave:
    """Wave ``index`` of a burst: ``wave_pods`` pods in groups of
    ``group_size`` (the last group may be smaller), groups round robin over
    the queues, every (cpu, memory) pair equally often in a seeded order.
    Timestamps count from 0 in each wave: the keys stay exact in float32."""
    p = int(traffic["wave_pods"])
    size = int(traffic["group_size"])
    cpus, mems = traffic["cpu"], traffic["memory"]
    pairs = len(cpus) * len(mems)
    combo = np.arange(p, dtype=np.int64) % pairs
    combo = rng_for(seed, 1, index).permutation(combo)
    pod_cpu, pod_mem = combo // len(mems), combo % len(mems)
    cpu_q = np.asarray([milli_cpu(c) for c in cpus], np.int64)
    mem_q = np.asarray([memory_bytes(m) // MIB for m in mems], np.int64)
    groups = (p + size - 1) // size
    pod_group = np.arange(p, dtype=np.int64) // size
    counts = np.bincount(pod_group, minlength=groups)
    return Wave(
        index=index,
        namespace=traffic["namespace"],
        pod_names=[f"w{index}-p{i:06d}" for i in range(p)],
        pod_cpu=pod_cpu, pod_mem=pod_mem,
        pod_req=np.stack([cpu_q[pod_cpu], mem_q[pod_mem]], axis=1),
        pod_group=pod_group,
        pod_ts=np.arange(p, dtype=np.float64),
        group_names=[f"w{index}-g{g:05d}" for g in range(groups)],
        group_queue=np.arange(groups, dtype=np.int64) % n_queues,
        group_min=np.minimum(int(traffic["min_member"]), counts),
        group_ts=np.arange(groups, dtype=np.float64))
