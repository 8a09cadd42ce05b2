"""Adversarial scenario generator: seeded workloads vs the sequential
parity oracle (the repo's tools/scenario_gen.py, driving the port).

The chaos soak proves the scheduler survives faults; this harness proves
the batched engines keep making the same decisions as the sequential
controls across adversarial workloads.  :func:`gen_scenario` derives a
complete workload — inventory, priority classes, arrival waves, external
churn deletes — as a pure function of ``(kind, seed)``: the same seed
gives a byte-identical scenario (:func:`scenario_bytes`), and the bytes
equal the reference generator's for every kind and seed.  Five
adversarial kinds:

  * ``gang_deadlock``      — several gangs that each fit alone but not
                             together: exactly one may win, atomically;
  * ``priority_inversion`` — a full cluster of low-priority residents, a
                             mid-priority gang arrives first, then a
                             high-priority gang: preemption must serve
                             priority order, not arrival order;
  * ``churn_storm``        — waves of creates interleaved with external
                             deletes of earlier pods: the incremental and
                             candidate-row paths under churn;
  * ``hetero_pools``       — big/small node pools, selector-pinned and
                             oversized pods, BestEffort backfill;
  * ``frag_pressure``      — a checkerboard-occupied torus and a slice
                             PodGroup: topo-allocate's defrag eviction.

Every scenario runs twice on ``device`` (the card unless ``--device cpu``
is given) — the batched arm (pipelined solve, batched eviction,
incremental sessions, candidate rows, batched box scan, the fused
program) and the sequential arm (every ``KUBE_BATCH_TPU_*=0`` control;
tpu-allocate stays in the conf, so the session kernel runs in both) —
and the sweep asserts, per seed: bit-identical bind map / surviving
pods / eviction set between arms, no accepted double bind at the truth
store, the loop survives every cycle, gang floors hold at convergence
(for gangs untouched by external churn), no node is CPU-overcommitted at
truth, and the device breaker never trips (no fault is injected).  Each
arm reports the session kernel's launches.  ``--replay`` appends one
lineage-ring round trip through :mod:`replay`.

Always prints exactly one JSON artifact line on stdout; exits non-zero
on any violation.

    python -m kube_batch_tpu_torch.tools.scenario_gen --seeds 5 --replay
    python -m kube_batch_tpu_torch.tools.scenario_gen --emit churn_storm:2
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import sys
import time

import torch

# Small shapes must still engage the device scanner + batched engines
# (set before the port's imports).
os.environ.setdefault("KUBE_BATCH_TPU_SCAN_MIN_NODES", "0")

from kube_batch_tpu_torch.cache import Cluster, new_scheduler_cache  # noqa: E402
from kube_batch_tpu_torch.chaos.breaker import device_breaker  # noqa: E402
from kube_batch_tpu_torch.scheduler import Scheduler  # noqa: E402
from kube_batch_tpu_torch.tools import (  # noqa: E402
    add_device_flag, breaker_transitions, cli_device, kernel_launches)
from kube_batch_tpu_torch.tools import replay as replay_mod  # noqa: E402

KINDS = ("gang_deadlock", "priority_inversion", "churn_storm",
         "hetero_pools", "frag_pressure")

# The sequential-oracle arm: every batched/pipelined engine replaced by
# its bit-parity sequential control (each =0 gate is individually pinned
# by its own PR's tests; the sweep exercises them all at once).
SEQUENTIAL_CONTROLS = {
    "KUBE_BATCH_TPU_PIPELINE": "0",
    "KUBE_BATCH_TPU_DELTA_SHIP": "0",
    "KUBE_BATCH_TPU_BATCH_EVICT": "0",
    "KUBE_BATCH_TPU_INCREMENTAL": "0",
    "KUBE_BATCH_TPU_CANDIDATE_SOLVE": "0",
    "KUBE_BATCH_TPU_TOPO_BATCH": "0",
    "KUBE_BATCH_TPU_WIRE_FAST": "0",
    "KUBE_BATCH_TPU_BATCH_COMMIT": "0",
    "KUBE_BATCH_TPU_FUSED": "0",
    "KUBE_BATCH_TPU_FUSED_STORM": "0",
    "KUBE_BATCH_TPU_LAZY_TASKS": "0",
}

BASE_CONF = """
actions: "tpu-allocate, preempt, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

TOPO_CONF = """
actions: "topo-allocate, tpu-allocate, preempt, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: topology
"""

GROUP_KEY = "scheduling.k8s.io/group-name"
SLICE_KEY = "kube-batch.tpu/slice-shape"
NS = "scen"


# ---------------------------------------------------------------------------
# generation (pure functions of (kind, seed))

def _pod_op(name, group, *, cpu="1", mem="1Gi", prio=None, prio_class="",
            ts=0.0, node_name="", phase="Pending", selector=None,
            labels=None):
    requests = {"cpu": cpu, "memory": mem} if cpu else {}
    return {"op": "pod", "name": name, "namespace": NS, "uid": name,
            "annotations": {GROUP_KEY: group}, "labels": labels or {},
            "creation_timestamp": ts, "priority": prio,
            "priority_class_name": prio_class,
            "node_selector": selector or {}, "requests": requests,
            "node_name": node_name, "phase": phase}


def _pg_op(name, min_member, queue, *, prio_class="", ts=0.0, ann=None):
    return {"op": "pod_group", "name": name, "namespace": NS,
            "annotations": ann or {}, "creation_timestamp": ts,
            "min_member": min_member, "queue": queue,
            "priority_class_name": prio_class}


def _gang(waves_ops, name, replicas, min_member, queue, *, cpu="1",
          mem="1Gi", prio=None, prio_class="", ts=0.0, selector=None):
    waves_ops.append(_pg_op(name, min_member, queue, prio_class=prio_class,
                            ts=ts))
    for i in range(replicas):
        waves_ops.append(_pod_op(f"{name}-{i}", name, cpu=cpu, mem=mem,
                                 prio=prio, prio_class=prio_class,
                                 ts=ts + i * 0.001, selector=selector))


def _node_doc(name, cpu, mem, labels=None):
    alloc = {"cpu": cpu, "memory": mem, "pods": "110"}
    return {"name": name, "uid": name, "labels": labels or {},
            "allocatable": alloc, "capacity": dict(alloc)}


def _inventory(nodes, n_queues=2, pcs=(("low", 1), ("mid", 500),
                                       ("high", 1000))):
    return {
        "nodes": nodes,
        "queues": [{"name": f"q{i}", "weight": 1,
                    "creation_timestamp": float(i)}
                   for i in range(n_queues)],
        "priority_classes": [{"name": n, "value": v} for n, v in pcs],
    }


def _gen_gang_deadlock(rng: random.Random) -> dict:
    n_nodes = rng.choice((6, 8, 10))
    slots = 2 * n_nodes  # 2-cpu nodes, 1-cpu members
    nodes = [_node_doc(f"n{i:02d}", "2", "4Gi") for i in range(n_nodes)]
    size = (2 * slots) // 3  # each gang fits alone; no two fit together
    w0, w1 = [], []
    _gang(w0, "gang-a", size, size, "q0", ts=10.0)
    # b and c arrive together next wave: at most one more may ever bind,
    # and only atomically.
    _gang(w1, "gang-b", size, size, "q1", ts=20.0)
    _gang(w1, "gang-c", size, size, "q0", ts=21.0)
    for i in range(rng.randint(1, 3)):  # singleton noise
        w1.append(_pg_op(f"solo-{i}", 1, "q1", ts=30.0 + i))
        w1.append(_pod_op(f"solo-{i}-0", f"solo-{i}", ts=30.0 + i))
    return {"inventory": _inventory(nodes), "waves": [w0, w1],
            "conf": "base"}


def _gen_priority_inversion(rng: random.Random) -> dict:
    n_nodes = rng.choice((6, 8))
    nodes = [_node_doc(f"n{i:02d}", "2", "4Gi") for i in range(n_nodes)]
    w0 = []
    # Residents: one low-priority Running 2-cpu pod per node — the
    # cluster is FULL; anything else must preempt.
    for i in range(n_nodes):
        w0.append(_pg_op(f"res-{i}", 1, "q0", prio_class="low",
                         ts=float(i)))
        w0.append(_pod_op(f"res-{i}-0", f"res-{i}", cpu="2", mem="2Gi",
                          prio=1, prio_class="low", ts=float(i),
                          node_name=f"n{i:02d}", phase="Running"))
    # The inversion: mid arrives first (wave 1), high arrives after
    # (wave 2) — high must win nodes even though mid got there first.
    mid_size = max(2, n_nodes // 2)
    high_size = max(2, n_nodes // 2)
    w1, w2 = [], []
    _gang(w1, "mid", mid_size, mid_size, "q1", cpu="2", mem="2Gi",
          prio=500, prio_class="mid", ts=100.0)
    _gang(w2, "high", high_size, high_size, "q0", cpu="2", mem="2Gi",
          prio=1000, prio_class="high", ts=200.0)
    return {"inventory": _inventory(nodes), "waves": [w0, w1, w2],
            "conf": "base"}


def _gen_churn_storm(rng: random.Random) -> dict:
    n_nodes = rng.choice((6, 8))
    nodes = [_node_doc(f"n{i:02d}", "2", "4Gi") for i in range(n_nodes)]
    w0 = []
    base_pods = []
    n_gangs = rng.randint(3, 5)
    for g in range(n_gangs):
        name = f"base-{g}"
        _gang(w0, name, 4, 1, f"q{g % 2}", ts=float(g))
        base_pods.extend(f"{NS}/{name}-{i}" for i in range(4))
    # Storm waves: delete a seeded sample of the earlier pods while new
    # jobs land — maximal dirty-set churn for the incremental paths.
    w1 = [{"op": "delete", "key": k}
          for k in rng.sample(base_pods, len(base_pods) // 3)]
    _gang(w1, "wave1", 4, 2, "q1", ts=50.0)
    survivors = [k for k in base_pods
                 if {"op": "delete", "key": k} not in w1]
    w2 = [{"op": "delete", "key": k}
          for k in rng.sample(survivors, max(1, len(survivors) // 4))]
    _gang(w2, "wave2", 3, 3, "q0", ts=60.0)
    return {"inventory": _inventory(nodes), "waves": [w0, w1, w2],
            "conf": "base"}


def _gen_hetero_pools(rng: random.Random) -> dict:
    n_big = rng.choice((2, 3))
    n_small = rng.choice((4, 6))
    nodes = ([_node_doc(f"big{i}", "8", "16Gi", {"pool": "big"})
              for i in range(n_big)]
             + [_node_doc(f"sm{i}", "1", "2Gi", {"pool": "small"})
                for i in range(n_small)])
    w0, w1 = [], []
    # Selector-pinned to the big pool.
    _gang(w0, "pinned", n_big, n_big, "q0", cpu="4", mem="8Gi", ts=1.0,
          selector={"pool": "big"})
    # Oversized for the small pool — must land big by resources alone.
    _gang(w0, "fat", rng.randint(1, 2), 1, "q1", cpu="3", mem="3Gi",
          ts=2.0)
    # Fits anywhere.
    _gang(w1, "thin", n_small, 1, "q1", cpu="500m", mem="256Mi", ts=10.0)
    # BestEffort backfill.
    for i in range(2):
        w1.append(_pg_op(f"be-{i}", 1, "q0", ts=20.0 + i))
        w1.append(_pod_op(f"be-{i}-0", f"be-{i}", cpu="", ts=20.0 + i))
    return {"inventory": _inventory(nodes), "waves": [w0, w1],
            "conf": "base"}


def _gen_frag_pressure(rng: random.Random) -> dict:
    # The same checkerboard-torus workload models/synthetic.
    # make_topo_cache builds, expressed as replayable wave docs — keep
    # the two in step when tuning either.
    from kube_batch_tpu_torch.models.topology import (AXIS_LABELS, POD_LABEL,
                                                RACK_LABEL)
    dims = rng.choice(((4, 4, 2), (4, 2, 2)))
    dx, dy, dz = dims
    nodes, w0 = [], []
    filler_ix = 0
    for x in range(dx):
        for y in range(dy):
            for z in range(dz):
                name = f"t-{x}-{y}-{z}"
                labels = {POD_LABEL: "pod-a", RACK_LABEL: str(x // 2),
                          AXIS_LABELS[0]: str(x), AXIS_LABELS[1]: str(y),
                          AXIS_LABELS[2]: str(z)}
                nodes.append(_node_doc(name, "8", "16Gi", labels))
                # Checkerboard residents: free capacity everywhere,
                # contiguity nowhere (doc/TOPOLOGY.md).
                if (x + y + z) % 2 == 0:
                    pg = f"fill-{filler_ix}"
                    w0.append(_pg_op(pg, 1, "q0", prio_class="low",
                                     ts=float(filler_ix)))
                    w0.append(_pod_op(
                        f"{pg}-0", pg, cpu="4", mem="4Gi", prio=1,
                        prio_class="low", ts=float(filler_ix),
                        node_name=name, phase="Running"))
                    filler_ix += 1
    w1 = []
    vol = 8  # 2x2x2
    w1.append(_pg_op("slice0", vol, "q1", prio_class="high", ts=100.0,
                     ann={SLICE_KEY: "2x2x2"}))
    for i in range(vol):
        w1.append(_pod_op(f"slice0-{i}", "slice0", cpu="4", mem="4Gi",
                          prio=1000, prio_class="high",
                          ts=100.0 + i * 0.001))
    # Flat pending noise alongside the slice.
    for i in range(rng.randint(1, 3)):
        w1.append(_pg_op(f"flat-{i}", 1, "q0", ts=200.0 + i))
        w1.append(_pod_op(f"flat-{i}-0", f"flat-{i}", cpu="1",
                          mem="1Gi", ts=200.0 + i))
    return {"inventory": _inventory(nodes), "waves": [w0, w1],
            "conf": "topo"}


_GENERATORS = {
    "gang_deadlock": _gen_gang_deadlock,
    "priority_inversion": _gen_priority_inversion,
    "churn_storm": _gen_churn_storm,
    "hetero_pools": _gen_hetero_pools,
    "frag_pressure": _gen_frag_pressure,
}


def gen_scenario(kind: str, seed: int) -> dict:
    """One scenario spec, a pure function of ``(kind, seed)``.  String
    seeding uses a stable hash (random.Random hashes str seeds with
    sha512), so the stream — and therefore the spec bytes — is
    identical on every run and platform."""
    rng = random.Random(f"{kind}:{seed}")
    spec = _GENERATORS[kind](rng)
    spec.update({"kind": kind, "seed": seed})
    return spec


def scenario_bytes(spec: dict) -> bytes:
    """Canonical serialization — the byte-identity the determinism
    contract (and its test) compares."""
    return json.dumps(spec, sort_keys=True,
                      separators=(",", ":")).encode()


# ---------------------------------------------------------------------------
# running

class TruthMonitor:
    """The chaos soak's truth-store watch (chaos_soak.py): an
    ACCEPTED bind for an already-bound pod is a double-bind violation;
    deletes are the eviction ledger."""

    def __init__(self, cluster: Cluster):
        self.violations: list = []
        self.deletes: list = []
        orig_bind = cluster.bind_pod
        orig_delete = cluster.delete_pod

        def checked_bind(ns, name, hostname):
            key = f"{ns}/{name}"
            with cluster.lock:
                pod = cluster.pods.get(key)
                existing = pod.spec.node_name if pod is not None else None
            result = orig_bind(ns, name, hostname)
            if existing:
                self.violations.append(
                    f"double bind ACCEPTED: {key} already on "
                    f"{existing}, re-bound to {hostname}")
            return result

        def checked_delete(ns, name):
            self.deletes.append(f"{ns}/{name}")
            return orig_delete(ns, name)

        cluster.bind_pod = checked_bind
        cluster.delete_pod = checked_delete


def _conf_of(spec: dict) -> str:
    return TOPO_CONF if spec["conf"] == "topo" else BASE_CONF


def _apply_wave(cluster: Cluster, ops) -> None:
    for op in ops:
        if op["op"] == "pod_group":
            cluster.create_pod_group(replay_mod.build_pg(op))
        elif op["op"] == "pod":
            cluster.create_pod(replay_mod.build_pod(op))
        elif op["op"] == "delete":
            ns, name = op["key"].split("/", 1)
            try:
                cluster.delete_pod(ns, name)
            except KeyError:
                pass  # already evicted — the churn raced a preemption
        else:
            raise ValueError(f"unknown op {op['op']!r}")


@contextlib.contextmanager
def _env(overrides: dict):
    """The arm's knob overrides for the block, the prior values restored
    after it."""
    # lint: disable=knob-registry (saves the prior values to restore them after the arm; the knobs are read through knobs.py inside it)
    prior = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    try:
        yield
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_arm(spec: dict, *, sequential: bool, cycles_per_wave: int = 4,
            drain_cap: int = 40, archive: bool = False, device=None,
            dtype: torch.dtype = torch.float32) -> dict:
    """One arm of one scenario: build the cluster, land the waves at the
    recorded cadence, drain to quiescence, the Scheduler's actions on
    ``device`` (the card unless the CPU is asked for) with ``dtype``
    keys.  ``archive=True`` wraps the truth store in replay.py's
    SpecArchive and returns the captured trace alongside the outcome
    (the lineage ring is cleared first so the capture sees only this
    run).  The outcome also holds the arm's session-kernel launches,
    breaker trips and wall seconds."""
    overrides = dict(SEQUENTIAL_CONTROLS) if sequential else {}
    began = time.perf_counter()
    launches0, trips0 = kernel_launches(), breaker_transitions("open")
    with _env(overrides):
        cluster = Cluster()
        spec_archive = replay_mod.SpecArchive(cluster) if archive else None
        monitor = TruthMonitor(cluster)
        inv = spec["inventory"]
        for doc in inv["priority_classes"]:
            cluster.create_priority_class(replay_mod.build_pc(doc))
        for doc in inv["queues"]:
            cluster.create_queue(replay_mod.build_queue(doc))
        for doc in inv["nodes"]:
            cluster.create_node(replay_mod.build_node(doc))
        if archive:
            replay_mod.lineage.refresh()
        cache = new_scheduler_cache(cluster)
        scheduler = Scheduler(cache, scheduler_conf=_conf_of(spec),
                              schedule_period=3600, device=device,
                              dtype=dtype)
        device_breaker().reset()
        loop_deaths: list = []

        def one_cycle() -> None:
            try:
                scheduler.cycle()
            except Exception as exc:  # the loop-survival contract broke
                # lint: allow-swallow(recorded in loop_deaths and failed loudly at the end — the generator keeps driving waves to expose later breakage too)
                loop_deaths.append(f"{type(exc).__name__}: {exc}")

        for ops in spec["waves"]:
            _apply_wave(cluster, ops)
            for _ in range(cycles_per_wave):
                one_cycle()
        stable, last = 0, (None, None)
        quiesced = False
        for _ in range(drain_cap):
            one_cycle()
            state = (replay_mod._truth_binds(cluster),
                     replay_mod._truth_pods(cluster))
            stable = stable + 1 if state == last else 0
            last = state
            if stable >= 2:
                quiesced = True
                break
        out = {
            "bind_map": replay_mod._truth_binds(cluster),
            "pods": sorted(replay_mod._truth_pods(cluster)),
            "deletes": sorted(set(monitor.deletes)),
            "violations": monitor.violations,
            "loop_deaths": loop_deaths,
            "quiesced": quiesced,
            "launches": kernel_launches() - launches0,
            "breaker_trips": breaker_transitions("open") - trips0,
            "wall_s": time.perf_counter() - began,
        }
        if archive:
            out["trace"] = replay_mod.capture(spec_archive, _conf_of(spec))
            replay_mod.lineage.refresh()
        return out


def record_trace(spec: dict, cycles_per_wave: int = 4, *, device=None,
                 dtype: torch.dtype = torch.float32) -> dict:
    """Record one batched-arm run of ``spec`` and return its replay
    trace (replay.py's round-trip input)."""
    return run_arm(spec, sequential=False,
                   cycles_per_wave=cycles_per_wave, archive=True,
                   device=device, dtype=dtype)["trace"]


# ---------------------------------------------------------------------------
# invariants

def _cpu_milli(raw: str) -> int:
    raw = str(raw)
    if raw.endswith("m"):
        return int(raw[:-1])
    return int(float(raw) * 1000)


def _spec_pods(spec: dict) -> dict:
    out = {}
    for ops in spec["waves"]:
        for op in ops:
            if op["op"] == "pod":
                out[f"{op['namespace']}/{op['name']}"] = op
    return out


def check_invariants(spec: dict, arm: dict) -> list:
    """Per-arm hard invariants (beyond the cross-arm parity compare)."""
    errs = list(arm["violations"]) + list(arm["loop_deaths"])
    if not arm["quiesced"]:
        errs.append("arm never quiesced")
    if arm.get("breaker_trips"):
        errs.append(f"the device breaker tripped {arm['breaker_trips']} "
                    f"times with no fault injected")
    pods = _spec_pods(spec)
    ext_deleted_groups = set()
    for ops in spec["waves"]:
        for op in ops:
            if op["op"] == "delete":
                doc = pods.get(op["key"])
                if doc is not None:
                    ext_deleted_groups.add(doc["annotations"][GROUP_KEY])
    # Gang floors at convergence — external churn legitimately shrinks a
    # gang below its floor, so only untouched gangs are held to it.
    groups: dict = {}
    for ops in spec["waves"]:
        for op in ops:
            if op["op"] == "pod_group" and op["min_member"] > 1 \
                    and op["name"] not in ext_deleted_groups:
                groups[op["name"]] = op["min_member"]
    bound_per_group: dict = {}
    for key in arm["bind_map"]:
        doc = pods.get(key)
        if doc is not None:
            g = doc["annotations"][GROUP_KEY]
            bound_per_group[g] = bound_per_group.get(g, 0) + 1
    for g, floor in groups.items():
        n = bound_per_group.get(g, 0)
        if 0 < n < floor:
            errs.append(f"gang floor broken: {g} has {n} bound "
                        f"< min_member {floor}")
    # CPU overcommit at truth.
    alloc = {d["name"]: _cpu_milli(d["allocatable"]["cpu"])
             for d in spec["inventory"]["nodes"]}
    load: dict = {}
    for key, node in arm["bind_map"].items():
        doc = pods.get(key)
        cpu = doc["requests"].get("cpu", "") if doc else ""
        if cpu:
            load[node] = load.get(node, 0) + _cpu_milli(cpu)
    over = {n: (used, alloc.get(n, 0)) for n, used in load.items()
            if used > alloc.get(n, 0)}
    if over:
        errs.append(f"nodes CPU-overcommitted at truth: {over}")
    return errs


def compare_arms(batched: dict, sequential: dict) -> list:
    """The parity-oracle contract: bit-identical outcomes."""
    errs = []
    if batched["bind_map"] != sequential["bind_map"]:
        only_b = set(batched["bind_map"].items()) - set(
            sequential["bind_map"].items())
        only_s = set(sequential["bind_map"].items()) - set(
            batched["bind_map"].items())
        errs.append(f"bind map diverged from the sequential oracle "
                    f"(batched-only={sorted(only_b)[:6]}, "
                    f"oracle-only={sorted(only_s)[:6]})")
    if batched["pods"] != sequential["pods"]:
        errs.append("surviving pod set diverged from the oracle")
    if batched["deletes"] != sequential["deletes"]:
        errs.append(f"eviction set diverged "
                    f"(batched={batched['deletes']}, "
                    f"oracle={sequential['deletes']})")
    return errs


# ---------------------------------------------------------------------------
# the sweep

def run_sweep(n_seeds: int, cycles_per_wave: int, *,
              with_replay: bool, device=None,
              dtype: torch.dtype = torch.float32) -> dict:
    results = []
    ok = True
    for i in range(n_seeds):
        kind = KINDS[i % len(KINDS)]
        spec = gen_scenario(kind, i)
        if scenario_bytes(spec) != scenario_bytes(gen_scenario(kind, i)):
            results.append({"kind": kind, "seed": i, "errors":
                            ["generator is nondeterministic for this "
                             "seed"]})
            ok = False
            continue
        t0 = time.time()
        batched = run_arm(spec, sequential=False,
                          cycles_per_wave=cycles_per_wave, device=device,
                          dtype=dtype)
        oracle = run_arm(spec, sequential=True,
                         cycles_per_wave=cycles_per_wave, device=device,
                         dtype=dtype)
        errors = (check_invariants(spec, batched)
                  + [f"oracle arm: {e}"
                     for e in check_invariants(spec, oracle)]
                  + compare_arms(batched, oracle))
        if not batched["bind_map"]:
            errors.append("vacuous scenario: nothing bound")
        row = {"kind": kind, "seed": i,
               "binds": len(batched["bind_map"]),
               "evictions": len(batched["deletes"]),
               "wall_s": round(time.time() - t0, 1),
               "launches": {"batched": batched["launches"],
                            "sequential": oracle["launches"]},
               "breaker_trips": (batched["breaker_trips"]
                                 + oracle["breaker_trips"]),
               "errors": errors}
        print(f"  [{i + 1}/{n_seeds}] {kind} seed={i}: "
              f"{row['binds']} binds, {row['evictions']} evictions "
              f"{'OK' if not errors else 'FAIL ' + '; '.join(errors)}",
              file=sys.stderr)
        results.append(row)
        ok = ok and not errors
    out = {"scenarios": results, "seeds": n_seeds}
    if with_replay:
        spec = gen_scenario("frag_pressure", 0)
        trace = record_trace(spec, cycles_per_wave=cycles_per_wave,
                             device=device, dtype=dtype)
        replayed = replay_mod.replay(trace, device=device, dtype=dtype)
        errors = replay_mod.compare(trace, replayed)
        if not trace["recorded"]["bind_map"]:
            errors.append("vacuous replay: the recorded run bound "
                          "nothing")
        out["replay"] = {"recorded_binds":
                         len(trace["recorded"]["bind_map"]),
                         "errors": errors}
        print(f"  replay round-trip: "
              f"{out['replay']['recorded_binds']} binds "
              f"{'OK' if not errors else 'FAIL ' + '; '.join(errors)}",
              file=sys.stderr)
        ok = ok and not errors
    out["ok"] = ok
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--seeds", type=int, default=20,
                    help="scenarios to run (kinds cycle; seed = index)")
    ap.add_argument("--cycles", type=int, default=4,
                    help="scheduler cycles per arrival wave")
    ap.add_argument("--replay", action="store_true",
                    help="append one lineage-ring replay round trip")
    ap.add_argument("--emit", help="write a scenario spec (KIND:SEED) "
                    "as canonical JSON to stdout and exit")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    if args.emit:
        kind, _, seed = args.emit.partition(":")
        sys.stdout.buffer.write(
            scenario_bytes(gen_scenario(kind, int(seed or 0))))
        sys.stdout.buffer.write(b"\n")
        return 0

    device = cli_device(args, "scenario_gen")
    if device is None:
        return 1
    start = time.time()
    out = run_sweep(args.seeds, args.cycles, with_replay=args.replay,
                    device=device)
    out["wall_s"] = round(time.time() - start, 1)
    print(json.dumps(out, sort_keys=True))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
