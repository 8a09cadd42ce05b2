"""Replica-federation convergence soak (the repo's tools/replica_soak.py,
driving the port; doc/TENANCY.md).

Drives 2-3 active-active scheduler replicas in one process — each with
its own SchedulerCache + Scheduler + TenancyEngine over one shared truth
store, each claiming queue-shards via per-shard CAS leases
(tenancy/leases.ShardLeaseManager; with ``--edge`` the last replica
speaks to the store over the port's ApiServer + RemoteCluster wire,
leases included) — through seeded churn, an optional seeded lease-fault
phase (chaos sites ``lease.cas_conflict`` / ``lease.clock_skew``), and a
mid-run replica kill (crash semantics: the dead replica's leases are not
released and must expire), then asserts the federation contract:

  * no bind is ever accepted by the truth store for an already-bound pod
    (rejected duplicate POSTs — the 409 backstop working — are recorded
    and legal);
  * every orphaned shard is reclaimed by a survivor within one lease
    duration (+ one retry tick of scheduling slack);
  * fairness holds across replica boundaries: after convergence every
    queue's demand is fully bound, regardless of which replica owned its
    shard when;
  * the adopting replica's first sessions on the stolen shards are
    served by the shared compile cache — the hit counter moves, the miss
    counter does not (on the card: the session kernel's key ledger,
    ``ops/compile_cache.py``; K1's library is loaded once per process);
  * bind egress is stamped with the owning replica
    (kube_batch_shard_binds_total).

Every replica's Scheduler runs on ``device`` (the card unless
``--device cpu`` is given); on the card each shard session runs on its
view's own CUDA stream (``ShardView.stream``).  The artifact adds the
session kernel's launches.  Always prints exactly one JSON artifact
line; exits non-zero on any violated invariant.

    python -m kube_batch_tpu_torch.tools.replica_soak --replicas 3 \
        --shards 3 --churn-rounds 12 --edge
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import random
import sys
import threading
import time

import torch

# Small shapes must still engage the device scanner (set before the
# port's imports).
os.environ.setdefault("KUBE_BATCH_TPU_SCAN_MIN_NODES", "0")

from kube_batch_tpu_torch.cache import Cluster, new_scheduler_cache  # noqa: E402
from kube_batch_tpu_torch.api.objects import (  # noqa: E402
    Container, Node, NodeSpec, NodeStatus, ObjectMeta, Pod, PodSpec,
    PodStatus)
from kube_batch_tpu_torch.apis.scheduling import v1alpha1  # noqa: E402
from kube_batch_tpu_torch.chaos import plan as chaos_plan  # noqa: E402
from kube_batch_tpu_torch.edge.wire_shard import QUEUE_LABEL  # noqa: E402
from kube_batch_tpu_torch.metrics import memledger  # noqa: E402
from kube_batch_tpu_torch.metrics.metrics import (  # noqa: E402
    compile_cache_counts, shard_bind_counts, shard_rebalance_counts,
    shard_session_counts)
from kube_batch_tpu_torch.scheduler import Scheduler  # noqa: E402
from kube_batch_tpu_torch.tenancy import (ShardLeaseManager,  # noqa: E402
                                          ShardMap, TenancyEngine)
from kube_batch_tpu_torch.tools import (  # noqa: E402
    add_device_flag, cli_device, kernel_launches)


def _mk_pod(name, group, ns="soak", cpu="1", mem="1Gi", queue=""):
    # The queue label makes the pod shard-attributable SERVER-SIDE, so
    # a scoped edge replica's unassigned stream can drop foreign-shard
    # pods on the server instead of shipping them (doc/INGEST.md).
    labels = {QUEUE_LABEL: queue} if queue else None
    return Pod(
        metadata=ObjectMeta(
            name=name, namespace=ns, labels=labels,
            annotations={v1alpha1.GroupNameAnnotationKey: group}),
        spec=PodSpec(node_name="",
                     containers=[Container(
                         requests={"cpu": cpu, "memory": mem})]),
        status=PodStatus(phase="Pending"))


def _submit_job(cluster, name, replicas, queue, ns="soak"):
    cluster.create_pod_group(v1alpha1.PodGroup(
        metadata=ObjectMeta(name=name, namespace=ns),
        spec=v1alpha1.PodGroupSpec(min_member=replicas, queue=queue)))
    for i in range(replicas):
        cluster.create_pod(_mk_pod(f"{name}-{i}", name, ns=ns,
                                   queue=queue))


class TruthMonitor:
    """Double-bind detector at the truth store (the chaos_soak pattern):
    an ACCEPTED re-bind is a violation, a REJECTED one (the store's 409
    path) is the backstop doing its job."""

    def __init__(self, cluster: Cluster):
        self.violations: list = []
        self.binds: list = []
        self.rejected_rebinds: list = []
        orig_bind = cluster.bind_pod

        def checked_bind(ns, name, hostname):
            key = f"{ns}/{name}"
            with cluster.lock:
                pod = cluster.pods.get(key)
                existing = pod.spec.node_name if pod is not None else None
            try:
                result = orig_bind(ns, name, hostname)
            except Exception:
                if existing:
                    self.rejected_rebinds.append((key, existing, hostname))
                raise
            if existing:
                self.violations.append(
                    f"double bind ACCEPTED: {key} already on {existing}, "
                    f"re-bound to {hostname}")
            self.binds.append((key, hostname, time.time()))
            return result

        cluster.bind_pod = checked_bind


class Replica:
    """One active-active scheduler replica: cache + scheduler + tenancy
    engine + shard lease manager, driven by its own loop thread."""

    def __init__(self, name: str, truth: Cluster, shard_map: ShardMap,
                 lease_duration: float, target_shards: int,
                 edge: bool = False, period: float = 0.15, device=None,
                 dtype: torch.dtype = torch.float32):
        self.name = name
        self.period = period
        self.shard_map = shard_map
        self._server = self._remote = None
        if edge:
            from kube_batch_tpu_torch.edge import ApiServer, RemoteCluster
            self._server = ApiServer(truth).start()
            # Created UNSTARTED: the shard scope must be attached before
            # the reflectors connect so the very first watch carries the
            # shard-filtered selectors (doc/INGEST.md).
            self._remote = RemoteCluster(self._server.url)
            store = self._remote
        else:
            store = truth
        self.cache = new_scheduler_cache(store)
        self.scheduler = Scheduler(self.cache, schedule_period=3600,
                                   device=device, dtype=dtype)
        self.leases = ShardLeaseManager(
            store, "soak", shard_map.num_shards, identity=name,
            lease_duration=lease_duration,
            renew_deadline=lease_duration * 0.6,
            retry_period=max(0.02, lease_duration / 10.0),
            target_shards=target_shards)
        self.engine = TenancyEngine(self.scheduler, shard_map,
                                    lease_mgr=self.leases)
        self.scheduler.tenancy = self.engine
        if self._remote is not None:
            # AFTER attach_leases (the engine constructor ran it): the
            # helper pins the count-based claim rule and chains the
            # lease on_change hook into scope bumps, so every claim/
            # steal/shed triggers a scoped relist on this replica.
            from kube_batch_tpu_torch.edge.wire_shard import \
                attach_shard_scope
            self.scope = attach_shard_scope(self._remote, shard_map,
                                            self.leases)
            self._remote.start()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"replica-{name}")

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.scheduler.cycle()
            self._stop.wait(self.period)

    def start(self) -> "Replica":
        self.leases.start()
        self._thread.start()
        return self

    def owned(self):
        return self.leases.owned_shards()

    def stale_mirror_entries(self):
        """Scoped-mirror hygiene probe: entries this replica's CURRENT
        shard ownership does not justify — podgroups of unowned queues
        and queue-labeled UNASSIGNED pods of unowned queues (bound pods
        are whole-fleet by design: occupancy needs them).  Nonempty
        after a handover settles means a shed/steal left stale state
        behind (doc/INGEST.md "Handover")."""
        if self._remote is None or getattr(self, "scope", None) is None:
            return []
        owned = set(self.leases.owned_shards())
        stale = []
        with self._remote.lock:
            for key, group in self._remote.pod_groups.items():
                if self.shard_map.shard_of(group.spec.queue) not in owned:
                    stale.append(f"podgroup:{key}")
            for key, pod in self._remote.pods.items():
                if pod.spec.node_name:
                    continue
                q = (pod.metadata.labels or {}).get(QUEUE_LABEL)
                if q is not None \
                        and self.shard_map.shard_of(q) not in owned:
                    stale.append(f"pod:{key}")
        return stale

    def kill(self) -> None:
        """Crash semantics: the loop dies, the leases are NOT released —
        survivors must wait out the expiry and steal."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        self.leases.stop(release=False)
        self._teardown_edge()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self.leases.stop(release=True)
        self._teardown_edge()

    def _teardown_edge(self) -> None:
        if self._remote is not None:
            self._remote.stop()
            self._remote = None
        if self._server is not None:
            self._server.stop()
            self._server = None


def run_soak(*, replicas: int = 3, shards: int = 3, nodes: int = 12,
             churn_rounds: int = 20, seed: int = 1,
             lease_duration: float = 1.5, edge: bool = False,
             lease_chaos_rate: float = 0.15, device=None,
             dtype: torch.dtype = torch.float32) -> dict:
    """The soak (see the module): every replica's Scheduler on
    ``device`` (the card unless the CPU is asked for) with ``dtype``
    keys.  Returns the artifact (``ok`` False on any violated
    invariant)."""
    launches0 = kernel_launches()
    truth = Cluster()
    monitor = TruthMonitor(truth)
    queues = [f"q{i}" for i in range(shards)]
    shard_map = ShardMap(shards, {q: i for i, q in enumerate(queues)})
    for q in queues:
        truth.create_queue(v1alpha1.Queue(
            metadata=ObjectMeta(name=q),
            spec=v1alpha1.QueueSpec(weight=1)))
    for i in range(nodes):
        alloc = {"cpu": "2", "memory": "4Gi", "pods": 110}
        truth.create_node(Node(
            metadata=ObjectMeta(name=f"node-{i:03d}", uid=f"node-{i:03d}"),
            spec=NodeSpec(),
            status=NodeStatus(allocatable=alloc, capacity=dict(alloc))))
    # Base demand: per queue, two 2-member gangs = 4 cpu/queue, well
    # under nodes*2 total so every pod MUST eventually bind (the
    # cross-replica fairness invariant below).
    expected = {}
    for qi, q in enumerate(queues):
        for g in range(2):
            _submit_job(truth, f"base-{qi}-{g}", 2, q)
            expected[q] = expected.get(q, 0) + 2

    target = max(1, (shards + replicas - 1) // replicas)
    fleet = [Replica(f"rep-{i}", truth, shard_map, lease_duration, target,
                     edge=(edge and i == replicas - 1), device=device,
                     dtype=dtype)
             for i in range(replicas)]
    problems: list = []
    rng = random.Random(seed)
    try:
        for rep in fleet:
            rep.start()

        def owned_union():
            out = set()
            for rep in fleet:
                if not rep._stop.is_set():
                    out.update(rep.owned())
            return out

        def unbound():
            with truth.lock:
                return [k for k, p in truth.pods.items()
                        if not p.spec.node_name]

        deadline = time.time() + 10 * lease_duration
        while len(owned_union()) < shards and time.time() < deadline:
            time.sleep(0.05)
        if len(owned_union()) < shards:
            problems.append(
                f"federation never covered all shards: {sorted(owned_union())}")

        # Warm-up barrier: the base demand binds (every shard solved and
        # compiled its bucket) before churn and the fault phase begin.
        deadline = time.time() + 60
        while unbound() and time.time() < deadline:
            time.sleep(0.05)
        if unbound():
            problems.append("base demand never bound during warm-up")

        # Fleet memory ledger: the pre-storm reference sample.  The
        # churn is balanced (each gang retires two rounds later), so
        # the drainable ledgers must come back near this level after
        # convergence — the post-drain leak gate below.
        mem_pre = memledger.totals()

        # Seeded churn, optionally under seeded lease faults: create a
        # gang in a random queue each round, retire an old churn gang
        # two rounds later (its pods are deleted at truth).
        if lease_chaos_rate > 0:
            # Budgeted: the seeded lease-fault storm exercises the CAS
            # conflict and clock-skew abandon paths, then drains so the
            # churn phase also observes fault-free renewals.
            chaos_plan.install(chaos_plan.FaultPlan(
                seed=seed, rate=lease_chaos_rate, budget=40,
                sites=("lease.cas_conflict", "lease.clock_skew")))
        retire = []
        kill_at = churn_rounds // 2
        killed = None
        kill_t = orphaned = None
        miss_before_kill = hits_before_kill = None
        reclaim_s = None
        for rnd in range(churn_rounds):
            # Round-robin queue choice keeps every shard's session shape
            # inside the bucket envelope it reached BEFORE the kill (the
            # first pass over the queues maxes each one out), so the
            # zero-fresh-compile failover assertion below measures
            # FAILOVER, not a churn-driven bucket crossing.  The rng
            # seeds the inter-round timing jitter instead.
            q = queues[rnd % len(queues)]
            name = f"churn-{rnd}"
            # Retire BEFORE submitting: the retiree is this same queue's
            # previous churn gang (round r-3, same residue), so the
            # queue's job count never transiently exceeds its envelope —
            # a mid-round snapshot cannot cross a bucket boundary.
            if len(retire) >= len(queues):
                old, oq = retire.pop(0)
                for i in range(2):
                    try:
                        truth.delete_pod("soak", f"{old}-{i}")
                    except KeyError:
                        pass
                truth.delete_pod_group("soak", old)
                expected[oq] -= 2
            _submit_job(truth, name, 2, q)
            expected[q] = expected.get(q, 0) + 2
            retire.append((name, q))
            if rnd == kill_at:
                # Catch-up barrier: every shape churn has produced so
                # far must be solved (and its executable compiled)
                # before the baseline counters are recorded — the
                # zero-fresh-compile assertion measures the ADOPTION,
                # not a pre-kill compile still in flight.
                deadline = time.time() + 60
                while unbound() and time.time() < deadline:
                    time.sleep(0.05)
                # Lease faults stop before the kill so the reclaim
                # clock below measures failover, not injected conflict.
                chaos_plan.disable()
                killed = fleet[0]
                orphaned = set(killed.owned())
                hits_before_kill, miss_before_kill = \
                    compile_cache_counts()
                survivors = [r for r in fleet if r is not killed]
                kill_t = time.time()
                killed.kill()
                # Reclaim watcher: sample the survivors' ownership from
                # the moment of the kill so reclaim_s measures the steal
                # itself, not when the churn loop got around to looking.
                reclaim_box: dict = {}

                def _watch_reclaim():
                    while ("stop" not in reclaim_box
                           and time.time() - kill_t < 60.0):
                        holders = set()
                        for rep in survivors:
                            holders.update(rep.owned())
                        if orphaned <= holders:
                            reclaim_box["s"] = time.time() - kill_t
                            return
                        time.sleep(0.02)

                watcher = threading.Thread(target=_watch_reclaim,
                                           daemon=True)
                watcher.start()
            time.sleep(0.08 + rng.random() * 0.04)
        chaos_plan.disable()

        if killed is None:
            problems.append("kill phase never ran (too few churn rounds)")
        else:
            retry = killed.leases.retry_period
            # One lease duration is the failover contract; the slack
            # covers lease ticks and GIL contention from the other
            # replicas' live sessions (one process impersonating a
            # fleet; the edge leg adds reflector + HTTP threads).
            slack = 4 * retry + (4.0 if edge else 2.0)
            deadline = kill_t + lease_duration + slack
            while "s" not in reclaim_box and time.time() < deadline:
                time.sleep(0.02)
            reclaim_box["stop"] = True   # drain the sampler: its result
            watcher.join(timeout=2.0)    # (if any) is in the box already
            reclaim_s = reclaim_box.get("s")
            if reclaim_s is None:
                holders = set()
                for rep in survivors:
                    holders.update(rep.owned())
                problems.append(
                    f"orphaned shards {sorted(orphaned - holders)} not "
                    f"reclaimed within one lease duration "
                    f"({lease_duration}s + {slack:.1f}s slack) of the kill")

        # Convergence: every queue's remaining demand fully bound at
        # truth, across replica boundaries.
        deadline = time.time() + 60 * (2 if edge else 1)
        while unbound() and time.time() < deadline:
            time.sleep(0.1)
        leftovers = unbound()
        if leftovers:
            problems.append(
                f"{len(leftovers)} pods never bound after convergence "
                f"wait (cross-replica fairness broke): "
                f"{sorted(leftovers)[:6]}")

        # Post-drain leak gate (doc/OBSERVABILITY.md "Memory ledger"):
        # with the churn retired and demand converged, every hook must
        # still reconcile with its store, and the drainable ledgers
        # must sit near the pre-storm level.  The monotone-by-design
        # stores (rings, compile cache, tensor blocks) are exempt —
        # their caps bound them; a drainable ledger that ratcheted is a
        # leak.  Bands are generous (live reflector threads, the last
        # two un-retired gangs) but a real leak blows through them.
        mem_post = memledger.totals()
        mem_report = memledger.audit_mem_ledgers(raise_on_drift=False)
        mem_drift = mem_report.get("_drift")
        if mem_drift:
            problems.append("memory ledger drift after drain: "
                            + "; ".join(mem_drift["failures"]))
        for name in ("mirror", "pending", "baseline", "stage",
                     "snapshot_pool"):
            ceiling = mem_pre.get(name, 0) * 1.75 + 64 * 1024
            if mem_post.get(name, 0) > ceiling:
                problems.append(
                    f"memory leak: ledger {name} at {mem_post[name]} bytes "
                    f"after drain vs {mem_pre.get(name, 0)} pre-storm "
                    f"(ceiling {int(ceiling)})")

        # Warm-failover contract: the adoption window paid no fresh
        # compile-cache miss and the hit counter moved (the adopted
        # shard's first sessions ran signatures already solved in this
        # process, with K1's library already loaded).
        hits_after, miss_after = compile_cache_counts()
        if killed is not None and miss_before_kill is not None:
            if miss_after != miss_before_kill:
                problems.append(
                    f"failover paid {miss_after - miss_before_kill} fresh "
                    "compile-cache misses (the key ledger did not cover "
                    "the adopted shards)")
            if hits_after <= hits_before_kill:
                problems.append(
                    "no compile-cache hits recorded after the kill — the "
                    "adoption window scheduled nothing (vacuous failover)")

        # Per-queue bound counts at truth == expected demand.
        with truth.lock:
            bound_by_queue: dict = {}
            pgq = {k.split("/", 1)[1]: pg.spec.queue
                   for k, pg in truth.pod_groups.items()}
            for key, pod in truth.pods.items():
                if not pod.spec.node_name:
                    continue
                group = (pod.metadata.annotations or {}).get(
                    v1alpha1.GroupNameAnnotationKey, "")
                q = pgq.get(group)
                if q:
                    bound_by_queue[q] = bound_by_queue.get(q, 0) + 1
        for q, want in expected.items():
            if bound_by_queue.get(q, 0) != want:
                problems.append(
                    f"queue {q}: {bound_by_queue.get(q, 0)} bound vs "
                    f"{want} expected (per-tenant demand not met)")

        # Shard-scoped ingest hygiene (doc/INGEST.md): after the mid-
        # soak steal settles, a scoped edge replica's mirror must hold
        # ZERO stale-shard entries — no podgroup and no unassigned pod
        # of a queue whose shard it does not own (shed purges + scoped
        # relists both worked).  Deadline loop: the post-steal relist
        # is asynchronous.
        edge_stale = None
        for rep in fleet:
            if rep._remote is None or rep is killed \
                    or getattr(rep, "scope", None) is None:
                continue
            deadline = time.time() + 15
            stale = rep.stale_mirror_entries()
            while stale and time.time() < deadline:
                time.sleep(0.05)
                stale = rep.stale_mirror_entries()
            edge_stale = len(stale)
            if stale:
                problems.append(
                    f"replica {rep.name}: {len(stale)} stale-shard "
                    f"mirror entries after the steal settled: "
                    f"{sorted(stale)[:6]}")

        problems.extend(monitor.violations)
        stamped = shard_bind_counts()
        if not stamped:
            problems.append("no bind egress was stamped with an owning "
                            "replica (kube_batch_shard_binds_total empty)")
        return {
            "replicas": replicas,
            "shards": shards,
            "edge": edge,
            "lease_duration_s": lease_duration,
            "churn_rounds": churn_rounds,
            "seed": seed,
            "binds": len(monitor.binds),
            "rejected_rebinds": len(monitor.rejected_rebinds),
            "orphaned_shards": sorted(orphaned or ()),
            "edge_stale_entries": edge_stale,
            "reclaim_s": (round(reclaim_s, 3)
                          if reclaim_s is not None else None),
            "bound_by_queue": bound_by_queue,
            "expected_by_queue": expected,
            "shard_sessions": shard_session_counts(),
            "shard_binds": stamped,
            "rebalances": shard_rebalance_counts(),
            "compile_cache": {"hits_before_kill": hits_before_kill,
                              "misses_before_kill": miss_before_kill,
                              "hits_after": hits_after,
                              "misses_after": miss_after},
            "launches": kernel_launches() - launches0,
            "mem_pre": mem_pre,
            "mem_post": mem_post,
            "mem_watermarks": memledger.watermarks(),
            "problems": problems,
            "ok": not problems,
        }
    finally:
        chaos_plan.disable()
        for rep in fleet:
            if not rep._stop.is_set():
                rep.stop()


def run_skewed_load_check(*, shards: int = 4, lease_duration: float = 3.0,
                          whale_pods: int = 30, rounds: int = 30,
                          device=None,
                          dtype: torch.dtype = torch.float32) -> dict:
    """Load-weighted claim-target pin (ROADMAP 2c, doc/TENANCY.md): two
    replicas over one truth store, four queue-shards, queue q0 a WHALE
    (a standing pod population dwarfing the other tenants).  Replicas
    are driven deterministically (manual lease ticks + scheduler cycles,
    no threads).  With the shard-load EWMA feeding claim targets, the
    federation must converge so the whale's owner holds FEWER shards
    than its peer (the count rule would freeze the cold-start 2/2
    split), via at least one clean load-shed release."""
    truth = Cluster()
    queues = [f"q{i}" for i in range(shards)]
    shard_map = ShardMap(shards, {q: i for i, q in enumerate(queues)})
    for q in queues:
        truth.create_queue(v1alpha1.Queue(
            metadata=ObjectMeta(name=q),
            spec=v1alpha1.QueueSpec(weight=1)))
    alloc = {"cpu": "2", "memory": "4Gi", "pods": 110}
    for i in range(4):
        truth.create_node(Node(
            metadata=ObjectMeta(name=f"sk-node-{i}", uid=f"sk-node-{i}"),
            spec=NodeSpec(),
            status=NodeStatus(allocatable=dict(alloc),
                              capacity=dict(alloc))))
    # The whale: a standing population of unplaceable pods (requests
    # exceed any node) — pure snapshot/churn load, no binds needed.
    truth.create_pod_group(v1alpha1.PodGroup(
        metadata=ObjectMeta(name="whale", namespace="soak"),
        spec=v1alpha1.PodGroupSpec(min_member=whale_pods, queue="q0")))
    for i in range(whale_pods):
        truth.create_pod(_mk_pod(f"whale-{i}", "whale", cpu="64",
                                 queue="q0"))
    for qi in range(1, shards):
        _submit_job(truth, f"small-{qi}", 2, queues[qi])

    # The rebalance counter is process-global and the main soak runs
    # first (its replicas can legitimately shed): the pin asserts on
    # THIS check's delta, not the cumulative count.
    shed0 = shard_rebalance_counts().get("shed", 0)
    reps = []
    for name in ("skew-a", "skew-b"):
        cache = new_scheduler_cache(truth)
        scheduler = Scheduler(cache, schedule_period=3600, device=device,
                              dtype=dtype)
        leases = ShardLeaseManager(
            truth, "soak-skew", shards, identity=name,
            lease_duration=lease_duration,
            renew_deadline=lease_duration * 0.6,
            retry_period=lease_duration / 10.0,
            target_shards=shards // 2)
        engine = TenancyEngine(scheduler, shard_map, lease_mgr=leases)
        scheduler.tenancy = engine
        cache.run()
        cache.wait_for_cache_sync()
        reps.append((name, scheduler, leases, engine))
    problems = []
    try:
        for _ in range(rounds):
            for _name, scheduler, leases, _engine in reps:
                leases.tick()
                scheduler.cycle()
            time.sleep(lease_duration / 10.0)
        owned = {name: sorted(leases.owned_shards())
                 for name, _s, leases, _e in reps}
        whale_owner = next((name for name, shard_list in owned.items()
                            if 0 in shard_list), None)
        sheds = shard_rebalance_counts().get("shed", 0) - shed0
        if whale_owner is None:
            problems.append("whale shard never owned by any replica")
        else:
            peer = next(n for n in owned if n != whale_owner)
            if not len(owned[whale_owner]) < len(owned[peer]):
                problems.append(
                    "skewed load did not rebalance: whale owner "
                    f"{whale_owner} holds {owned[whale_owner]} vs peer "
                    f"{owned[peer]} (count-split frozen)")
        if sheds < 1:
            problems.append("no load-shed release happened (the "
                            "load-weighted claim target never engaged)")
        if set(sum(owned.values(), [])) != set(range(shards)):
            problems.append(f"shards left unowned: {owned}")
        return {"owned": owned, "sheds": sheds,
                "whale_owner": whale_owner, "problems": problems,
                "ok": not problems}
    finally:
        for _name, _scheduler, leases, _engine in reps:
            leases.stop(release=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--replicas", type=int, default=3)
    parser.add_argument("--shards", type=int, default=3)
    parser.add_argument("--nodes", type=int, default=12)
    parser.add_argument("--churn-rounds", type=int, default=20)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--lease-duration", type=float, default=1.5)
    parser.add_argument("--lease-chaos-rate", type=float, default=0.15,
                        help="seeded lease.cas_conflict/clock_skew rate "
                             "during the churn phase (0 disables)")
    parser.add_argument("--edge", action="store_true",
                        help="run the last replica over ApiServer + "
                             "RemoteCluster (leases ride the wire too)")
    parser.add_argument("--json", type=str, default="",
                        help="also write the artifact to this path")
    parser.add_argument("--no-skewed-check", action="store_true",
                        help="skip the skewed-load claim-target pin "
                             "(run_skewed_load_check)")
    add_device_flag(parser)
    args = parser.parse_args(argv)

    device = cli_device(args, "replica_soak")
    if device is None:
        return 1
    artifact = run_soak(replicas=args.replicas, shards=args.shards,
                        nodes=args.nodes, churn_rounds=args.churn_rounds,
                        seed=args.seed, lease_duration=args.lease_duration,
                        edge=args.edge,
                        lease_chaos_rate=args.lease_chaos_rate,
                        device=device)
    if not args.no_skewed_check:
        # Load-weighted claim targets: the skewed-tenant rebalance pin
        # rides every soak run.
        artifact["skewed_load"] = run_skewed_load_check(device=device)
        if not artifact["skewed_load"]["ok"]:
            artifact["problems"] = (artifact.get("problems") or []) + \
                artifact["skewed_load"]["problems"]
            artifact["ok"] = False
    line = json.dumps(artifact, sort_keys=True)
    print(line)
    if args.json:
        pathlib.Path(args.json).write_text(line + "\n")
    if not artifact["ok"]:
        print("REPLICA SOAK FAILED:", file=sys.stderr)
        for problem in artifact["problems"]:
            print(f"  - {problem}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
