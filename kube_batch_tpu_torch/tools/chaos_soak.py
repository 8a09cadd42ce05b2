"""Chaos soak: seeded fault storms vs the fault-free convergence oracle
(the repo's tools/chaos_soak.py, driving the port).

Build a deterministic workload, run it once fault-free (the oracle),
then re-run it under seeded fault plans (``KUBE_BATCH_TPU_CHAOS``
semantics, installed in-process) with faults firing mid-flight at every
injection site, and assert the hard invariants:

  * the scheduler loop survives 100% of cycles (``Scheduler.cycle``
    never raises — failed cycles are fine, dead loops are not);
  * no pod is ever double-bound (a bind the truth store accepts for an
    already-bound pod is a violation);
  * no eviction is lost (every pod the oracle run evicts is evicted);
  * once the fault schedule drains, the bind map — pod -> node, exactly —
    and the surviving pod set converge to the oracle's, bit-identical.

The Scheduler's actions run on ``device``: the card unless
``--device cpu`` is given.  On the card a device failure is fed to the
breaker and the session raises ``DeviceFailure`` instead of running the
host path (``chaos/breaker.py``); an open breaker refuses the card until
its cooldown ends and the half-open probe closes it.  So each arm gives
the device breaker a short cooldown (``BREAKER_COOLDOWN_S``, the old one
restored after the arm), and the drain waits an open breaker out before
each cycle, so that the probe — never a ``reset()`` — closes it, as in
production.  Each arm reports the breaker's trips, probes and the
seconds waited.  On the CPU the failed stage runs the host path, as in
the reference.

Runs against the in-process Cluster simulator by default (bind/evict/
solve/session sites) and, with ``--edge``, over the port's ApiServer +
RemoteCluster wire so the watch sites (disconnect / truncate / stale)
fire too; over the wire the contract is schedule equivalence, not
bit-identity (``_compare_to_oracle``).  ``--ab`` appends the
steady-state overhead A/B: median cycle wall time with chaos unset vs a
zero-rate plan installed.

Always prints exactly one JSON artifact line; exits non-zero on any
invariant violation.

    python -m kube_batch_tpu_torch.tools.chaos_soak --seeds 2 --cycles 10
    python -m kube_batch_tpu_torch.tools.chaos_soak --edge --seeds 1
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import sys
import time

import torch

# Small shapes must still engage the device scanner + batched eviction
# engine (the fault surfaces under test); set before the port's imports.
os.environ.setdefault("KUBE_BATCH_TPU_SCAN_MIN_NODES", "0")

from kube_batch_tpu_torch.cache import Cluster, new_scheduler_cache  # noqa: E402
from kube_batch_tpu_torch.api.objects import (  # noqa: E402
    Container, Node, NodeSpec, NodeStatus, ObjectMeta, Pod, PodSpec,
    PodStatus, PriorityClass)
from kube_batch_tpu_torch.apis.scheduling import v1alpha1  # noqa: E402
from kube_batch_tpu_torch.chaos import plan as chaos_plan  # noqa: E402
from kube_batch_tpu_torch.chaos.breaker import device_breaker  # noqa: E402
from kube_batch_tpu_torch.metrics import memledger  # noqa: E402
from kube_batch_tpu_torch.scheduler import Scheduler  # noqa: E402
from kube_batch_tpu_torch.tools import (  # noqa: E402
    add_device_flag, breaker_transitions, cli_device, kernel_launches)

SOAK_CONF = """
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
"""

# Sites that must fire at least once across the seed sweep for the soak
# to count as exercising "every injection site" (watch.* only exists on
# the --edge wire); the reference's lists.  ``incremental.
# stale_generation`` is deliberately NOT required: it only activates on
# cycles the incremental micro path would have served (a storm mostly
# falls back to full rebuilds on its own), so the soak exercises it
# opportunistically.  ``fused.postevict_poison`` is likewise not
# required: it only activates when a reclaim storm's postevict leg is
# consumed, and this soak's conf ladder has no reclaim action.
FAKE_SITES = ("session.snapshot", "session.tensorize", "solve.device_error",
              "solve.slow", "solve.poison", "evict_solve.device_error",
              "fused.device_error", "fused.slow", "fused.poison",
              "bind.timeout", "bind.http5xx", "bind.ambiguous",
              "evict.error", "evict.ambiguous", "commit.flush_error",
              "topology.bad_coords")
EDGE_SITES = FAKE_SITES + ("watch.disconnect", "watch.truncate",
                           "watch.stale")


def _mk_pod(name, group, ns="soak", cpu="1", mem="1Gi", prio=None):
    requests = {"cpu": cpu, "memory": mem} if cpu else {}
    return Pod(
        metadata=ObjectMeta(
            name=name, namespace=ns,
            annotations={v1alpha1.GroupNameAnnotationKey: group}),
        spec=PodSpec(node_name="", priority=prio,
                     containers=[Container(requests=requests)]),
        status=PodStatus(phase="Pending"))


def _submit_job(cluster, name, replicas, min_member, queue, cpu="1",
                prio_class="", ns="soak"):
    cluster.create_pod_group(v1alpha1.PodGroup(
        metadata=ObjectMeta(name=name, namespace=ns),
        spec=v1alpha1.PodGroupSpec(min_member=min_member, queue=queue,
                                   priority_class_name=prio_class)))
    prio = {"high-priority": 1000, "low-priority": 1}.get(prio_class)
    for i in range(replicas):
        cluster.create_pod(_mk_pod(f"{name}-{i}", name, ns=ns, cpu=cpu,
                                   prio=prio))


def _mk_node(name: str, cpu: str, mem: str, ix: int = 0) -> Node:
    # Coordinate labels (models/topology.py) make the topo action's
    # view build run every cycle so `topology.bad_coords` is always
    # reachable — but with NO slice jobs and NO frag-scoring plugin in
    # SOAK_CONF the torus view is placement-neutral: a fired fault
    # degrades fragmentation accounting only, so the convergence
    # contract (bit-identical bind map vs the oracle) still holds.
    from kube_batch_tpu_torch.models.topology import (AXIS_LABELS,
                                                      POD_LABEL, RACK_LABEL)
    alloc = {"cpu": cpu, "memory": mem, "pods": 110}
    labels = {POD_LABEL: "soak-pod", RACK_LABEL: "0",
              AXIS_LABELS[0]: str(ix % 4), AXIS_LABELS[1]: str(ix // 4),
              AXIS_LABELS[2]: "0"}
    return Node(metadata=ObjectMeta(name=name, uid=name, labels=labels),
                spec=NodeSpec(),
                status=NodeStatus(allocatable=alloc, capacity=dict(alloc)))


def build_cluster(nodes: int) -> Cluster:
    """The deterministic base workload: homogeneous nodes filled by
    low-priority gangs (so the preempt wave must evict), plus BestEffort
    pods for backfill.  Identical across every arm — only the fault plan
    differs."""
    cluster = Cluster()
    for qname in ("default", "q1", "q2"):
        cluster.create_queue(v1alpha1.Queue(
            metadata=ObjectMeta(name=qname),
            spec=v1alpha1.QueueSpec(weight=1)))
    cluster.create_priority_class(PriorityClass(
        metadata=ObjectMeta(name="high-priority"), value=1000))
    cluster.create_priority_class(PriorityClass(
        metadata=ObjectMeta(name="low-priority"), value=1))
    for i in range(nodes):
        cluster.create_node(_mk_node(f"node-{i:03d}", "2", "4Gi", ix=i))
    # Base load: nodes*2 cpu total, filled exactly by 1-cpu job members.
    # min_member=1 keeps members above the gang floor preemptable (a
    # min==replicas gang is veto-protected by the gang plugin and the
    # storm would find no victims).
    gangs = max(1, nodes // 2)
    for g in range(gangs):
        _submit_job(cluster, f"base-{g}", 4, 1,
                    queue=("q1" if g % 2 == 0 else "q2"),
                    prio_class="low-priority")
    _submit_job(cluster, "be", 2, 1, queue="q1", cpu="")  # BestEffort
    return cluster


def submit_wave(cluster) -> None:
    """The mid-flight preemption storm: a high-priority gang that only
    fits by evicting low-priority victims."""
    _submit_job(cluster, "storm", 4, 4, queue="q1",
                prio_class="high-priority")


class TruthMonitor:
    """Watches the truth store's bind/delete verbs for the hard
    invariants.  A bind the store ACCEPTS for an already-bound pod is a
    double-bind violation; a REJECTED duplicate POST (the store's 409
    path) is recorded but legal — that is the resync machinery being
    exercised, not a broken schedule."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self.violations: list = []
        self.binds: list = []
        self.rejected_rebinds: list = []
        self.deletes: list = []
        orig_bind = cluster.bind_pod
        orig_delete = cluster.delete_pod

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
            self.binds.append((key, hostname))
            return result

        def checked_delete(ns, name):
            self.deletes.append(f"{ns}/{name}")
            return orig_delete(ns, name)

        cluster.bind_pod = checked_bind
        cluster.delete_pod = checked_delete


def _bind_map(cluster: Cluster) -> dict:
    with cluster.lock:
        return {key: pod.spec.node_name
                for key, pod in cluster.pods.items()
                if pod.spec.node_name}


def _pod_set(cluster: Cluster) -> set:
    with cluster.lock:
        return set(cluster.pods)


# The device breaker's cooldown inside a soak arm: short, so that the
# drain's wait for the half-open probe costs under a second where the
# configured 30 s would cost each tripped arm half a minute.
BREAKER_COOLDOWN_S = 0.5


@contextlib.contextmanager
def arm_breaker(cooldown_s: float):
    """The device breaker for one arm: closed at its start (as the
    reference resets it), with ``cooldown_s`` as its cooldown, the old
    cooldown restored and the breaker closed after the arm."""
    br = device_breaker()
    saved = br.cooldown
    br.reset()
    br.cooldown = cooldown_s
    try:
        yield br
    finally:
        br.cooldown = saved
        br.reset()


def wait_breaker(br) -> float:
    """Wait out an open breaker's cooldown, so that the next cycle is its
    half-open probe; returns the seconds waited (0.0 unless open)."""
    left = br.cooldown_left()
    if left > 0.0:
        time.sleep(left)
    return left


def run_arm(plans, *, nodes: int, cycles: int, drain_cap: int = 30,
            edge: bool = False, edge_settle_s: float = 0.05, device=None,
            dtype: torch.dtype = torch.float32) -> dict:
    """One soak arm, two fault phases around the irreversible transition
    (doc/CHAOS.md "Convergence-oracle contract"):

      phase A — the base load schedules with ``plans[0]`` active (watch /
      bind / solve / session sites), then the schedule drains and the arm
      converges: binds are retryable, so the converged phase-A map must
      equal the oracle's bit for bit.

      phase B — the preempt storm lands with ``plans[1]`` active (now the
      evict and batched-eviction-solve sites activate too), drains, and
      converges again.  Because both arms enter the storm from the SAME
      converged state, the victim set and final map must again match —
      eviction is irreversible, which is exactly why the barrier sits
      before it (a fault overlapping un-converged binds can legitimately
      change who needs evicting; that is a different schedule, not a
      robustness bug).

    ``plans`` is (None, None) for the oracle arm.  The Scheduler's
    actions run on ``device`` (the card unless the CPU is asked for) with
    ``dtype`` keys; the device breaker has ``BREAKER_COOLDOWN_S`` as its
    cooldown for the arm (``arm_breaker``), and the drain waits it out
    (``wait_breaker``) before each cycle."""
    began = time.perf_counter()
    cluster = build_cluster(nodes)
    monitor = TruthMonitor(cluster)
    server = remote = None
    stack = contextlib.ExitStack()
    try:
        if edge:
            from kube_batch_tpu_torch.edge import ApiServer, RemoteCluster
            server = ApiServer(cluster).start()
            remote = RemoteCluster(server.url).start()
            cache = new_scheduler_cache(remote)
        else:
            cache = new_scheduler_cache(cluster)
        scheduler = Scheduler(cache, scheduler_conf=SOAK_CONF,
                              schedule_period=3600, device=device,
                              dtype=dtype)
        br = stack.enter_context(arm_breaker(BREAKER_COOLDOWN_S))
        trips0 = breaker_transitions("open")
        probes0 = breaker_transitions("half-open")
        launches0 = kernel_launches()

        loop_deaths = []
        failed_cycles = 0
        drain_failed = 0
        waited = [0.0]
        mirror_waited = [0.0]
        drained_from = []

        def one_cycle() -> bool:
            nonlocal failed_cycles
            ok = False
            try:
                ok = scheduler.cycle()
                if not ok:
                    failed_cycles += 1
            except Exception as exc:  # the loop-survival contract broke
                # lint: allow-swallow(recorded in loop_deaths and reported as a soak failure — the soak measures survival, it must not die with the loop)
                loop_deaths.append(f"{type(exc).__name__}: {exc}")
            if edge:
                time.sleep(edge_settle_s)  # let the watch echo land
            return ok

        def mirror_synced() -> bool:
            """Edge mode: has the remote mirror caught up with truth?  A
            reflector sitting out a reconnect backoff makes the truth
            store look idle while pods are still invisible to the
            scheduler — idleness on a stale mirror is not convergence.
            The lazy mirror holds MODIFIED frames until a flush (the
            session open's chokepoint), so flush them first: the frames
            have arrived, and an unflushed mirror would read stale until
            the next cycle, which the wait below never reaches."""
            if remote is None:
                return True
            remote.flush_pending()
            with cluster.lock:
                truth = {k: (p.spec.node_name, p.status.phase)
                         for k, p in cluster.pods.items()}
                truth_pg = set(cluster.pod_groups)
            with remote.lock:
                mirror = {k: (p.spec.node_name, p.status.phase)
                          for k, p in remote.pods.items()}
                mirror_pg = set(remote.pod_groups)
            return truth == mirror and truth_pg == mirror_pg

        def wait_mirror() -> None:
            began = time.perf_counter()
            deadline = time.time() + 15.0
            while not mirror_synced() and time.time() < deadline:
                time.sleep(0.05)
            mirror_waited[0] += time.perf_counter() - began

        def drain_and_converge() -> int:
            nonlocal drain_failed
            chaos_plan.disable()
            drained_from.append((_bind_map(cluster),
                                 sorted(_pod_set(cluster))))
            stable, last = 0, (None, None)
            for i in range(drain_cap):
                if remote is not None:
                    wait_mirror()
                # An open breaker refuses the card until its probe: wait
                # the cooldown out so this cycle is the probe.  A failed
                # cycle never counts toward quiescence.
                waited[0] += wait_breaker(br)
                ok = one_cycle()
                drain_failed += not ok
                state = (_bind_map(cluster), _pod_set(cluster))
                stable = (stable + 1
                          if ok and state == last and mirror_synced()
                          else 0)
                last = state
                if stable >= 2:
                    return i + 1
            return -1  # never quiesced

        def storm_phase(plan, submit) -> int:
            if submit is not None:
                submit(cluster)
                # Edge: wait until the mirror SEES the storm before the
                # fault plan arms, or a watch blackout can postpone the
                # whole preempt wave past the fault budget and the evict
                # sites never activate.
                wait_mirror()
            if plan is not None:
                chaos_plan.install(plan)
            for _ in range(cycles):
                one_cycle()
            return drain_and_converge()

        drain_a = storm_phase(plans[0], None)
        mem_a = memledger.totals()   # post-drain reference sample
        phase_a_map = _bind_map(cluster)
        drain_b = storm_phase(plans[1], submit_wave)
        # Post-drain memory hygiene (doc/OBSERVABILITY.md "Memory
        # ledger"): quiescent, so every hook must reconcile with its
        # store even after a fault storm drove the degrade/retry paths.
        mem_b = memledger.totals()
        mem_drift = memledger.audit_mem_ledgers(
            raise_on_drift=False).get("_drift")

        injected: dict = {}
        for plan in plans:
            if plan is not None:
                for site, count in plan.injected().items():
                    injected[site] = injected.get(site, 0) + count
        return {
            "phase_a_map": phase_a_map,
            "bind_map": _bind_map(cluster),
            "pods": sorted(_pod_set(cluster)),
            "deletes": sorted(set(monitor.deletes)),
            "violations": monitor.violations,
            "rejected_rebinds": len(monitor.rejected_rebinds),
            "loop_deaths": loop_deaths,
            "failed_cycles": failed_cycles,
            "drain_cycles": (drain_a, drain_b),
            "converged_quiescent": drain_a > 0 and drain_b > 0,
            "injected": injected,
            "mem_post_drain": (mem_a, mem_b),
            "mem_drift": (mem_drift["failures"] if mem_drift else []),
            "drain_failed_cycles": drain_failed,
            "drained_from": drained_from,
            "breaker": {"cooldown_s": br.cooldown,
                        "trips": breaker_transitions("open") - trips0,
                        "probes": (breaker_transitions("half-open")
                                   - probes0),
                        "waited_s": waited[0],
                        "state": br.state()},
            "launches": kernel_launches() - launches0,
            "mirror_wait_s": mirror_waited[0],
            "wall_s": time.perf_counter() - began,
        }
    finally:
        chaos_plan.disable()
        stack.close()
        if remote is not None:
            remote.stop()
        if server is not None:
            server.stop()


def fault_free_from(arm: dict, *, nodes: int, drain_cap: int = 30,
                    device=None, dtype: torch.dtype = torch.float32) -> dict:
    """The fault-free scheduler's own drain from the truth each of a
    chaos arm's fault phases left (``arm["drained_from"]``, read when its
    drain began): a fresh truth store gets that phase's binds (and, for
    phase B, the storm and its evictions), a scheduler started on it
    cycles in process until quiescent, and its map is returned for each
    phase.  A chaos arm that diverged from the oracle but equals these
    recovered as the scheduler itself does from where the faults left
    it: the faults changed the path to that state, the drain did not
    fail to converge."""
    def drain(cluster) -> dict:
        scheduler = Scheduler(new_scheduler_cache(cluster),
                              scheduler_conf=SOAK_CONF, schedule_period=3600,
                              device=device, dtype=dtype)
        stable, last = 0, None
        for _ in range(drain_cap):
            ok = scheduler.cycle()
            state = (_bind_map(cluster), _pod_set(cluster))
            stable = stable + 1 if ok and state == last else 0
            last = state
            if stable >= 2:
                return {"bind_map": state[0], "pods": sorted(state[1])}
        raise RuntimeError("the fault-free drain never quiesced")

    out = []
    with arm_breaker(BREAKER_COOLDOWN_S):
        for phase, (bound, pods) in enumerate(arm["drained_from"]):
            cluster = build_cluster(nodes)
            if phase:
                submit_wave(cluster)
            for key in sorted(_pod_set(cluster) - set(pods)):
                cluster.delete_pod(*key.split("/", 1))
            for key, node in sorted(bound.items()):
                cluster.bind_pod(*key.split("/", 1), node)
            out.append(drain(cluster))
    return {"phase_a_map": out[0]["bind_map"], "bind_map": out[1]["bind_map"],
            "pods": out[1]["pods"]}


def _job_of(pod_key: str) -> str:
    """'soak/base-3-0' -> 'base-3' (the builders name pods <job>-<i>)."""
    return pod_key.split("/", 1)[1].rsplit("-", 1)[0]


def _per_job(keys) -> dict:
    out: dict = {}
    for key in keys:
        job = _job_of(key)
        out[job] = out.get(job, 0) + 1
    return out


def _compare_to_oracle(arm: dict, oracle: dict, *, edge: bool) -> list:
    """The convergence contract (doc/CHAOS.md).

    Fake mode IS the sequential oracle — the informer echo is
    synchronous, so once the fault schedule drains both phases must
    converge BIT-IDENTICALLY: same pod -> node map, same surviving pods,
    same victim set.

    The --edge wire adds asynchronous visibility (watch echo lag), under
    which placement bit-identity is not a theorem for any client-go-style
    scheduler: a bind delayed past a mirror refresh legitimately reorders
    the DRF share evolution.  There the contract is SCHEDULE EQUIVALENCE:
    every job binds and loses exactly as many pods as the oracle's run,
    gang floors hold, and no node is overcommitted at the truth store —
    plus the hard invariants (loop alive, no accepted double-bind)."""
    errs = []
    if not edge:
        if arm["phase_a_map"] != oracle["phase_a_map"]:
            errs.append("phase-A bind map diverged from oracle after "
                        "the fault schedule drained")
        if arm["bind_map"] != oracle["bind_map"]:
            only_o = set(oracle["bind_map"].items()) - \
                set(arm["bind_map"].items())
            only_c = set(arm["bind_map"].items()) - \
                set(oracle["bind_map"].items())
            errs.append(f"bind map diverged from oracle "
                        f"(oracle-only={sorted(only_o)[:6]}, "
                        f"chaos-only={sorted(only_c)[:6]})")
        if set(arm["pods"]) != set(oracle["pods"]):
            errs.append("surviving pod set diverged from oracle")
        if set(arm["deletes"]) != set(oracle["deletes"]):
            errs.append(
                f"eviction set diverged (oracle={oracle['deletes']}, "
                f"chaos={arm['deletes']})")
        return errs
    # --edge: schedule equivalence.
    for field, label in (("bind_map", "bound"), ("pods", "surviving"),
                         ("deletes", "evicted")):
        got = _per_job(arm[field])
        want = _per_job(oracle[field])
        if got != want:
            errs.append(f"per-job {label} counts diverged from oracle "
                        f"(oracle={want}, chaos={got})")
    return errs + _overcommitted(arm["bind_map"])


def _overcommitted(bind_map: dict) -> list:
    """No node overcommitted at truth: base/storm pods are 1 cpu on 2-cpu
    nodes; BestEffort pods are free."""
    loads: dict = {}
    for key, node in bind_map.items():
        if _job_of(key) != "be":
            loads[node] = loads.get(node, 0) + 1
    over = {n: c for n, c in loads.items() if c > 2}
    return [f"nodes overcommitted at the truth store: {over}"] if over else []


def run_soak(seeds, *, nodes: int = 8, cycles: int = 10,
             rate: float = 0.35, budget: int = 60,
             edge: bool = False, require_all_sites: bool = True,
             until_all_sites: bool = False, device=None,
             dtype: torch.dtype = torch.float32) -> dict:
    """The full soak: one oracle arm + one chaos arm per seed, on
    ``device`` (the card unless the CPU is asked for); returns the
    artifact (``ok`` False on any violated invariant).  With
    ``until_all_sites`` the sweep ends at the first seed by which every
    required site has fired."""
    arm_kw = dict(nodes=nodes, cycles=cycles, edge=edge, device=device,
                  dtype=dtype)
    oracle = run_arm((None, None), **arm_kw)
    problems = list(oracle["violations"]) + list(oracle["loop_deaths"])
    if not oracle["converged_quiescent"]:
        problems.append("oracle arm never quiesced")
    if not oracle["bind_map"]:
        problems.append("oracle arm bound nothing — workload broken")
    if not oracle["deletes"]:
        problems.append("oracle arm evicted nothing — no preempt storm")
    if oracle["breaker"]["trips"] or oracle["failed_cycles"]:
        problems.append(f"the fault-free oracle arm failed "
                        f"{oracle['failed_cycles']} cycles and tripped the "
                        f"breaker {oracle['breaker']['trips']} times")
    # session.snapshot kills a cycle before any downstream site can
    # activate and session.tensorize degrades the whole device pipeline;
    # at a uniform rate they starve the solve/evict sites of activations.
    # Damp them and boost the rare once-per-cycle device sites so every
    # site demonstrably fires within the sweep.
    site_rates = (("session.*", min(rate, 0.5) * 0.4),
                  ("solve.slow", min(1.0, rate * 1.6)),
                  ("solve.poison", min(1.0, rate * 1.4)),
                  ("evict_solve.*", min(1.0, rate * 1.6)),
                  # The fused session dispatch (doc/FUSED.md) fires at
                  # most once per cycle, and its readback seams
                  # (fused.slow / fused.poison) only on cycles where
                  # the dispatch survived fused.device_error — boost
                  # all three so the one-dispatch degrade ladder
                  # (breaker feed -> resident invalidate -> per-family
                  # re-dispatch) demonstrably exercises every sweep.
                  # The readback seams only draw on cycles where the
                  # dispatch survived fused.device_error, so they get
                  # the strongest boost of the table.
                  ("fused.device_error", min(1.0, rate * 1.2)),
                  ("fused.slow", min(1.0, rate * 3.0)),
                  ("fused.poison", min(1.0, rate * 2.4)),
                  # Draws only when a reclaim storm's postevict leg is
                  # consumed (see FAKE_SITES note: this soak's conf has
                  # no reclaim, so activation is opportunistic — a
                  # reclaim-enabled soak inherits the boost).
                  ("fused.postevict_poison", min(1.0, rate * 2.4)),
                  # Fires only on micro-eligible cycles (see FAKE_SITES
                  # note): boost it so those cycles do get hit.
                  ("incremental.stale_generation", min(1.0, rate * 1.6)),
                  # One activation per per-action commit FLUSH (not per
                  # effect): the batched commit's bulk-egress abort
                  # (doc/EVICTION.md "Batched commit") — boosted so the
                  # mid-batch degradation path demonstrably exercises
                  # every sweep (the degraded per-task retries then feed
                  # the evict.* sites above).
                  ("commit.flush_error", min(1.0, rate * 1.6)),
                  # One activation per (cycle, labeled node) in the topo
                  # view build; boosted so label corruption demonstrably
                  # degrades nodes (not cycles) every sweep
                  # (doc/CHAOS.md, doc/TOPOLOGY.md).
                  ("topology.bad_coords", min(1.0, rate * 1.6)),
                  # Shard-lease sites (doc/TENANCY.md): inert here —
                  # this soak runs the single global engine — but kept
                  # in the rate table so a tenancy-enabled soak inherits
                  # damped lease churn; replica_soak.py is the harness
                  # that activates them.
                  ("lease.*", min(rate, 0.5) * 0.4))
    seed_results = []
    sites_union = set()
    required = EDGE_SITES if edge else FAKE_SITES
    for seed in seeds:
        if until_all_sites and set(required) <= sites_union:
            break
        plans = (chaos_plan.FaultPlan(seed=seed * 2, rate=rate,
                                      budget=budget, rates=site_rates),
                 chaos_plan.FaultPlan(seed=seed * 2 + 1, rate=rate,
                                      budget=budget, rates=site_rates))
        arm = run_arm(plans, **arm_kw)
        errs = list(arm["violations"]) + list(arm["loop_deaths"])
        if not arm["converged_quiescent"]:
            errs.append("chaos arm never quiesced after drain")
        # Post-drain leak gates: the audit reconciled, and the drainable
        # ledgers did not ratchet between the two drains (monotone-by-
        # design stores — rings, compile cache, tensor blocks — are
        # bounded by their caps and exempt).
        errs.extend(f"memory ledger drift after drain: {d}"
                    for d in arm["mem_drift"])
        mem_a, mem_b = arm["mem_post_drain"]
        for name in ("mirror", "pending", "baseline", "stage",
                     "snapshot_pool"):
            ceiling = mem_a.get(name, 0) * 1.75 + 64 * 1024
            if mem_b.get(name, 0) > ceiling:
                errs.append(
                    f"memory leak: ledger {name} at {mem_b[name]} bytes "
                    f"after the second drain vs {mem_a.get(name, 0)} after "
                    f"the first (ceiling {int(ceiling)})")
        diverged = _compare_to_oracle(arm, oracle, edge=edge)
        errs.extend(diverged)
        path = None
        if diverged:
            # Did the drain recover as the scheduler itself does from the
            # state the faults left?  (Reported; ``ok`` stays the
            # reference's contract.)
            replay = fault_free_from(arm, nodes=nodes, device=device,
                                     dtype=dtype)
            path = _compare_to_oracle(arm, {**replay,
                                            "deletes": arm["deletes"]},
                                      edge=edge)
            if not edge:
                path += _overcommitted(arm["bind_map"])
        for site in arm["injected"]:
            sites_union.add(site.split(":", 1)[0])
        seed_results.append({
            "seed": seed,
            "injected_total": sum(arm["injected"].values()),
            "injected": arm["injected"],
            "failed_cycles": arm["failed_cycles"],
            "drain_cycles": arm["drain_cycles"],
            "drain_failed_cycles": arm["drain_failed_cycles"],
            "loop_deaths": len(arm["loop_deaths"]),
            "double_binds": len(arm["violations"]),
            "lost_evictions": len(set(oracle["deletes"])
                                  - set(arm["deletes"])),
            "breaker": arm["breaker"],
            "launches": arm["launches"],
            "mirror_wait_s": arm["mirror_wait_s"],
            "wall_s": arm["wall_s"],
            "errors": errs,
            "diverged": diverged,
            "path_problems": path,
        })
        problems.extend(f"seed {seed}: {e}" for e in errs)
    missing = [s for s in required if s not in sites_union]
    if missing and require_all_sites:
        # A sweep-level property: every site must demonstrably fire
        # somewhere in the sweep (single-seed smokes may waive it).
        problems.append(
            f"injection sites never fired across the sweep: {missing} "
            "(raise --rate/--budget/--cycles)")
    return {
        "mode": "edge" if edge else "fake",
        "nodes": nodes,
        "cycles": cycles,
        "rate": rate,
        "budget": budget,
        "oracle": {"binds": len(oracle["bind_map"]),
                   "evictions": len(oracle["deletes"]),
                   "pods": len(oracle["pods"]),
                   "launches": oracle["launches"],
                   "wall_s": oracle["wall_s"]},
        "breaker_cooldown_s": BREAKER_COOLDOWN_S,
        "seeds": seed_results,
        "sites_fired": sorted(sites_union),
        "problems": problems,
        "ok": not problems,
    }


def run_overhead_ab(*, nodes: int = 16, rounds: int = 40, device=None,
                    dtype: torch.dtype = torch.float32) -> dict:
    """Injection-branch overhead, two measurements:

    * ``branch_ns`` — the cost of ONE disabled site check (module
      attribute load + is-None branch), measured directly: this is ALL
      the chaos engine adds per site when ``KUBE_BATCH_TPU_CHAOS`` is
      unset.  A steady cycle crosses ~10 sites (plus one per watch frame
      on the edge), so the unset cost is tens of nanoseconds per cycle —
      orders of magnitude inside the <1% flight-recorder budget.
    * ``off_ms``/``on_ms`` — median run_once wall time with chaos unset
      vs a ZERO-RATE plan installed (counterbalanced off/on/on/off): the
      active-plan upper bound (per-activation keyed hashing), relevant
      only while a chaos run is deliberately in progress."""
    import statistics
    import timeit

    chaos_plan.disable()
    n_checks = 2_000_000
    branch_ns = timeit.timeit(
        "p = cp.PLAN\nif p is not None:\n    raise RuntimeError",
        globals={"cp": chaos_plan}, number=n_checks) / n_checks * 1e9

    cluster = build_cluster(nodes)
    cache = new_scheduler_cache(cluster)
    scheduler = Scheduler(cache, scheduler_conf=SOAK_CONF,
                          schedule_period=3600, device=device, dtype=dtype)
    for _ in range(3):  # converge + warm compile caches
        scheduler.cycle()

    def measure(arm_on: bool):
        if arm_on:
            chaos_plan.install(chaos_plan.FaultPlan(seed=0, rate=0.0))
        else:
            chaos_plan.disable()
        samples = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            scheduler.run_once()
            samples.append((time.perf_counter() - t0) * 1e3)
        chaos_plan.disable()
        return samples

    offs, ons = [], []
    for arm_on in (False, True, True, False):
        (ons if arm_on else offs).extend(measure(arm_on))
    off_ms = statistics.median(offs)
    on_ms = statistics.median(ons)
    return {"branch_ns": round(branch_ns, 1),
            "off_ms": round(off_ms, 4), "on_ms": round(on_ms, 4),
            "active_plan_delta_pct": round(
                (on_ms - off_ms) / off_ms * 100, 2) if off_ms else 0.0,
            "rounds_per_arm": rounds * 2}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, default=2,
                        help="number of fault-plan seeds to sweep")
    parser.add_argument("--seed-base", type=int, default=1)
    parser.add_argument("--nodes", type=int, default=8)
    parser.add_argument("--cycles", type=int, default=10,
                        help="cycles per phase with the fault plan active")
    parser.add_argument("--rate", type=float, default=0.35)
    parser.add_argument("--budget", type=int, default=60,
                        help="total fault budget (the schedule then drains)")
    parser.add_argument("--edge", action="store_true",
                        help="run over ApiServer + RemoteCluster (adds the "
                             "watch.* sites)")
    parser.add_argument("--ab", action="store_true",
                        help="append the steady-state overhead A/B")
    parser.add_argument("--json", type=str, default="",
                        help="also write the artifact to this path")
    add_device_flag(parser)
    args = parser.parse_args(argv)

    device = cli_device(args, "chaos_soak")
    if device is None:
        return 1
    seeds = [args.seed_base + i for i in range(args.seeds)]
    artifact = run_soak(seeds, nodes=args.nodes, cycles=args.cycles,
                        rate=args.rate, budget=args.budget, edge=args.edge,
                        device=device)
    if args.ab:
        artifact["overhead_ab"] = run_overhead_ab(device=device)
    line = json.dumps(artifact, sort_keys=True)
    print(line)
    if args.json:
        pathlib.Path(args.json).write_text(line + "\n")
    if not artifact["ok"]:
        print("CHAOS SOAK FAILED:", file=sys.stderr)
        for problem in artifact["problems"]:
            print(f"  - {problem}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
