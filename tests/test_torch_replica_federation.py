"""Active-active replica federation, the JAX package against the port,
on the CPU.

Twins of every case of tests/test_replica_federation.py: the per-shard
lease state machine (claim, renew, steal on expiry, clean release), the
``lease.cas_conflict`` and ``lease.clock_skew`` chaos sites, and a
replica that loses its lease mid-cycle leaving exactly one bind at the
truth store.  Each case runs the reference test's body once per package
(tests/test_torch_utils.loop_twin); the port's Scheduler on the CPU.
The lease timings are wall-clock, so each package is held to the
reference's own bounds and the two return only what is deterministic.
"""

import time

import pytest

from tests.test_torch_utils import Loop, bind_map, loop_twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401


@pytest.fixture(autouse=True)
def _no_chaos_leak():
    yield
    for pkg in ("jax", "torch"):
        Loop(pkg).chaos_plan.disable()


def _mgr(lp, cluster, name, shards=2, duration=0.4, target=None):
    return lp.leases.ShardLeaseManager(
        cluster, "test", shards, identity=name,
        lease_duration=duration, renew_deadline=duration * 0.6,
        retry_period=0.02, target_shards=target)


def _tick_until(mgrs, pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        for m in mgrs:
            m.tick()
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_claim_renew_and_steal_on_expiry():
    def body(lp):
        cluster = lp.cache.Cluster()
        a = _mgr(lp, cluster, "rep-a")
        b = _mgr(lp, cluster, "rep-b")
        a.tick()
        owned = [a.owned_shards()]
        b.tick()
        owned.append(b.owned_shards())
        deadline = time.time() + 0.6
        while time.time() < deadline:
            a.tick()
            time.sleep(0.02)
        owned.append(a.owned_shards())
        assert a.lease_live(0)
        t0 = time.time()
        assert _tick_until([b], lambda: b.owned_shards() == [0, 1],
                           timeout=3 * 0.4)
        assert time.time() - t0 <= 2 * 0.4 + 0.2
        assert not a.lease_live(0)
        owned.append(b.owned_shards())
        assert owned == [[0, 1], [], [0, 1], [0, 1]]
        return owned

    loop_twin(body)


def test_clean_release_hands_over_without_expiry_wait():
    def body(lp):
        cluster = lp.cache.Cluster()
        a = _mgr(lp, cluster, "rep-a")
        b = _mgr(lp, cluster, "rep-b")
        a.tick()
        owned = [a.owned_shards()]
        a.stop(release=True)
        b.tick()
        owned.append(b.owned_shards())
        assert owned == [[0, 1], [0, 1]]
        return owned

    loop_twin(body)


def test_lease_cas_conflict_chaos_blocks_acquisition():
    def body(lp):
        plan = lp.chaos_plan
        cluster = lp.cache.Cluster()
        a = _mgr(lp, cluster, "rep-a")
        plan.install(plan.FaultPlan(seed=3, rate=1.0,
                                    sites=("lease.cas_conflict",)))
        for _ in range(4):
            a.tick()
        owned = [a.owned_shards()]
        plan.disable()
        a.tick()
        owned.append(a.owned_shards())
        assert owned == [[], [0, 1]]
        return owned

    loop_twin(body)


def test_lease_clock_skew_abandons_shard_and_fences_writes():
    def body(lp):
        plan = lp.chaos_plan
        cluster = lp.cache.Cluster()
        cache = lp.cache.new_scheduler_cache(cluster)
        shard_map = lp.tenancy.ShardMap(2)
        a = _mgr(lp, cluster, "rep-a")
        a.tick()
        assert a.owned_shards() == [0, 1]
        view = lp.tenancy.ShardView(cache, 0, shard_map, replica="rep-a",
                                    lease_live=a.lease_live)
        plan.install(plan.FaultPlan(seed=5, rate=1.0,
                                    sites=("lease.clock_skew",)))
        a.tick()
        plan.disable()
        assert 0 not in a.owned_shards()
        assert not a.lease_live(0)
        refused = []
        for write in (lambda: view.bind_batch([]),
                      lambda: view.bind(object(), "node-x")):
            with pytest.raises(RuntimeError, match="lease lost") as info:
                write()
            refused.append(str(info.value))
        assert bind_map(cluster) == {}
        return a.owned_shards(), refused

    loop_twin(body)


def _submit(lp, cluster, name, queue, replicas=1):
    o, v1 = lp.objects, lp.v1alpha1
    cluster.create_pod_group(lp.pod_group(name, "fed", replicas, queue))
    for i in range(replicas):
        cluster.create_pod(o.Pod(
            metadata=o.ObjectMeta(
                name=f"{name}-{i}", namespace="fed",
                annotations={v1.GroupNameAnnotationKey: name}),
            spec=o.PodSpec(node_name="", containers=[o.Container(
                requests={"cpu": "1", "memory": "1Gi"})]),
            status=o.PodStatus(phase="Pending")))


def test_lost_lease_mid_cycle_yields_exactly_one_bind_at_truth():
    def body(lp):
        plan = lp.chaos_plan
        cluster = lp.cache.Cluster()
        cluster.create_node(lp.node("n0", cpu="2", mem="4Gi", pods=10))
        lp.queue(cluster, "q0")
        _submit(lp, cluster, "job", "q0")
        shard_map = lp.tenancy.ShardMap(1, {"q0": 0})

        def replica(name):
            cache = lp.cache.new_scheduler_cache(cluster)
            scheduler = lp.scheduler(cache, schedule_period=3600)
            mgr = _mgr(lp, cluster, name, shards=1)
            engine = lp.tenancy.TenancyEngine(scheduler, shard_map,
                                              lease_mgr=mgr)
            scheduler.tenancy = engine
            return scheduler, mgr

        sched_a, mgr_a = replica("rep-a")
        sched_b, mgr_b = replica("rep-b")
        try:
            mgr_a.tick()
            assert mgr_a.owned_shards() == [0]
            plan.install(plan.FaultPlan(seed=9, rate=1.0,
                                        sites=("lease.clock_skew",)))
            mgr_a.tick()
            plan.disable()
            assert mgr_a.owned_shards() == []
            assert sched_a.cycle()
            assert bind_map(cluster) == {}
            mgr_b.start()
            deadline = time.time() + 3.0
            while mgr_b.owned_shards() != [0] and time.time() < deadline:
                time.sleep(0.02)
            assert mgr_b.owned_shards() == [0]
            before = lp.metrics.shard_bind_counts().get("0/rep-b", 0)
            assert sched_b.cycle()
            binds = bind_map(cluster)
            assert len(binds) == 1
            assert lp.metrics.shard_bind_counts().get("0/rep-b", 0) \
                == before + 1
        finally:
            mgr_b.stop(release=True)
            mgr_a.stop(release=False)
        return binds

    loop_twin(body)
