"""The queue-shard tenancy engine, the JAX package against the port, on
the CPU.

Twins of every case of tests/test_tenancy.py.  Each case runs the
reference test's body once per package (tests/test_torch_utils.loop_twin):
the port's ``Scheduler`` on the CPU with float64 keys, against the JAX
package under x64.  Both packages must return the same shard
assignments, dirty sets, binds and events, and the port's results must
pass the reference test's own assertions.  The bit-parity case also runs
in float32 (the port's float32 keys against JAX with x64 off).

The noisy-tenant case is held on its deterministic half: the reference
asserts a wall-clock band on the quiet tenant's time-to-bind p95, which
under six test workers measures the machine; here each wave's
time-to-bind is counted in scheduler cycles, which must be equal in both
packages and no more under the noisy storm than solo.
"""

import time

import pytest

from tests.test_torch_utils import Loop, bind_map, loop_twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

SHARD_ENV = {"KUBE_BATCH_TPU_TENANCY": "2",
             "KUBE_BATCH_TPU_SHARD_MAP": "qa:0|qb:1"}


def _tenancy_env(monkeypatch, on=True):
    for key, value in SHARD_ENV.items():
        if on:
            monkeypatch.setenv(key, value)
        else:
            monkeypatch.delenv(key, raising=False)


# ----------------------------------------------------------------------
# shard map, churn attribution, tenant table


def test_shard_map_deterministic_across_instances():
    def body(lp):
        ShardMap = lp.tenancy.ShardMap
        queues = [f"tenant-{i}" for i in range(50)] + ["default", "q0"]
        a, b = ShardMap(8), ShardMap(8)
        assigned = [a.shard_of(q) for q in queues]
        assert assigned == [b.shard_of(q) for q in queues]
        assert all(0 <= s < 8 for s in assigned)
        assert a.shard_of("default") == ShardMap(8).shard_of("default")
        return assigned, a.shards_of(queues)

    loop_twin(body)


def test_shard_map_overrides_and_validation():
    def body(lp):
        ShardMap = lp.tenancy.ShardMap
        parse = lp.shards.parse_shard_overrides
        m = ShardMap(4, {"whale": 3})
        assert m.shard_of("whale") == 3
        assert parse("a:0|b:3", 4) == {"a": 0, "b": 3}
        raised = []
        for bad in (lambda: parse("a:9", 4), lambda: parse("nonsense", 4),
                    lambda: ShardMap(0)):
            with pytest.raises(ValueError) as info:
                bad()
            raised.append(str(info.value))
        return raised

    loop_twin(body)


def test_shard_churn_attribution():
    def body(lp):
        m = lp.tenancy.ShardMap(4, {"qa": 1, "qb": 2})
        churn = lp.tenancy.ShardChurn(m)
        taken = [churn.take()]
        churn.note("qa")
        taken.append(churn.take())
        churn.note("qb")
        churn.note("qa")
        taken.append(churn.take())
        churn.note(None)
        taken.append(churn.take())
        churn.note_shard(3)
        taken.append(churn.take())
        assert taken[1:] == [{1}, {1, 2}, {0, 1, 2, 3}, {3}]
        return taken

    loop_twin(body)


def _mk_pod(lp, name, group, pool, ns="ten", cpu="1"):
    o, v1 = lp.objects, lp.v1alpha1
    return o.Pod(
        metadata=o.ObjectMeta(
            name=name, namespace=ns,
            annotations={v1.GroupNameAnnotationKey: group}),
        spec=o.PodSpec(node_name="", node_selector={"pool": pool},
                       containers=[o.Container(
                           requests={"cpu": cpu, "memory": "1Gi"})]),
        status=o.PodStatus(phase="Pending"))


def _submit_job(lp, cluster, name, replicas, queue, pool, ns="ten"):
    cluster.create_pod_group(lp.pod_group(name, ns, replicas, queue))
    for i in range(replicas):
        cluster.create_pod(_mk_pod(lp, f"{name}-{i}", name, pool, ns=ns))


def _build_two_tenant_cluster(lp):
    cluster = lp.cache.Cluster()
    for q in ("qa", "qb"):
        lp.queue(cluster, q)
    for i in range(4):
        cluster.create_node(lp.node(f"a{i}", {"pool": "a"}, cpu="2",
                                    mem="4Gi"))
        cluster.create_node(lp.node(f"b{i}", {"pool": "b"}, cpu="2",
                                    mem="4Gi"))
    for g in range(2):
        _submit_job(lp, cluster, f"ja-{g}", 2, "qa", "a")
        _submit_job(lp, cluster, f"jb-{g}", 2, "qb", "b")
    return cluster


def test_queue_move_dirties_both_source_and_destination_shard():
    def body(lp):
        cluster = _build_two_tenant_cluster(lp)
        cache = lp.cache.new_scheduler_cache(cluster)
        m = lp.tenancy.ShardMap(2, {"qa": 0, "qb": 1})
        churn = lp.tenancy.ShardChurn(m)
        cache.shard_churn = churn.note
        churn.take()
        cache.update_pod_group(None, lp.pod_group("ja-0", "ten", 2, "qb"))
        taken = churn.take()
        assert taken == {0, 1}
        return taken

    loop_twin(body)


def test_scoped_tenant_publish_zeroes_deleted_queue():
    def body(lp):
        table = lp.tenants.TenantTable()
        m = lp.tenancy.ShardMap(2, {"qa": 0, "qb": 1})

        def owns(shard):
            return lambda q: m.shard_of(q) == shard

        table.publish({"qa": {"share": 1.0}}, universe=owns(0))
        table.publish({"qb": {"share": 0.5}}, universe=owns(1))
        seen = [sorted(table.snapshot()["queues"])]
        table.publish({"qb": {"share": 0.5}}, universe=owns(1))
        seen.append(sorted(table.snapshot()["queues"]))
        table.publish({}, universe=owns(0))
        seen.append(sorted(table.snapshot()["queues"]))
        assert seen == [["qa", "qb"], ["qa", "qb"], ["qb"]]
        return seen

    loop_twin(body)


# ----------------------------------------------------------------------
# the engine over a real Scheduler


def test_periodic_floor_survives_sustained_churn(monkeypatch):
    """The quiet shard still revalidates on the per-shard floor under a
    storm that dirties the other shard every iteration, and not on every
    iteration.  The run counts are wall-clock driven, so each package
    is held to the reference's band rather than to the other's count."""
    _tenancy_env(monkeypatch)

    def body(lp):
        cluster = _build_two_tenant_cluster(lp)
        cache = lp.cache.new_scheduler_cache(cluster)
        scheduler = lp.scheduler(cache, schedule_period=0.05)
        engine = scheduler.tenancy
        scheduler.run_once()
        quiet_runs = 0
        for _ in range(10):
            last = engine._last_run.get(0, 0.0)
            engine.churn.note("qb")
            scheduler.run_once()
            if engine._last_run.get(0, 0.0) > last:
                quiet_runs += 1
            time.sleep(0.02)
        assert 2 <= quiet_runs < 10, quiet_runs
        return True

    loop_twin(body)


def test_shard_view_solver_state_is_per_view():
    def body(lp):
        cluster = lp.cache.Cluster()
        cache = lp.cache.new_scheduler_cache(cluster)
        m = lp.tenancy.ShardMap(2)
        v0 = lp.tenancy.ShardView(cache, 0, m)
        v1 = lp.tenancy.ShardView(cache, 1, m)
        s0, s1 = lp.incremental.state_for(v0), lp.incremental.state_for(v1)
        assert s0 is not None and s1 is not None and s0 is not s1
        assert getattr(cache, "_inc_state", None) is not s0
        assert v0.jobs is cache.jobs
        assert v0.mutex is cache.mutex
        # Each view its own resident shipper (and, on the card only, its
        # own CUDA stream: none on the CPU).
        kw = {"device": "cpu"} if lp.pkg == "torch" else {}
        sh0 = lp.shipping.resident_shipper(v0, **kw)
        sh1 = lp.shipping.resident_shipper(v1, **kw)
        assert sh0 is not sh1
        assert getattr(cache, "_ship_cache", None) is None
        if lp.pkg == "torch":
            assert v0.stream is None and v1.stream is None
        return repr(v0).split(", cache=")[0]

    loop_twin(body)


def _run_arm(lp, monkeypatch, tenancy, cycles=3):
    _tenancy_env(monkeypatch, tenancy)
    cluster = _build_two_tenant_cluster(lp)
    cache = lp.cache.new_scheduler_cache(cluster)
    scheduler = lp.scheduler(cache, schedule_period=3600)
    assert (scheduler.tenancy is not None) == tenancy
    for _ in range(cycles):
        assert scheduler.cycle()
    return bind_map(cluster), sorted(list(cache.events))


@pytest.mark.parametrize("x64", [True, False], ids=["x64", "f32"])
def test_tenancy_bit_parity_with_single_engine_control(monkeypatch, x64):
    def body(lp):
        control_binds, control_events = _run_arm(lp, monkeypatch, False)
        shard_binds, shard_events = _run_arm(lp, monkeypatch, True)
        assert control_binds, "control arm bound nothing — workload broken"
        assert shard_binds == control_binds
        assert shard_events == control_events
        for key, node in shard_binds.items():
            pool = "a" if "/ja-" in key else "b"
            assert node.startswith(pool)
        return shard_binds, shard_events

    loop_twin(body, x64=x64)


def test_per_shard_backoff_isolates_a_failing_shard(monkeypatch):
    _tenancy_env(monkeypatch)

    def body(lp):
        cluster = _build_two_tenant_cluster(lp)
        cache = lp.cache.new_scheduler_cache(cluster)
        scheduler = lp.scheduler(cache, schedule_period=0.01)
        engine = scheduler.tenancy
        real = scheduler.session_once

        def poisoned(cache_view, shard=None):
            if shard == 0:
                raise RuntimeError("poisoned shard session (test)")
            return real(cache_view, shard=shard)

        scheduler.session_once = poisoned
        for _ in range(3):
            assert scheduler.cycle()
        assert engine._failures.get(0, 0) >= 1
        assert 0 in engine._next_ok
        assert 1 not in engine._next_ok
        burned = bind_map(cluster)
        assert any("/jb-" in k for k in burned)
        assert not any("/ja-" in k for k in burned)
        del scheduler.session_once
        deadline = time.time() + 5.0
        while 0 in engine._next_ok and time.time() < deadline:
            time.sleep(0.02)
            scheduler.cycle()
        assert 0 not in engine._next_ok
        recovered = bind_map(cluster)
        assert any("/ja-" in k for k in recovered)
        return burned, recovered

    loop_twin(body)


# ----------------------------------------------------------------------
# noisy tenant (deterministic half)


def _quiet_wave_cycles(lp, scheduler, cluster, waves, noisy_churn=0):
    """The reference's wave protocol with each wave's time-to-bind
    counted in scheduler cycles (and the quiet gang's nodes recorded)."""
    out = []
    for wave in range(waves):
        if noisy_churn:
            name = f"storm-{wave}"
            _submit_job(lp, cluster, name, noisy_churn, "qb", "b")
            if wave >= 1:
                old = f"storm-{wave - 1}"
                for i in range(noisy_churn):
                    try:
                        cluster.delete_pod("ten", f"{old}-{i}")
                    except KeyError:
                        pass
                cluster.delete_pod_group("ten", old)
        name = f"quiet-{wave}"
        _submit_job(lp, cluster, name, 2, "qa", "a")
        keys = [f"ten/{name}-{i}" for i in range(2)]
        cycles = 0
        while cycles < 20:
            scheduler.cycle()
            cycles += 1
            with cluster.lock:
                if all(cluster.pods[k].spec.node_name for k in keys
                       if k in cluster.pods):
                    break
        with cluster.lock:
            nodes = [cluster.pods[k].spec.node_name for k in keys]
        out.append((cycles, nodes))
        for i in range(2):
            try:
                cluster.delete_pod("ten", f"{name}-{i}")
            except KeyError:
                pass
        cluster.delete_pod_group("ten", name)
        scheduler.cycle()
    return out


def test_noisy_tenant_storm_leaves_quiet_tenant_inside_band(monkeypatch):
    _tenancy_env(monkeypatch)

    def body(lp):
        def build():
            cluster = lp.cache.Cluster()
            for q in ("qa", "qb"):
                lp.queue(cluster, q)
            for i in range(4):
                cluster.create_node(lp.node(f"a{i}", {"pool": "a"},
                                            cpu="2", mem="4Gi"))
            for i in range(30):
                cluster.create_node(lp.node(f"b{i}", {"pool": "b"},
                                            cpu="2", mem="4Gi"))
            for g in range(5):
                _submit_job(lp, cluster, f"noisy-base-{g}", 20, "qb", "b")
            cache = lp.cache.new_scheduler_cache(cluster)
            scheduler = lp.scheduler(cache, schedule_period=3600)
            for _ in range(3):
                scheduler.cycle()
            return cluster, scheduler

        waves = 8
        cluster, scheduler = build()
        solo = _quiet_wave_cycles(lp, scheduler, cluster, waves)
        cluster, scheduler = build()
        storm = _quiet_wave_cycles(lp, scheduler, cluster, waves,
                                   noisy_churn=10)
        # Every quiet wave binds, and never in more cycles under the
        # storm than solo: the quiet shard is not serialized behind it.
        assert all(all(nodes) for _, nodes in solo + storm)
        assert all(s[0] <= q[0] for s, q in zip(storm, solo)), (solo, storm)
        row = lp.tenants.tenant_table.snapshot()["queues"].get("qa")
        assert row is None or row.get("starvation_s", 0.0) == 0.0
        return solo, storm

    loop_twin(body)


# ----------------------------------------------------------------------
# the port's own: one CUDA stream per shard view
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_views,shared", [(4, False), (32, False),
                                            (33, True)])
def test_shard_streams_distinct_up_to_the_pool(monkeypatch, caplog,
                                               n_views, shared):
    """assign_shard_streams gives every view its own stream from a pool
    that goes round-robin over 32 (as PyTorch's per-device pool does),
    starting wherever earlier streams left it: distinct up to 32 views,
    and past that a logged warning that shards share streams.  On the
    CPU no view gets a stream."""
    import torch

    from kube_batch_tpu_torch.tenancy.engine import assign_shard_streams

    taken = iter(range(1000))

    class PoolStream:
        def __init__(self, device):
            self.cuda_stream = 7000 + next(taken) % 32

    class View:
        stream = None

    for _ in range(5):           # streams other owners took before
        PoolStream("cuda")
    monkeypatch.setattr(torch.cuda, "Stream", PoolStream)
    views = [View() for _ in range(n_views)]
    assign_shard_streams(views, "cpu")
    assert all(v.stream is None for v in views)
    with caplog.at_level("WARNING"):
        assign_shard_streams(views, "cuda")
    handles = [v.stream.cuda_stream for v in views]
    assert len(set(handles)) == min(n_views, 32)
    assert ("share" in caplog.text) == shared
