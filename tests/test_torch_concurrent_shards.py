"""Concurrent shard micro-sessions, the JAX package against the port, on
the CPU.

Twins of tests/test_concurrent_shards.py: the bit-parity matrix across
seeds and in-flight depths, the conflict-fence rerun, the eviction conf's
victim order, lease loss mid-pipeline, the stop() drain, the drain
request, ``release_task``, the shard-load EWMA and the load-weighted
claim deferral.  Each case runs the reference test's body once per
package (tests/test_torch_utils.loop_twin); both packages must give the
same binds, events (victim order rides in them) and lineage bind
samples, and each must match its own sequential
``KUBE_BATCH_TPU_CONCURRENT_SHARDS=0`` arm.

Left out: ``test_concurrent_parity_on_force_shard_mesh`` (the sharded
route, ROADMAP queue 1 item 5).  The twins of
``test_device_error_mid_pipeline_degrades_one_shard`` and
``test_stale_fallback_aborts_to_sequential_rerun`` are in
tests/test_torch_degrade.py.  On the port alone: a failed fetch of a
pipelined session whose predecessor committed raises
``StaleSessionAbort`` and reruns the shard fresh, and a failed fetch
without a committed predecessor degrades that shard to the host oracle.
"""

import logging
import time

import pytest

from tests.test_torch_utils import Loop, bind_map, loop_twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401


def _mk_pod(lp, name, group, pool, ns="ten", cpu="500m", ts=0.0):
    o, v1 = lp.objects, lp.v1alpha1
    selector = {"pool": pool} if pool else {}
    return o.Pod(
        metadata=o.ObjectMeta(
            name=name, namespace=ns, uid=f"{ns}/{name}",
            creation_timestamp=ts,
            annotations={v1.GroupNameAnnotationKey: group}),
        spec=o.PodSpec(node_name="", node_selector=selector,
                       containers=[o.Container(
                           requests={"cpu": cpu, "memory": "1Gi"})]),
        status=o.PodStatus(phase="Pending"))


def _submit_job(lp, cluster, name, replicas, queue, pool, cpu="500m",
                ts=0.0):
    cluster.create_pod_group(lp.pod_group(name, "ten", replicas, queue))
    for i in range(replicas):
        cluster.create_pod(_mk_pod(lp, f"{name}-{i}", name, pool, cpu=cpu,
                                   ts=ts + i * 1e-3))


def _build_cluster(lp, tenants=4, nodes_per=3, seed=0, shared_pool=False):
    cluster = lp.cache.Cluster()
    for t in range(tenants):
        lp.queue(cluster, f"q{t}")
    for t in range(tenants):
        pool = "shared" if shared_pool else f"q{t}"
        for i in range(nodes_per):
            cluster.create_node(lp.node(f"{pool}-n{t}-{i}", {"pool": pool}))
    rng = seed * 2654435761 % 97
    for t in range(tenants):
        size = 2 + (rng + t) % 3
        pool = "shared" if shared_pool else f"q{t}"
        _submit_job(lp, cluster, f"base-{t}", size, f"q{t}", pool,
                    ts=float(t))
    return cluster


def _tenancy_env(monkeypatch, tenants, concurrent, depth=None):
    monkeypatch.setenv("KUBE_BATCH_TPU_TENANCY", str(tenants))
    monkeypatch.setenv("KUBE_BATCH_TPU_SHARD_MAP", "|".join(
        f"q{t}:{t}" for t in range(tenants)))
    monkeypatch.setenv("KUBE_BATCH_TPU_CONCURRENT_SHARDS",
                       "1" if concurrent else "0")
    if depth is not None:
        monkeypatch.setenv("KUBE_BATCH_TPU_SHARD_INFLIGHT", str(depth))
    else:
        monkeypatch.delenv("KUBE_BATCH_TPU_SHARD_INFLIGHT", raising=False)


def _drive(lp, monkeypatch, concurrent, seed=0, depth=None, tenants=4,
           cycles=3, shared_pool=False, conf=None):
    """The reference's ``_drive``: a fresh cluster, Scheduler and
    TenancyEngine, ``cycles`` loop iterations with one fresh per-tenant
    wave before each after the first.  Returns (binds, events, lineage
    bind samples, scheduler)."""
    _tenancy_env(monkeypatch, tenants, concurrent, depth)
    cluster = _build_cluster(lp, tenants=tenants, seed=seed,
                             shared_pool=shared_pool)
    cache = lp.cache.new_scheduler_cache(cluster)
    lp.lineage.clear()
    scheduler = lp.scheduler(cache, scheduler_conf=conf,
                             schedule_period=3600)
    assert (scheduler.tenancy.pipeline is not None) == concurrent
    for cyc in range(cycles):
        if cyc:
            for t in range(tenants):
                pool = "shared" if shared_pool else f"q{t}"
                _submit_job(lp, cluster, f"wave-{cyc}-{t}", 2, f"q{t}",
                            pool, ts=100.0 * cyc + t)
        assert scheduler.cycle()
    samples = sorted(p["pod"] for p in lp.lineage.dump()["pods"]
                     if p.get("bound"))
    return bind_map(cluster), list(cache.events), samples, scheduler


# ----------------------------------------------------------------------
# the parity matrix


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("depth", [2, 3])
def test_concurrent_bit_parity_across_seeds_and_depths(monkeypatch, seed,
                                                       depth):
    def body(lp):
        sb, se, sl, _ = _drive(lp, monkeypatch, False, seed=seed)
        begun = lp.metrics.shard_pipeline_counts().get("begun", 0)
        cb, ce, cl, _ = _drive(lp, monkeypatch, True, seed=seed,
                               depth=depth)
        assert sb, "control arm bound nothing — workload broken"
        assert (cb, ce, cl) == (sb, se, sl)
        assert lp.metrics.shard_pipeline_counts().get("begun", 0) > begun
        assert lp.solver.solver_inflight() == 0
        return cb, ce, cl

    loop_twin(body)


def test_conflict_fence_reruns_contending_tenants(monkeypatch):
    def body(lp):
        sb, se, sl, _ = _drive(lp, monkeypatch, False, shared_pool=True)
        before = lp.metrics.shard_pipeline_counts().get("conflict_rerun", 0)
        cb, ce, cl, _ = _drive(lp, monkeypatch, True, shared_pool=True)
        assert sb and (cb, ce, cl) == (sb, se, sl)
        reruns = (lp.metrics.shard_pipeline_counts().get("conflict_rerun", 0)
                  - before)
        assert reruns > 0
        return cb, ce, cl, reruns

    loop_twin(body)


EVICT_CONF = """
actions: "tpu-allocate, backfill, preempt"
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


def test_eviction_conf_keeps_victim_order_parity(monkeypatch):
    def arm(lp, concurrent):
        _tenancy_env(monkeypatch, 2, concurrent)
        o, v1 = lp.objects, lp.v1alpha1
        cluster = lp.cache.Cluster()
        for t in range(2):
            lp.queue(cluster, f"q{t}")
        for i in range(3):
            cluster.create_node(lp.node(f"n{i}", {"pool": "shared"}))
        cluster.create_priority_class(o.PriorityClass(
            metadata=o.ObjectMeta(name="hi"), value=1000))
        cluster.create_pod_group(lp.pod_group("base-0", "ten", 1, "q0"))
        for i in range(6):
            cluster.create_pod(_mk_pod(lp, f"base-0-{i}", "base-0",
                                       "shared", cpu="2000m", ts=i * 1e-3))
        cache = lp.cache.new_scheduler_cache(cluster)
        lp.lineage.clear()
        scheduler = lp.scheduler(cache, scheduler_conf=EVICT_CONF,
                                 schedule_period=3600)
        assert scheduler.cycle()
        for t in range(2):
            cluster.create_pod_group(lp.pod_group(
                f"pre-{t}", "ten", 2, f"q{t}", priority_class_name="hi"))
            for i in range(2):
                pod = _mk_pod(lp, f"pre-{t}-{i}", f"pre-{t}", "shared",
                              cpu="1500m", ts=50.0 + t)
                pod.spec.priority = 1000
                pod.spec.priority_class_name = "hi"
                cluster.create_pod(pod)
        for _ in range(3):
            assert scheduler.cycle()
        return bind_map(cluster), list(cache.events)

    def body(lp):
        sb, se = arm(lp, False)
        cb, ce = arm(lp, True)
        assert any(e[0] == "Evict" for e in se), \
            "workload produced no evictions — victim-order leg vacuous"
        assert (cb, ce) == (sb, se)
        return cb, ce

    loop_twin(body)


# ----------------------------------------------------------------------
# lease loss, stop, drain


def test_lease_loss_mid_pipeline_abandons_one_shard(monkeypatch):
    _tenancy_env(monkeypatch, 3, True)

    def body(lp):
        cluster = _build_cluster(lp, tenants=3, seed=4)
        cache = lp.cache.new_scheduler_cache(cluster)
        scheduler = lp.scheduler(cache, schedule_period=3600)
        engine = scheduler.tenancy
        engine.views[1]._lease_live = lambda shard: False
        assert scheduler.cycle()
        binds = bind_map(cluster)
        assert any("/base-0-" in k for k in binds)
        assert any("/base-2-" in k for k in binds)
        assert not any("/base-1-" in k for k in binds), \
            "fenced shard's egress escaped the lease fence"
        assert engine._failures.get(1, 0) >= 1
        assert 0 not in engine._failures and 2 not in engine._failures
        return binds, dict(engine._failures)

    loop_twin(body)


def test_stop_drains_inflight_dispatches(monkeypatch, caplog):
    _tenancy_env(monkeypatch, 2, True)

    def body(lp):
        caplog.clear()
        cluster = _build_cluster(lp, tenants=2, seed=5)
        cache = lp.cache.new_scheduler_cache(cluster)
        scheduler = lp.scheduler(cache, schedule_period=3600)
        pipeline = scheduler.tenancy.pipeline
        assert pipeline is not None
        stage = pipeline._begin(0)
        assert stage is not None
        pipeline._register(stage)
        kw = {"device": "cpu"} if lp.pkg == "torch" else {}
        shipper = lp.shipping.resident_shipper(scheduler.tenancy.views[0],
                                               **kw)
        gen0 = shipper.generation
        with caplog.at_level(logging.WARNING):
            scheduler.stop(timeout=0.1)
        warned = [rec.message for rec in caplog.records
                  if "stuck shard id" in rec.message]
        assert warned and "0" in warned[0]
        assert shipper.generation != gen0 or shipper._state is None
        assert lp.solver.solver_inflight() == 0
        lp.spans.resume_session(stage.handle.trace_obj)
        lp.spans.end_session()
        return warned[0].split(" — ")[-1], stage.has_pending

    loop_twin(body)


def test_drain_request_stops_new_begins(monkeypatch):
    _tenancy_env(monkeypatch, 3, True)

    def body(lp):
        cluster = _build_cluster(lp, tenants=3, seed=6)
        cache = lp.cache.new_scheduler_cache(cluster)
        scheduler = lp.scheduler(cache, schedule_period=3600)
        engine = scheduler.tenancy
        engine.request_drain()
        scheduler.run_once()
        dirty = engine.churn.take()
        assert dirty == {0, 1, 2}
        assert engine.abandon_inflight() == []
        assert bind_map(cluster) == {}
        return dirty

    loop_twin(body)


# ----------------------------------------------------------------------
# release_task, shard load, claim deferral


def test_release_task_matches_slow_transition():
    def body(lp):
        JobInfo, TaskInfo = lp.job_info.JobInfo, lp.job_info.TaskInfo
        TaskStatus = lp.api.TaskStatus

        def build():
            job = JobInfo(uid="j1")
            tasks = []
            for i in range(3):
                pod = _mk_pod(lp, f"p{i}", "g", "", ts=float(i))
                pod.status = lp.objects.PodStatus(phase="Running")
                pod.spec.node_name = "n0"
                t = TaskInfo(pod)
                job.add_task_info(t)
                tasks.append(t)
            return job, tasks

        fast_job, fast_tasks = build()
        slow_job, slow_tasks = build()
        fast_job.release_task(fast_tasks[1])
        slow_job.update_task_status(slow_tasks[1], TaskStatus.Releasing)
        assert list(fast_job.tasks) == list(slow_job.tasks)
        statuses = [t.status.name for t in fast_job.tasks.values()]
        assert statuses == [t.status.name for t in slow_job.tasks.values()]
        assert fast_job.allocated.milli_cpu == slow_job.allocated.milli_cpu
        index = {st.name: sorted(d)
                 for st, d in fast_job.task_status_index.items()}
        assert index == {st.name: sorted(d) for st, d in
                         slow_job.task_status_index.items()}
        other = fast_tasks[0].clone()
        other.status = TaskStatus.Pending
        fast_job.release_task(other)
        assert other.status == TaskStatus.Releasing
        assert fast_job.tasks[other.uid] is other
        return statuses, index, fast_job.allocated.milli_cpu

    loop_twin(body)


def test_shard_load_ewma_tracks_pods_and_churn():
    def body(lp):
        load = lp.tenancy.ShardLoad(2)
        for _ in range(10):
            load.note_session(0, 100)
            load.note_session(1, 2)
        assert load.load(0) > 10 * load.load(1)
        assert load.load(1) < 10
        settled = (round(load.load(0), 9), round(load.load(1), 9))
        load.MIN_RATE_WINDOW = 0.0
        time.sleep(0.01)
        for _ in range(50):
            load.note_churn(1)
        load.note_session(1, 2)
        assert load.load(1) > 2
        return settled

    loop_twin(body)


def test_lease_manager_load_weighted_deferral():
    def body(lp):
        mgr = lp.leases.ShardLeaseManager.__new__(
            lp.leases.ShardLeaseManager)
        mgr.num_shards = 4
        mgr.target_shards = 2
        mgr.shard_load = {0: 100.0, 1: 1.0, 2: 1.0, 3: 1.0}.get
        got = [mgr._over_target([0]), mgr._over_target([1])]
        mgr.shard_load = None
        got += [mgr._over_target([0]), mgr._over_target([0, 1])]
        assert got == [True, False, False, True]
        return got

    loop_twin(body)


# ----------------------------------------------------------------------
# a failed fetch mid-pipeline (the port alone)


def _failing_fetch(monkeypatch, fail_calls):
    """Make the port's fetch_solve raise on the given 1-based calls (it
    still consumes the handle, as a failed readback does)."""
    import kube_batch_tpu_torch.ops.solver as solver
    real = solver.fetch_solve
    calls = []

    def fetch(pending):
        calls.append(len(calls) + 1)
        out = real(pending)
        if len(calls) in fail_calls:
            raise RuntimeError(f"injected fetch failure (call {len(calls)})")
        return out

    monkeypatch.setattr(solver, "fetch_solve", fetch)
    return calls


def _two_tenant_run(lp, monkeypatch, concurrent, fail_calls=()):
    _tenancy_env(monkeypatch, 2, concurrent)
    cluster = _build_cluster(lp, tenants=2, seed=7)
    cache = lp.cache.new_scheduler_cache(cluster)
    scheduler = lp.scheduler(cache, schedule_period=3600)
    calls = (_failing_fetch(monkeypatch, fail_calls) if fail_calls
             else None)
    assert scheduler.cycle()
    monkeypatch.undo()
    return cluster, cache, scheduler, calls


def test_stale_fetch_failure_aborts_to_a_fresh_rerun(monkeypatch):
    """Shard 0 retires first and binds, which marks the in-flight shard 1
    stale; shard 1's fetch then fails.  The port raises
    StaleSessionAbort before any mutation and the pipeline reruns shard 1
    fresh: the cycle ends with the binds and events of the sequential
    arm without the failure, and no shard backs off."""
    lp = Loop("torch")
    cluster, cache, _, _ = _two_tenant_run(lp, monkeypatch, False)
    seq_binds, seq_events = bind_map(cluster), list(cache.events)
    assert seq_binds
    before = lp.metrics.shard_pipeline_counts().get("conflict_rerun", 0)
    aborts = []
    import kube_batch_tpu_torch.tenancy.pipeline as pipeline_mod
    real_finish = lp.sched_mod.Scheduler.finish_shard_session

    def finish(self, handle):
        try:
            return real_finish(self, handle)
        except pipeline_mod.StaleSessionAbort as exc:
            aborts.append((handle.shard, str(exc)))
            raise

    monkeypatch.setattr(lp.sched_mod.Scheduler, "finish_shard_session",
                        finish)
    import kube_batch_tpu_torch.chaos.breaker as brk
    breaker = brk.CircuitBreaker("device_solve", threshold=99,
                                 cooldown=1.0)
    monkeypatch.setattr(brk, "_device_breaker", breaker)
    cluster, cache, scheduler, calls = _two_tenant_run(
        lp, monkeypatch, True, fail_calls=(2,))
    assert calls == [1, 2, 3]   # shard 0, shard 1 (fails), the rerun
    assert [shard for shard, _ in aborts] == [1]
    assert "injected fetch failure" in aborts[0][1]
    assert (lp.metrics.shard_pipeline_counts().get("conflict_rerun", 0)
            == before + 1)
    assert bind_map(cluster) == seq_binds
    assert list(cache.events) == seq_events
    assert scheduler.tenancy._failures == {}
    assert lp.solver.solver_inflight() == 0


def test_fresh_fetch_failure_backs_off_one_shard(monkeypatch):
    """A failed fetch with no committed predecessor is not stale: the
    retire half degrades that shard's session to the host oracle, as the
    reference does, instead of raising — no shard backs off, both shards
    bind what the sequential arm binds, the failure feeds the breaker
    once, and only the failing shard's resident image is dropped."""
    import kube_batch_tpu_torch.chaos.breaker as brk
    lp = Loop("torch")
    cluster, _, _, _ = _two_tenant_run(lp, monkeypatch, False)
    seq_binds = bind_map(cluster)
    breaker = brk.CircuitBreaker("device_solve", threshold=99,
                                 cooldown=1.0)
    monkeypatch.setattr(brk, "_device_breaker", breaker)
    failures = lp.metrics.device_solve_failures.value("solve")
    real_failure = breaker.failure
    fed = []
    breaker.failure = lambda: (fed.append(1), real_failure())[1]
    cluster, _, scheduler, calls = _two_tenant_run(
        lp, monkeypatch, True, fail_calls=(1,))
    assert calls == [1, 2]
    engine = scheduler.tenancy
    assert engine._failures == {}
    assert bind_map(cluster) == seq_binds
    assert any("/base-0-" in k for k in seq_binds)
    assert lp.metrics.device_solve_failures.value("solve") == failures + 1
    assert fed == [1]
    assert lp.solver.solver_inflight() == 0
