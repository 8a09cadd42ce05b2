"""The Scheduler loop, the JAX package against the port, on the CPU.

Twins of the four loop cases of tests/test_incremental_sessions.py: an
own status write's echo does not wake the loop, cache churn wakes a
sleeping loop, ``stop()`` wakes it at once, and the periodic
``KUBE_BATCH_TPU_FULL_EVERY`` floor forces full sessions.  Each body
runs once per package (tests/test_torch_utils.loop_twin); the port's
``Scheduler`` on the CPU.  Every wait is bounded, and a test that starts
``Scheduler.run()`` (which freezes the collector's generations) undoes
the freeze in teardown.  Also here: ``Scheduler(cache)`` raises without
CUDA, and a global cycle binds what one open -> tpu-allocate -> close
session binds.
"""

import dataclasses as dc
import gc
import threading
import time

import pytest
import torch

from tests.test_torch_utils import Loop, loop_twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401


@pytest.fixture(autouse=True)
def _unfreeze():
    yield
    gc.unfreeze()


def _echo(lp, cache, binder):
    """Informer echo of binds and PodGroup status writes."""
    podmap = {}
    for job in cache.jobs.values():
        for t in job.tasks.values():
            podmap[lp.api.pod_key(t.pod)] = t.pod
    for key, node in sorted(binder.binds.items()):
        old = podmap.get(key)
        if old is None:
            continue
        new = dc.replace(old, spec=dc.replace(old.spec, node_name=node),
                         status=lp.objects.PodStatus(phase="Running"))
        cache.update_pod(old, new)
    binder.binds.clear()
    updater = cache.status_updater
    for pg in updater.pod_groups:
        cache.add_pod_group(pg)
    updater.pod_groups.clear()


def test_own_status_write_echo_does_not_spin_the_loop():
    def body(lp):
        o, v1 = lp.objects, lp.v1alpha1
        cluster = lp.cache.Cluster()
        cluster.create_node(lp.node("n0", cpu="8", mem="16Gi"))
        lp.queue(cluster, "default")
        cluster.create_pod_group(lp.pod_group("pg1", "ns1", 3, "default"))
        cluster.create_pod(o.Pod(
            metadata=o.ObjectMeta(
                name="p0", namespace="ns1", uid="p0",
                annotations={v1.GroupNameAnnotationKey: "pg1"},
                creation_timestamp=1.0),
            spec=o.PodSpec(containers=[o.Container(
                requests={"cpu": "1", "memory": "1Gi"})]),
            status=o.PodStatus(phase="Pending")))
        cache = lp.cache.new_scheduler_cache(cluster)
        sched = lp.scheduler(cache, schedule_period=30.0)
        counted = []
        real_run_once = sched.run_once
        sched.run_once = lambda: (counted.append(time.monotonic()),
                                  real_run_once())
        sched.run()
        try:
            deadline = time.monotonic() + 5
            while not counted and time.monotonic() < deadline:
                time.sleep(0.02)
            assert counted, "no cycle ran"
            time.sleep(1.0)
            baseline = len(counted)
            time.sleep(1.5)
            extra = len(counted) - baseline
            assert extra <= 2, (
                f"loop self-woke {extra} times in 1.5s of idle cluster")
        finally:
            sched.stop()
        assert not sched._thread.is_alive()
        with cluster.lock:
            pg = cluster.pod_groups["ns1/pg1"]
            return pg.status.phase, sorted({c.type
                                            for c in pg.status.conditions})

    loop_twin(body)


def _wake_pod(lp):
    o = lp.objects
    return o.Pod(metadata=o.ObjectMeta(name="wake", namespace="bench",
                                       uid="wake", creation_timestamp=2e6),
                 spec=o.PodSpec(containers=[o.Container(
                     requests={"cpu": "100m", "memory": "64Mi"})]),
                 status=o.PodStatus(phase="Pending"))


def test_scheduler_wakes_on_cache_churn():
    def body(lp):
        cache, _binder = lp.synthetic.make_synthetic_cache(10, 4, 2, 2)
        sched = lp.scheduler(cache, schedule_period=30.0)
        ran = threading.Event()
        sched.run_once = ran.set
        sched.run()
        try:
            assert ran.wait(5.0), "first cycle never ran"
            ran.clear()
            time.sleep(0.1)
            t0 = time.monotonic()
            cache.add_pod(_wake_pod(lp))
            assert ran.wait(5.0), "churn did not wake the sleeping loop"
            assert time.monotonic() - t0 < 5.0
        finally:
            sched.stop()
        return not sched._thread.is_alive()

    assert loop_twin(body)


def test_stop_wakes_a_sleeping_loop_immediately():
    def body(lp):
        cache, _binder = lp.synthetic.make_synthetic_cache(10, 4, 2, 2)
        sched = lp.scheduler(cache, schedule_period=30.0)
        ran = threading.Event()
        sched.run_once = ran.set
        sched.run()
        assert ran.wait(5.0)
        time.sleep(0.1)
        t0 = time.monotonic()
        sched.stop(timeout=10.0)
        elapsed = time.monotonic() - t0
        assert elapsed < 5.0, f"stop() blocked {elapsed:.1f}s"
        return sched._thread.is_alive()

    assert loop_twin(body) is False


def test_scheduler_periodic_floor_forces_full_sessions(monkeypatch):
    monkeypatch.setenv("KUBE_BATCH_TPU_FULL_EVERY", "2")

    def body(lp):
        cache, binder = lp.synthetic.make_synthetic_cache(40, 8, 6, 2)
        sched = lp.scheduler(cache, schedule_period=30.0)
        kinds, binds = [], []
        for i in range(4):
            force_full = (i + 1) % 2 == 0
            assert sched.cycle(force_full=force_full)
            kinds.append(lp.incremental.state_for(cache).last_kind)
            binds.append(sorted(binder.binds.items()))
            _echo(lp, cache, binder)
        assert "full" in kinds[1::2], kinds
        return kinds, binds

    loop_twin(body)


def test_scheduler_needs_cuda_or_an_explicit_cpu():
    lp = Loop("torch")
    cache, _binder = lp.synthetic.make_synthetic_cache(10, 4, 2, 2)
    if torch.cuda.is_available():
        assert lp.sched_mod.Scheduler(cache).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lp.sched_mod.Scheduler(cache)
    sched = lp.scheduler(cache)
    assert sched.device == torch.device("cpu")
    assert sched.dtype == torch.float64


@pytest.mark.parametrize("x64", [True, False], ids=["x64", "f32"])
def test_global_cycle_binds_the_session_kernel_placements(x64):
    """One global Scheduler.cycle() binds what tpu-allocate solved, in
    both packages, with the same pod-group statuses and events."""
    def body(lp):
        cache, binder = lp.synthetic.make_synthetic_cache(300, 40, 12, 3)
        sched = lp.scheduler(cache, schedule_period=3600)
        assert sched.tenancy is None
        assert sched.cycle()
        statuses = sorted((pg.metadata.name, pg.status.phase)
                          for pg in cache.status_updater.pod_groups)
        assert binder.binds
        return list(binder.binds.items()), statuses, list(cache.events)

    loop_twin(body, x64=x64)
