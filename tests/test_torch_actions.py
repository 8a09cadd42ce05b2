"""Action-level twins: allocate, backfill, preempt and reclaim without a
cluster, the JAX package against the port, on the CPU.

Twins of every test of tests/test_actions.py and tests/test_backfill_scan.py.
Each case hand-builds a SchedulerCache with fake effectors in each package
(tests/test_torch_utils.Pkg), runs the real ``open_session ->
action.execute`` pipeline, and compares what the FakeBinder, the
FakeEvictor and the session record: the port's binds, victims in order,
events and end states must equal the JAX package's, and must pass the
reference test's own assertions.  The port's actions and scanner run on
the CPU.  The reference's volume-failure case drives the cluster
simulator (ROADMAP queue 1 item 9); its twin gives both caches the same
missing-PVC volume binder instead.
"""

import dataclasses as dc
import os

import numpy as np
import pytest

from tests.test_torch_utils import build_cache, session_state, twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"x64": True, "f32": False}


def make_cache(p, pods=(), nodes=(), pod_groups=(), queues=("c1",),
               volume_binder=None):
    cache, binder, evictor = p.empty_cache()
    if volume_binder is not None:
        cache.volume_binder = volume_binder
    for name in queues:
        cache.add_queue(p.queue(name))
    for pg in pod_groups:
        cache.add_pod_group(pg)
    for node in nodes:
        cache.add_node(node)
    for pod in pods:
        cache.add_pod(pod)
    return cache, binder, evictor


def pg(p, name, namespace="c1", min_member=1, queue="c1"):
    return p.pod_group(name, namespace, min_member, queue)


def rl(cpu, memory, **kw):
    return {"cpu": cpu, "memory": memory, **kw}


def run(p, cache, name, conf=None):
    """open_session -> one action -> close_session (the reference's
    run_session)."""
    ssn = p.m.framework.open_session(cache, p.tiers(conf))
    try:
        p.action(name).execute(ssn)
        return session_state(ssn)
    finally:
        p.m.framework.close_session(ssn)


def effects(p, cache, binder, evictor, state=None):
    return (dict(binder.binds), list(binder.channel), list(evictor.evicts),
            list(cache.events), state)


# --- TestAllocate ------------------------------------------------------------

def _alloc_one_queue_one_job(p):
    pods = [p.pod("c1", "p1", "", "Pending", rl("1", "1Gi"), "pg1"),
            p.pod("c1", "p2", "", "Pending", rl("1", "1Gi"), "pg1")]
    nodes = [p.node("n1", rl("2", "4Gi", pods=10))]
    return make_cache(p, pods, nodes, [pg(p, "pg1")])


def _alloc_two_queues(p):
    pods = [p.pod("c1", "p1", "", "Pending", rl("1", "1G"), "pg1"),
            p.pod("c1", "p2", "", "Pending", rl("1", "1G"), "pg1"),
            p.pod("c2", "p1", "", "Pending", rl("1", "1G"), "pg2"),
            p.pod("c2", "p2", "", "Pending", rl("1", "1G"), "pg2")]
    nodes = [p.node("n1", rl("2", "4G", pods=10))]
    return make_cache(p, pods, nodes,
                      [pg(p, "pg1", "c1", queue="c1"),
                       pg(p, "pg2", "c2", queue="c2")], queues=("c1", "c2"))


def _alloc_gang(n_cpu, min_member):
    def make(p):
        pods = [p.pod("c1", f"p{i}", "", "Pending", rl("1", "1Gi"), "pg1")
                for i in range(3)]
        nodes = [p.node("n1", rl(n_cpu, "8Gi", pods=10))]
        return make_cache(p, pods, nodes,
                          [pg(p, "pg1", min_member=min_member)])
    return make


def _alloc_job_invalid(p):
    pods = [p.pod("c1", "p1", "", "Pending", rl("1", "1Gi"), "pg1")]
    nodes = [p.node("n1", rl("4", "8Gi", pods=10))]
    return make_cache(p, pods, nodes, [pg(p, "pg1", min_member=2)])


def _best_effort(p):
    pods = [p.pod("c1", "p1", "", "Pending", {}, "pg1")]
    nodes = [p.node("n1", rl("4", "8Gi", pods=10))]
    return make_cache(p, pods, nodes, [pg(p, "pg1")])


def _alloc_selector(p):
    pods = [p.pod("c1", "p1", "", "Pending", rl("1", "1Gi"), "pg1",
                  selector={"zone": "a"})]
    nodes = [p.node("n1", rl("4", "8Gi", pods=10), labels={"zone": "b"}),
             p.node("n2", rl("4", "8Gi", pods=10), labels={"zone": "a"})]
    return make_cache(p, pods, nodes, [pg(p, "pg1")])


def _two_queues_fair(binds):
    assert len(binds) == 2
    assert {k.split("/")[0] for k in binds} == {"c1", "c2"}


ALLOCATE = {
    "one_queue_one_job": (_alloc_one_queue_one_job, "allocate",
                          lambda b: b == {"c1/p1": "n1", "c1/p2": "n1"}),
    "two_queues_fair_share": (_alloc_two_queues, "allocate",
                              lambda b: _two_queues_fair(b) is None),
    "gang_blocks_partial_placement": (_alloc_gang("2", 3), "allocate",
                                      lambda b: b == {}),
    "gang_dispatches_when_ready": (_alloc_gang("4", 3), "allocate",
                                   lambda b: len(b) == 3),
    "job_invalid_without_enough_tasks": (_alloc_job_invalid, "allocate",
                                         lambda b: b == {}),
    "best_effort_skipped": (_best_effort, "allocate", lambda b: b == {}),
    "node_selector_respected": (_alloc_selector, "allocate",
                                lambda b: b == {"c1/p1": "n2"}),
    # TestBackfill
    "backfill_best_effort_lands": (_best_effort, "backfill",
                                   lambda b: b == {"c1/p1": "n1"}),
}


@pytest.mark.parametrize("case", sorted(ALLOCATE))
def test_allocate_and_backfill(case):
    """TestAllocate and TestBackfill."""
    make, action, check = ALLOCATE[case]

    def body(p):
        cache, binder, evictor = make(p)
        state = run(p, cache, action)
        return effects(p, cache, binder, evictor, state)
    binds = twin(body)[0]
    assert check(binds)


# --- TestPreempt, TestConformance, TestReclaim -------------------------------

def _preempt_cluster(pods_of):
    def make(p):
        nodes = [p.node("n1", rl("2", "2G", pods=10))]
        pgs = [pg(p, "low"), pg(p, "high")]
        cache, binder, evictor = make_cache(p, pods_of(p), nodes, pgs)
        for job in cache.jobs.values():
            if job.name == "high":
                job.priority = 100
        return cache, binder, evictor
    return make


def _low_high(p, classes=("", "")):
    return [p.pod("c1", "low1", "n1", "Running", rl("1", "1G"), "low",
                  priority=1, priority_class_name=classes[0]),
            p.pod("c1", "low2", "n1", "Running", rl("1", "1G"), "low",
                  priority=1, priority_class_name=classes[1]),
            p.pod("c1", "high1", "", "Pending", rl("1", "1G"), "high",
                  priority=100)]


def _crit_and_plain(p):
    return [p.pod("c1", "crit", "n1", "Running", rl("1", "1G"), "low",
                  priority=1, priority_class_name="system-cluster-critical"),
            p.pod("c1", "plain", "n1", "Running", rl("1", "1G"), "low",
                  priority=1),
            p.pod("c1", "high1", "", "Pending", rl("1", "1G"), "high",
                  priority=100)]


def _equal_priority(p):
    pods = [p.pod("c1", "a1", "n1", "Running", rl("2", "2G"), "pga",
                  priority=5),
            p.pod("c1", "b1", "", "Pending", rl("2", "2G"), "pgb",
                  priority=5)]
    nodes = [p.node("n1", rl("2", "2G", pods=10))]
    return make_cache(p, pods, nodes, [pg(p, "pga"), pg(p, "pgb")])


def _reclaim_cluster(namespace):
    def make(p):
        pods = [p.pod(namespace, "owner1", "n1", "Running", rl("1", "1G"),
                      "pg1"),
                p.pod(namespace, "owner2", "n1", "Running", rl("1", "1G"),
                      "pg1"),
                p.pod("c2", "starved", "", "Pending", rl("1", "1G"), "pg2")]
        nodes = [p.node("n1", rl("2", "2G", pods=10))]
        pgs = [pg(p, "pg1", namespace, queue="q1"),
               pg(p, "pg2", "c2", queue="q2")]
        return make_cache(p, pods, nodes, pgs, queues=("q1", "q2"))
    return make


def _one_low_victim(ev):
    return len(ev) == 1 and ev[0].startswith("c1/low")


EVICTING = {
    "preempt_high_priority_preempts": (_preempt_cluster(_low_high),
                                       "preempt", _one_low_victim),
    "preempt_no_preempt_within_equal_priority": (_equal_priority, "preempt",
                                                 lambda ev: ev == []),
    "conformance_preempt_spares_critical_victims": (
        _preempt_cluster(lambda p: _low_high(
            p, ("system-cluster-critical", "system-node-critical"))),
        "preempt", lambda ev: ev == []),
    "conformance_preempt_evicts_only_noncritical": (
        _preempt_cluster(_crit_and_plain), "preempt",
        lambda ev: ev == ["c1/plain"]),
    "conformance_reclaim_spares_kube_system": (
        _reclaim_cluster("kube-system"), "reclaim", lambda ev: ev == []),
    "reclaim_cross_queue_reclaim": (
        _reclaim_cluster("c1"), "reclaim",
        lambda ev: len(ev) == 1 and ev[0].startswith("c1/owner")),
}


@pytest.mark.parametrize("case", sorted(EVICTING))
def test_preempt_and_reclaim(case):
    """TestPreempt, TestConformance's eviction cases and TestReclaim, at
    the reference's default SCAN_MIN_NODES (the host walk at one node)."""
    make, action, check = EVICTING[case]

    def body(p):
        cache, binder, evictor = make(p)
        state = run(p, cache, action)
        return effects(p, cache, binder, evictor, state)
    assert check(twin(body)[2])


def test_conformance_filter_drops_critical_tasks():
    def body(p):
        task_info = p.mod.api_job_info.TaskInfo
        is_critical = p.mod.plugins_conformance._is_critical
        normal = task_info(p.pod("ns", "plain", "n1", "Running",
                                 rl("1", "1G")))
        by_class = task_info(p.pod(
            "ns", "crit", "n1", "Running", rl("1", "1G"),
            priority_class_name="system-cluster-critical"))
        by_node_class = task_info(p.pod(
            "ns", "crit2", "n1", "Running", rl("1", "1G"),
            priority_class_name="system-node-critical"))
        by_ns = task_info(p.pod("kube-system", "dns", "n1", "Running",
                                rl("1", "1G")))
        return [is_critical(t) for t in (normal, by_class, by_node_class,
                                         by_ns)]
    assert twin(body) == [False, True, True, True]


def test_statement_commit_failure_restores_victim_index():
    """TestStatementVictimIndex."""
    def body(p):
        pods = [p.pod("c1", "r1", "n1", "Running", rl("1", "1Gi"), "pg1")]
        nodes = [p.node("n1", rl("2", "4Gi", pods=10))]
        cache, _, _ = make_cache(p, pods, nodes, [pg(p, "pg1")])
        ssn = p.m.framework.open_session(cache, p.tiers())
        try:
            vindex = p.mod.models_victim_index.VictimIndex.for_session(ssn)
            totals = [vindex.total]
            job = next(iter(ssn.jobs.values()))
            task = next(t for t in job.tasks.values()
                        if t.status is p.m.api.TaskStatus.Running)
            stmt = p.mod.framework_statement.Statement(ssn)
            stmt.evict(task, "test")
            vindex.on_evict(task.node_name, job.queue, task.job)
            totals.append(vindex.total)

            def boom(*_a, **_k):
                raise RuntimeError("apiserver down")

            ssn.cache.evict = boom
            stmt.commit()
            totals.append(vindex.total)
            return (totals, task.status.name,
                    vindex.node_for_other_queues("n1", "another-queue"))
        finally:
            p.m.framework.close_session(ssn)
    assert twin(body) == ([1, 0, 1], "Running", True)


# --- TestBatchApply, TestBatchApplyVolumeFailure -----------------------------

BATCH_SPEC = dict(
    queues=[("q1", 1), ("q2", 2)],
    pod_groups=[("pg1", "ns", 2, "q1"), ("pg2", "ns", 1, "q2")],
    pods=[("ns", f"a{i}", "", "Pending", "1", "1Gi", "pg1")
          for i in range(3)]
    + [("ns", f"b{i}", "", "Pending", "2", "2Gi", "pg2") for i in range(2)],
    nodes=[("n1", "8", "16Gi"), ("n2", "4", "8Gi")])


def _batch_session(p):
    cache, binder, _ = build_cache(BATCH_SPEC, p.pkg)
    return p.m.framework.open_session(cache, p.tiers()), binder


def _placements(ssn, node=None):
    out = []
    for uid in sorted(ssn.jobs):
        for t in sorted(ssn.jobs[uid].tasks.values(), key=lambda t: t.uid):
            out.append((t, node or ("n1" if t.name.startswith("a")
                                    else "n2"), 1))
    return out


def _apply_state(ssn, binder):
    return {
        "binds": dict(binder.binds),
        "idle": {n: (node.idle.milli_cpu, node.idle.memory)
                 for n, node in ssn.nodes.items()},
        "used": {n: (node.used.milli_cpu, node.used.memory)
                 for n, node in ssn.nodes.items()},
        "statuses": {uid: sorted((t.uid, t.status.name)
                                 for t in job.tasks.values())
                     for uid, job in ssn.jobs.items()},
        "allocated": {uid: (job.allocated.milli_cpu, job.allocated.memory)
                      for uid, job in ssn.jobs.items()},
        "node_tasks": {n: sorted(node.tasks)
                       for n, node in ssn.nodes.items()},
    }


def test_batch_apply_matches_sequential():
    def body(p):
        ssn1, b1 = _batch_session(p)
        ssn1._apply_sequential(_placements(ssn1))
        ssn2, b2 = _batch_session(p)
        ssn2.batch_apply(_placements(ssn2))
        assert _apply_state(ssn1, b1) == _apply_state(ssn2, b2)
        return _apply_state(ssn2, b2)
    twin(body)


def test_batch_apply_infeasible_falls_back_to_sequential():
    def body(p):
        ssn, binder = _batch_session(p)
        ssn.batch_apply(_placements(ssn, node="n2"))
        node = ssn.nodes["n2"]
        assert node.idle.milli_cpu >= -10
        assert node.used.milli_cpu <= 4000 + 10
        return _apply_state(ssn, binder)
    twin(body)


class _PvcBinder:
    """The cluster simulator's volume binder against an empty PVC store:
    a pod that references a claim fails allocate_volumes."""

    def allocate_volumes(self, task, hostname):
        for claim in task.pod.spec.volumes:
            raise KeyError(f"pod {task.namespace}/{task.name} references "
                           f"missing PVC {claim}")

    def bind_volumes(self, task):
        pass


def test_batch_apply_bad_volume_skips_only_that_task():
    """TestBatchApplyVolumeFailure."""
    def body(p):
        pods = []
        for i, vols in enumerate(([], ["missing-pvc"], [])):
            pod = p.pod("ns", f"p{i}", "", "Pending", rl("1", "1Gi"), "pg")
            pod.spec.volumes = list(vols)
            pods.append(pod)
        nodes = [p.node("n1", rl("8", "16Gi", pods=110))]
        cache, binder, _ = make_cache(
            p, pods, nodes, [pg(p, "pg", "ns", queue="default")],
            queues=("default",), volume_binder=_PvcBinder())
        ssn = p.m.framework.open_session(cache, p.tiers())
        try:
            ssn.batch_apply([(t, "n1", 1) for _uid, t in
                             sorted(ssn.jobs["ns/pg"].tasks.items())])
            node = ssn.nodes["n1"]
            assert "ns/p0" in node.tasks and "ns/p2" in node.tasks
            assert "ns/p1" not in node.tasks
            assert node.used.milli_cpu == 2000.0
            statuses = {t.name: t.status.name
                        for t in ssn.jobs["ns/pg"].tasks.values()}
            assert statuses["p1"] == "Pending" != statuses["p0"]
            return statuses, sorted(node.tasks), dict(binder.binds)
        finally:
            p.m.framework.close_session(ssn)
    twin(body)


# --- TestDeviceScanParity, TestScanEngines -----------------------------------

def _scan_preempt_cluster(p):
    cache, binder, evictor = p.empty_cache()
    cache.add_queue(p.queue("q1"))
    for i in range(3):
        cache.add_node(p.node(f"n{i}", rl("4", "8Gi", pods=110)))
    cache.add_pod_group(p.pod_group("low", "ns", 1, "q1"))
    cache.add_pod_group(p.pod_group("high", "ns", 2, "q1"))
    for i in range(6):
        cache.add_pod(p.pod("ns", f"lo{i}", f"n{i % 3}", "Running",
                            rl("2", "4Gi"), "low", priority=1, ts=float(i)))
    for i in range(2):
        cache.add_pod(p.pod("ns", f"hi{i}", "", "Pending", rl("2", "4Gi"),
                            "high", priority=100, ts=float(10 + i)))
    for job in cache.jobs.values():
        for t in job.tasks.values():
            t.priority = 100 if t.name.startswith("hi") else 1
    cache.jobs["ns/high"].priority = 100
    cache.jobs["ns/low"].priority = 1
    return cache, binder, evictor


def _scan_reclaim_cluster(p):
    cache, binder, evictor = p.empty_cache()
    cache.add_queue(p.queue("greedy", ts=0.0))
    cache.add_queue(p.queue("starved", ts=1.0))
    for i in range(2):
        cache.add_node(p.node(f"n{i}", rl("4", "8Gi", pods=110)))
    cache.add_pod_group(p.pod_group("hog", "ns", 1, "greedy"))
    cache.add_pod_group(p.pod_group("want", "ns", 1, "starved"))
    for i in range(4):
        cache.add_pod(p.pod("ns", f"hog{i}", f"n{i % 2}", "Running",
                            rl("2", "4Gi"), "hog", ts=float(i)))
    cache.add_pod(p.pod("ns", "want0", "", "Pending", rl("2", "4Gi"), "want",
                        ts=10.0))
    return cache, binder, evictor


def _run_actions(p, names, build, monkeypatch, min_nodes):
    monkeypatch.setenv("KUBE_BATCH_TPU_SCAN_MIN_NODES", str(min_nodes))
    cache, binder, evictor = build(p)
    default = p.m.scheduler.DEFAULT_SCHEDULER_CONF
    conf = 'actions: "%s"\n%s' % (names, "tiers:" + default.split("tiers:")[1])
    actions, tiers = p.load(conf)
    ssn = p.m.framework.open_session(cache, tiers)
    try:
        for action in actions:
            action.execute(ssn)
    finally:
        p.m.framework.close_session(ssn)
    return dict(binder.binds), list(evictor.evicts)


@pytest.mark.parametrize("action,build", [
    ("preempt", _scan_preempt_cluster), ("reclaim", _scan_reclaim_cluster)])
def test_device_scan_parity(monkeypatch, action, build):
    """TestDeviceScanParity's preempt and reclaim cases: the scanner walk
    and the host walk decide alike, in each package."""
    def body(p):
        host = _run_actions(p, action, build, monkeypatch, 1 << 30)
        dev = _run_actions(p, action, build, monkeypatch, 0)
        assert dev[0] == host[0]
        assert sorted(dev[1]) == sorted(host[1])
        return host, dev
    host, _ = twin(body)
    assert host[1], "scenario must actually evict"


def _open_scanner(p, monkeypatch, build=_scan_preempt_cluster):
    monkeypatch.setenv("KUBE_BATCH_TPU_SCAN_MIN_NODES", "0")
    cache, _, _ = build(p)
    ssn = p.m.framework.open_session(cache, p.tiers())
    return ssn, p.scanner(ssn)


def test_checkpoint_frames_balanced(monkeypatch):
    def body(p):
        scanner_mod = p.mod.models_scanner
        captured = []
        real = scanner_mod.maybe_scanner

        def capture(ssn, **kwargs):
            s = real(ssn, **kwargs)
            captured.append(s)
            return s

        monkeypatch.setattr(scanner_mod, "maybe_scanner", capture)
        try:
            out = _run_actions(p, "preempt", _scan_preempt_cluster,
                               monkeypatch, 0)
        finally:
            monkeypatch.setattr(scanner_mod, "maybe_scanner", real)
        assert captured and captured[0] is not None
        return captured[0]._checkpoints, out
    assert twin(body)[0] == []


def test_scanner_active_when_forced(monkeypatch):
    def body(p):
        ssn, scanner = _open_scanner(p, monkeypatch)
        p.m.framework.close_session(ssn)
        return scanner is not None
    assert twin(body)


def test_copy_on_write_checkpoint_semantics(monkeypatch):
    def body(p):
        ssn, sc = _open_scanner(p, monkeypatch)
        try:
            task = sc.snap.tasks[0]
            node0, node1 = sc.snap.node_names[:2]
            base = sc.dyn.copy()
            sc.checkpoint()
            sc.apply_pipeline(task, node0)
            after_outer = sc.dyn.copy()
            sc.checkpoint()
            sc.apply_pipeline(task, node0)
            sc.apply_pipeline(task, node1)
            sc.commit()
            sc.restore()
            assert (sc.dyn == base).all()
            assert sc._checkpoints == []
            sc.checkpoint()
            sc.apply_pipeline(task, node0)
            sc.commit()
            assert (sc.dyn == after_outer).all()
            sc.checkpoint()
            sc.scores(task)
            sc.apply_pipeline(task, node1)
            sc.restore()
            got = sc.scores(task)
            fresh = sc._scores_numpy(sc.task_index[task.uid])
            assert np.array_equal(got, fresh[:len(got)])
            return sc.dyn.tolist(), got.tolist()
        finally:
            p.m.framework.close_session(ssn)
    twin(body)


def test_numpy_and_device_scan_agree(monkeypatch):
    """The per-profile scan on the device (ops/scan.py: PyTorch on the CPU
    in the port, the jitted program in the JAX package) and the numpy
    engine give the same integers."""
    def body(p):
        ssn, scanner = _open_scanner(p, monkeypatch)
        try:
            task = scanner.snap.tasks[0]
            monkeypatch.setenv("KUBE_BATCH_TPU_SCAN_DEVICE", "1")
            dev = np.asarray(scanner.scores(task), np.int64)
            monkeypatch.delenv("KUBE_BATCH_TPU_SCAN_DEVICE")
            host = np.asarray(scanner.scores(task), np.int64)
            assert np.array_equal(dev, host)
            return dev.tolist()
        finally:
            p.m.framework.close_session(ssn)
    twin(body)


def test_safe_scores_env_returns_defensive_copy(monkeypatch):
    """KUBE_BATCH_TPU_SAFE_SCORES=1 returns a copy the caller may mutate;
    =0 the live cached view."""
    def body(p):
        ssn, scanner = _open_scanner(p, monkeypatch)
        try:
            task = scanner.snap.tasks[0]
            monkeypatch.setenv("KUBE_BATCH_TPU_SAFE_SCORES", "1")
            s = scanner.scores(task)
            pristine = s.copy()
            # lint: disable=frozen-after (deliberate caller-side abuse: the test proves the cache is isolated from it)
            s[:] = -12345
            again = scanner.scores(task)
            assert np.array_equal(again, pristine)
            assert again is not s
            monkeypatch.setenv("KUBE_BATCH_TPU_SAFE_SCORES", "0")
            live1 = scanner.scores(task)
            live2 = scanner.scores(task)
            assert np.array_equal(live1, pristine)
            assert np.shares_memory(live1, live2)
            monkeypatch.setenv("KUBE_BATCH_TPU_SAFE_SCORES", "1")
            monkeypatch.setenv("KUBE_BATCH_TPU_SCAN_DEVICE", "1")
            dev = scanner.scores(task)
            assert np.array_equal(dev, pristine)
            # lint: disable=frozen-after (deliberate write: proves safe mode returned a defensive copy, not the cache)
            dev[:] = -1
            return pristine.tolist()
        finally:
            monkeypatch.delenv("KUBE_BATCH_TPU_SCAN_DEVICE", raising=False)
            monkeypatch.setenv("KUBE_BATCH_TPU_SAFE_SCORES", "1")
            p.m.framework.close_session(ssn)
    twin(body)


# --- TestShippedPipelineAtScale ----------------------------------------------

def _shipped_pipeline(p, shape, mutate=None):
    with open(os.path.join(REPO, "config", "kube-batch-conf.yaml")) as fh:
        conf = fh.read().replace('"reclaim, allocate, backfill, preempt"',
                                 '"reclaim, tpu-allocate, backfill, '
                                 'preempt"')
    actions, tiers = p.load(conf)
    cache, binder = p.mod.models_synthetic.make_churn_cache(*shape)
    protected = mutate(cache) if mutate is not None else None
    ssn = p.m.framework.open_session(cache, tiers)
    try:
        for a in actions:
            a.execute(ssn)
        pipelined = sum(
            len(j.task_status_index.get(p.m.api.TaskStatus.Pipelined, {}))
            for j in ssn.jobs.values())
        state = session_state(ssn)
    finally:
        p.m.framework.close_session(ssn)
    return (list(cache.evictor.evicts), pipelined, dict(binder.binds),
            state, protected)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_shipped_pipeline_preempts_and_reclaims(mode):
    evicts, pipelined, _, _, _ = twin(
        lambda p: _shipped_pipeline(p, (1200, 200, 60, 4)), x64=MODES[mode])
    assert evicts, "no evictions on a full cluster"
    assert all(key.startswith("churn/low") for key in evicts), evicts[:5]
    assert pipelined > 0
    assert pipelined >= len(evicts) * 0.9


def test_shipped_pipeline_conformance_protects_critical_pods():
    def mark_critical(cache):
        job = next(j for j in cache.jobs.values()
                   if j.name.startswith("low"))
        old_pod = next(iter(job.tasks.values())).pod
        new_pod = dc.replace(old_pod, spec=dc.replace(
            old_pod.spec, priority_class_name="system-cluster-critical"))
        cache.update_pod(old_pod, new_pod)
        return f"{new_pod.metadata.namespace}/{new_pod.metadata.name}"

    evicts, _, _, _, protected = twin(
        lambda p: _shipped_pipeline(p, (600, 100, 30, 4), mark_critical))
    assert evicts
    assert protected not in evicts


# --- tests/test_backfill_scan.py ---------------------------------------------

BACKFILL_SPEC = dict(
    queues=[("q1", 1)],
    pod_groups=[("pg1", "ns", 1, "q1")],
    nodes=[(f"n{i}", "4", "8Gi") for i in range(4)],
    pods=[("ns", "be-0", "", "Pending", "0", "0", "pg1"),
          ("ns", "be-1", "", "Pending", "0", "0", "pg1"),
          ("ns", "p0", "", "Pending", "2", "4Gi", "pg1")])


def test_default_conf_ships_device_action():
    """The default conf loads whole in both packages:
    tpu-allocate, then backfill."""
    assert twin(lambda p: [a.name() for a in p.load()[0]]) == \
        ["tpu-allocate", "backfill"]


def _run_backfill(p, monkeypatch, force_scan, selector=False):
    scanner_mod = p.mod.models_scanner
    monkeypatch.setenv(scanner_mod.SCAN_MIN_NODES_ENV,
                       "0" if force_scan else "99999")
    calls = {"n": 0}
    orig = scanner_mod.DeviceNodeScanner.scores

    def counting(self, task):
        calls["n"] += 1
        return orig(self, task)

    monkeypatch.setattr(scanner_mod.DeviceNodeScanner, "scores", counting)
    try:
        cache, binder, _ = build_cache(BACKFILL_SPEC, p.pkg)
        if selector:
            for node in cache.nodes.values():
                node.node.metadata.labels["name"] = node.name
            for job in cache.jobs.values():
                for t in job.tasks.values():
                    if t.name == "be-1":
                        t.pod.spec.node_selector = {"name": "n2"}
        run(p, cache, "backfill")
    finally:
        monkeypatch.setattr(scanner_mod.DeviceNodeScanner, "scores", orig)
    return dict(binder.binds), calls["n"]


def test_backfill_scanner_matches_host_walk(monkeypatch):
    def body(p):
        return (_run_backfill(p, monkeypatch, False),
                _run_backfill(p, monkeypatch, True))
    (host, host_calls), (scan, scan_calls) = twin(body)
    assert host_calls == 0
    assert scan_calls == 2
    assert scan == host
    assert set(scan) == {"ns/be-0", "ns/be-1"}


def test_backfill_scanner_respects_node_selector(monkeypatch):
    def body(p):
        return [_run_backfill(p, monkeypatch, force, selector=True)[0]
                for force in (False, True)]
    host, scan = twin(body)
    assert scan == host
    assert host["ns/be-1"] == "n2"
