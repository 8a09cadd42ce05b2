"""Auxiliary subsystems, the JAX package against the port, on the CPU.

Twin of tests/test_aux.py, case for case: the PDB legacy gang, the
pressure predicates, unschedulable pod conditions, the cleanup and
resync workers the daemon's cache runs, volume binding, ingest
robustness, the CRD and chart assets, and the node-condition predicate.
Each case runs its body once per package (tests/test_torch_utils.twin)
and both must return the same.
"""

import glob
import os

import pytest
import yaml

from tests.test_torch_utils import (build_node, build_pod,
                                    build_resource_list, twin)
from tests.test_torch_utils import reference_gc_guard  # noqa: F401


def rl(cpu, mem, **kw):
    return build_resource_list(cpu, mem, **kw)


def fresh_cache(p):
    """(cache, binder, status updater) of one package with the fake
    effectors and the ``default`` queue."""
    c = p.m.cache
    binder, status = c.FakeBinder(), c.FakeStatusUpdater()
    cache = c.SchedulerCache(binder=binder, evictor=c.FakeEvictor(),
                             status_updater=status,
                             volume_binder=c.FakeVolumeBinder())
    cache.add_queue(p.queue("default"))
    return cache, binder, status


def pod(p, *args, **kw):
    return build_pod(*args, pkg=p.pkg, **kw)


def node(p, *args, **kw):
    return build_node(*args, pkg=p.pkg, **kw)


def allocate(p, cache, conf=None):
    """One session of the host allocate action under ``conf``."""
    ssn = p.m.framework.open_session(cache, p.tiers(conf))
    try:
        p.action("allocate").execute(ssn)
    finally:
        p.m.framework.close_session(ssn)


def pdb(p, min_available):
    return p.m.objects.PodDisruptionBudget(
        metadata=p.m.api.ObjectMeta(name="legacy", namespace="ns"),
        min_available=min_available)


class TestPDB:
    def test_pdb_drives_gang(self):
        """A PDB's min_available is the gang spec of a job without a
        PodGroup: 3 pods on a 2-cpu node bind nothing."""
        def body(p):
            cache, binder, _ = fresh_cache(p)
            cache.add_node(node(p, "n1", rl("2", "4Gi", pods=10)))
            cache.add_pdb(pdb(p, 3))
            for i in range(3):
                cache.add_pod(pod(p, "ns", f"p{i}", "", "Pending",
                                  rl("1", "1Gi"), "legacy"))
            allocate(p, cache)
            return dict(binder.binds)
        assert twin(body) == {}

    def test_pdb_job_in_snapshot(self):
        def body(p):
            cache, _, _ = fresh_cache(p)
            cache.add_pdb(pdb(p, 1))
            cache.add_pod(pod(p, "ns", "p0", "", "Pending", rl("1", "1Gi"),
                              "legacy"))
            job = cache.snapshot().jobs["ns/legacy"]
            return job.min_available, job.queue
        assert twin(body) == (1, "default")

    def test_delete_pdb_cleans_job(self):
        def body(p):
            cache, _, _ = fresh_cache(p)
            budget = pdb(p, 1)
            cache.add_pdb(budget)
            before = "ns/legacy" in cache.jobs
            cache.delete_pdb(budget)
            return before, "ns/legacy" in cache.jobs
        assert twin(body) == (True, False)


PRESSURE_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: gang
- plugins:
  - name: predicates
    arguments:
      predicate.MemoryPressureEnable: "{}"
"""


class TestPressurePredicates:
    @staticmethod
    def _run(arguments, conditions):
        def body(p):
            cache, binder, _ = fresh_cache(p)
            n = node(p, "n1", rl("8", "8Gi", pods=10))
            n.status.conditions = dict(conditions)
            cache.add_node(n)
            cache.add_pod_group(p.pod_group("pg", "ns", 1, "default"))
            cache.add_pod(pod(p, "ns", "p0", "", "Pending", rl("1", "1Gi"),
                              "pg"))
            allocate(p, cache, PRESSURE_CONF.format(arguments))
            return dict(binder.binds)
        return twin(body)

    def test_pressure_blocks_when_enabled(self):
        assert self._run("true", {"MemoryPressure": "True"}) == {}

    def test_pressure_ignored_by_default(self):
        assert self._run("false", {"MemoryPressure": "True"}) == \
            {"ns/p0": "n1"}


class TestConditionsAndWorkers:
    def test_unschedulable_pod_conditions_written(self):
        def body(p):
            cache, _, status = fresh_cache(p)
            cache.add_node(node(p, "n1", rl("1", "1Gi", pods=10)))
            cache.add_pod_group(p.pod_group("big", "ns", 2, "default"))
            for i in range(2):
                cache.add_pod(pod(p, "ns", f"p{i}", "", "Pending",
                                  rl("4", "4Gi"), "big"))
            allocate(p, cache)
            return sorted({key for key, _ in status.pod_conditions})
        assert twin(body) == ["ns/p0", "ns/p1"]

    def test_cleanup_worker_drops_terminated_jobs(self):
        def body(p):
            cache, _, _ = fresh_cache(p)
            pg = p.pod_group("gone", "ns", 1, "default")
            cache.add_pod_group(pg)
            gone = pod(p, "ns", "p0", "", "Pending", rl("1", "1Gi"), "gone")
            cache.add_pod(gone)
            cache.delete_pod_group(pg)
            kept = "ns/gone" in cache.jobs  # still has the task
            cache.delete_pod(gone)
            cache.process_cleanup_jobs()
            return kept, "ns/gone" in cache.jobs
        assert twin(body) == (True, False)

    def test_resync_worker_refetches_truth(self):
        def body(p):
            v1 = p.m.v1alpha1
            cluster = p.m.cache.Cluster()
            cluster.create_queue(v1.Queue(
                metadata=p.m.api.ObjectMeta(name="default"),
                spec=v1.QueueSpec(weight=1)))
            cache = p.m.cache.new_scheduler_cache(cluster)
            cluster.create_node(node(p, "n1", rl("8", "8Gi", pods=10)))
            cluster.create_pod(pod(p, "ns", "p0", "", "Pending",
                                   rl("1", "1Gi"), "pg"))
            task = list(cache.jobs["ns/pg"].tasks.values())[0]
            cache._resync_task(task)
            cache.process_resync_tasks(cluster)
            return "ns/pg" in cache.jobs, len(cache.jobs["ns/pg"].tasks)
        assert twin(body) == (True, 1)


class TestVolumeBinding:
    @staticmethod
    def _cluster(p):
        v1 = p.m.v1alpha1
        cluster = p.m.cache.Cluster()
        cluster.create_queue(v1.Queue(
            metadata=p.m.api.ObjectMeta(name="default"),
            spec=v1.QueueSpec(weight=1)))
        cluster.create_node(node(p, "n1", rl("8", "8Gi", pods=10)))
        cluster.create_pod_group(p.pod_group("pg", "ns", 1, "default"))
        return cluster

    @staticmethod
    def _scheduler(p, cache):
        if p.pkg == "torch":
            return p.m.scheduler.Scheduler(cache, schedule_period=3600,
                                           device="cpu", dtype=p.dtype)
        return p.m.scheduler.Scheduler(cache, schedule_period=3600)

    @staticmethod
    def _pod(p, volumes):
        vpod = pod(p, "ns", "p0", "", "Pending", rl("1", "1Gi"), "pg")
        vpod.spec.volumes = list(volumes)
        return vpod

    def test_pvc_bound_on_dispatch(self):
        def body(p):
            cluster = self._cluster(p)
            cluster.create_pvc(p.m.objects.PersistentVolumeClaim(
                metadata=p.m.api.ObjectMeta(name="data", namespace="ns")))
            cluster.create_pod(self._pod(p, ["data"]))
            cache = p.m.cache.new_scheduler_cache(cluster)
            self._scheduler(p, cache).run_once()
            pvc = cluster.pvcs["ns/data"]
            return (cluster.pods["ns/p0"].spec.node_name, pvc.phase,
                    pvc.volume_name)
        assert twin(body) == ("n1", "Bound", "pv-data")

    def test_missing_pvc_blocks_allocation(self):
        def body(p):
            cluster = self._cluster(p)
            cluster.create_pod(self._pod(p, ["nope"]))
            cache = p.m.cache.new_scheduler_cache(cluster)
            self._scheduler(p, cache).run_once()
            return cluster.pods["ns/p0"].spec.node_name
        assert twin(body) == ""


class TestIngestRobustness:
    def test_terminated_pod_skips_node_accounting(self):
        """A Succeeded pod still on a node consumes nothing, and its
        delete stays tolerant."""
        def body(p):
            cache, _, _ = fresh_cache(p)
            cache.add_node(node(p, "n1", rl("4", "8Gi", pods=10)))
            cache.add_pod(pod(p, "ns", "done", "n1", "Succeeded",
                              rl("2", "4Gi"), "pg"))
            n = cache.nodes["n1"]
            out = (n.idle.milli_cpu, len(n.tasks))
            cache.delete_pod(pod(p, "ns", "done", "n1", "Succeeded",
                                 rl("2", "4Gi"), "pg"))
            return out
        assert twin(body) == (4000.0, 0)

    def test_malformed_quantity_does_not_crash_informer(self):
        def body(p):
            cache, _, _ = fresh_cache(p)
            cache.add_pod(pod(p, "ns", "bad", "", "Pending",
                              rl("not-a-cpu", "1Gi"), "pg"))
            return (any("ns-bad" == uid for j in cache.jobs.values()
                        for uid in j.tasks),
                    any(e[0] == "FailedParsePod" for e in cache.events))
        assert twin(body) == (False, True)


class TestDeploymentAssets:
    """The install story stays in lockstep with both packages' API
    groups."""

    def test_crd_manifests_match_api_groups(self):
        import kube_batch_tpu.apis.scheduling.v1alpha1 as ref_v1
        import kube_batch_tpu.apis.scheduling.v1alpha2 as ref_v2
        from kube_batch_tpu_torch.apis.scheduling import v1alpha1, v1alpha2
        files = sorted(glob.glob("config/crds/*.yaml"))
        assert len(files) == 4  # PodGroup/Queue x v1alpha1/v1alpha2
        groups = {v1alpha1.VERSION: v1alpha1.GROUP,
                  v1alpha2.VERSION: v1alpha2.GROUP}
        assert groups == {ref_v1.VERSION: ref_v1.GROUP,
                          ref_v2.VERSION: ref_v2.GROUP}
        seen = set()
        for f in files:
            with open(f) as fh:
                crd = yaml.safe_load(fh)
            version = crd["spec"]["version"]
            assert crd["spec"]["group"] == groups[version], f
            kind = crd["spec"]["names"]["kind"]
            assert kind in ("PodGroup", "Queue")
            expected_scope = "Cluster" if kind == "Queue" else "Namespaced"
            assert crd["spec"]["scope"] == expected_scope, f
            seen.add((version, kind))
        assert len(seen) == 4

    def test_chart_ships_crds_and_rbac(self):
        base = "deployment/kube-batch-tpu"
        for path in ("Chart.yaml", "values.yaml", "templates/deployment.yaml",
                     "templates/rbac.yaml", "templates/default.yaml",
                     "crds/scheduling_v1alpha1_podgroup.yaml"):
            assert os.path.exists(os.path.join(base, path)), path


def _ready_case(p, nodes):
    """A cache with ``nodes`` ({name: conditions}) and one pending pod;
    returns (cache, binder)."""
    cache, binder, _ = fresh_cache(p)
    for name, cond in nodes.items():
        n = node(p, name, rl("8", "8Gi", pods=10))
        n.status.conditions = dict(cond)
        cache.add_node(n)
    cache.add_pod_group(p.pod_group("pg", "ns", 1, "default"))
    cache.add_pod(pod(p, "ns", "p0", "", "Pending", rl("1", "1Gi"), "pg"))
    return cache, binder


def _fit_error(p, ssn, task, name):
    try:
        ssn.predicate_fn(task, ssn.nodes[name])
    except p.m.api.FitError as exc:
        return str(exc)
    return None


class TestNodeConditionPredicate:
    def test_not_ready_node_rejects_with_message(self):
        def body(p):
            cache, binder = _ready_case(p, {
                "good": {}, "bad": {"Ready": "False"}})
            ssn = p.m.framework.open_session(cache, p.tiers())
            try:
                task = list(ssn.jobs["ns/pg"].tasks.values())[0]
                bad = _fit_error(p, ssn, task, "bad")
                good = _fit_error(p, ssn, task, "good")
                p.action("allocate").execute(ssn)
            finally:
                p.m.framework.close_session(ssn)
            return bad, good, dict(binder.binds)
        bad, good, binds = twin(body)
        assert "not ready" in bad and good is None
        assert binds == {"ns/p0": "good"}

    def test_network_unavailable_rejects(self):
        def body(p):
            # upstream rejects any reported status != "False", incl.
            # Unknown
            cache, _ = _ready_case(p, {
                "n1": {"NetworkUnavailable": "Unknown"}})
            ssn = p.m.framework.open_session(cache, p.tiers())
            try:
                task = list(ssn.jobs["ns/pg"].tasks.values())[0]
                return _fit_error(p, ssn, task, "n1")
            finally:
                p.m.framework.close_session(ssn)
        assert "unavailable network" in twin(body)


@pytest.fixture(autouse=True)
def _chdir_repo(monkeypatch):
    """The asset paths are relative to the repository root."""
    monkeypatch.chdir(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
