"""The edge cases of four reference suites, over the port's edge
(kube_batch_tpu_torch/edge/) on the CPU, case for case:

- tests/test_batch_commit.py ``TestEdgeWire``: bulk eviction over HTTP
  and the commit flow over a cache wired to the wire edge;
- tests/test_chaos.py ``TestWatchFaults``: the ``watch.*`` chaos sites
  of edge/client.py and the reflectors' start timeout;
- tests/test_lineage.py ``TestEdgeWireLineage`` (:288): a wire run's
  lineage carries the edge's ingest stamp;
- tests/test_memledger.py's edge cases (:213-330): the ``mirror``,
  ``pending`` and ``baseline`` ledgers of a live RemoteCluster and
  ``/debug/memory``.

Schedulers run on the CPU (``device="cpu"``); the harness of
tests/test_torch_e2e.py stands in for tests/test_e2e.py's.
"""

import gc
import json
import time
import urllib.error
import urllib.request

import pytest

from kube_batch_tpu_torch.api import ObjectMeta, TaskStatus
from kube_batch_tpu_torch.apis.scheduling import v1alpha1
from kube_batch_tpu_torch.chaos import plan as chaos_plan
from kube_batch_tpu_torch.framework import close_session, open_session
from kube_batch_tpu_torch.framework.commit import BATCH_COMMIT_ENV
from kube_batch_tpu_torch.metrics import memledger, metrics
from kube_batch_tpu_torch.scheduler import (DEFAULT_SCHEDULER_CONF,
                                            load_scheduler_conf)
from kube_batch_tpu_torch.trace import pod_lineage
from kube_batch_tpu_torch.metrics.tenants import tenant_table
from tests.test_torch_utils import (Loop, build_node, build_pod,
                                    build_resource_list)


@pytest.fixture(autouse=True)
def _register(monkeypatch):
    from kube_batch_tpu_torch.actions.factory import register_default_actions
    from kube_batch_tpu_torch.plugins.factory import register_default_plugins
    register_default_actions(device="cpu")
    register_default_plugins()
    monkeypatch.setenv("KUBE_BATCH_TPU_SCAN_MIN_NODES", "0")
    pod_lineage.refresh()
    tenant_table.clear()
    yield
    chaos_plan.disable()
    pod_lineage.refresh()
    tenant_table.clear()
    gc.unfreeze()


def _wait(predicate, timeout=10.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


# ----------------------------------------------------------------------
# tests/test_batch_commit.py: bulk egress over the wire


class TestEdgeWire:
    """The bulk egress over the real HTTP edge: evict_pods_many (the
    bind_pods_many twin) and the ClusterEvictor delegation."""

    @pytest.fixture()
    def api(self):
        from kube_batch_tpu_torch.cache.cluster import Cluster
        from kube_batch_tpu_torch.edge import ApiServer
        cluster = Cluster()
        server = ApiServer(cluster).start()
        yield cluster, server
        server.stop()

    def _seed(self, cluster, n):
        cluster.create_node(build_node(
            "n0", build_resource_list(str(n), f"{n}Gi", pods=2 * n)))
        for i in range(n):
            cluster.create_pod(build_pod(
                "ns", f"p{i}", "n0", "Running",
                build_resource_list("1", "1Gi")))

    def test_bulk_evict_lands_server_side(self, api):
        from kube_batch_tpu_torch.edge import RemoteCluster
        cluster, server = api
        self._seed(cluster, 12)
        remote = RemoteCluster(server.url).start()
        try:
            with remote.lock:
                pods = [remote.pods[f"ns/p{i}"] for i in range(12)]
            failures = remote.evict_pods_many(pods, workers=4)
        finally:
            remote.stop()
        assert failures == []
        with cluster.lock:
            assert not cluster.pods

    def test_per_evict_failure_isolation(self, api):
        from kube_batch_tpu_torch.edge import RemoteCluster
        cluster, server = api
        self._seed(cluster, 5)
        remote = RemoteCluster(server.url).start()
        try:
            with remote.lock:
                pods = [remote.pods[f"ns/p{i}"] for i in range(5)]
            ghost = build_pod("ns", "ghost", "", "Running",
                              build_resource_list("1", "1Gi"))
            failures = remote.evict_pods_many(
                pods[:2] + [ghost] + pods[2:], workers=3)
        finally:
            remote.stop()
        assert len(failures) == 1
        assert failures[0][0].metadata.name == "ghost"
        with cluster.lock:
            assert not cluster.pods

    def test_cluster_evictor_delegates(self, api):
        from kube_batch_tpu_torch.cache.cluster import ClusterEvictor
        from kube_batch_tpu_torch.edge import RemoteCluster
        cluster, server = api
        self._seed(cluster, 4)
        remote = RemoteCluster(server.url).start()
        try:
            with remote.lock:
                pods = [remote.pods[f"ns/p{i}"] for i in range(4)]
            assert ClusterEvictor(remote).evict_many(pods) == []
        finally:
            remote.stop()
        with cluster.lock:
            assert not cluster.pods

    def test_edge_commit_flow_parity(self, monkeypatch):
        """The real commit machinery (Statement accumulate -> per-action
        flush) over a SchedulerCache wired to the wire edge: batched
        and sequential arms evict the same pods from server-side truth
        in the same order, with identical local event streams."""
        import time as _time

        from kube_batch_tpu_torch.cache.cluster import (Cluster,
                                                        new_scheduler_cache)
        from kube_batch_tpu_torch.edge import ApiServer, RemoteCluster
        from kube_batch_tpu_torch.framework.commit import action_commit
        results = {}
        for arm in ("0", "1"):
            monkeypatch.setenv(BATCH_COMMIT_ENV, arm)
            cluster = Cluster()
            server = ApiServer(cluster).start()
            remote = RemoteCluster(server.url).start()
            try:
                cache = new_scheduler_cache(remote)
                cluster.create_queue(v1alpha1.Queue(
                    metadata=ObjectMeta(name="default"),
                    spec=v1alpha1.QueueSpec(weight=1)))
                cluster.create_node(build_node(
                    "n0", build_resource_list("8", "16Gi", pods=110)))
                cluster.create_pod_group(v1alpha1.PodGroup(
                    metadata=ObjectMeta(name="low", namespace="ns"),
                    spec=v1alpha1.PodGroupSpec(min_member=1)))
                for k in range(4):
                    cluster.create_pod(build_pod(
                        "ns", f"lo{k}", "n0", "Running",
                        build_resource_list("2", "4Gi"), "low",
                        priority=1, ts=float(k)))
                deadline = _time.time() + 10.0
                while _time.time() < deadline:
                    with cache.mutex:
                        job = cache.jobs.get("ns/low")
                        n_tasks = len(job.tasks) if job is not None else 0
                    if n_tasks == 4:
                        break
                    _time.sleep(0.02)
                _, tiers = load_scheduler_conf(DEFAULT_SCHEDULER_CONF)
                ssn = open_session(cache, tiers)
                try:
                    victims = sorted(
                        (t for job in ssn.jobs.values()
                         for t in job.tasks.values()
                         if t.status == TaskStatus.Running),
                        key=lambda t: t.name)
                    assert len(victims) == 4
                    with action_commit(ssn, "preempt"):
                        stmt = ssn.statement()
                        for v in victims:
                            stmt.evict(v, "preempt")
                        stmt.commit()
                finally:
                    close_session(ssn)
                deadline = _time.time() + 5.0
                while _time.time() < deadline:
                    with cluster.lock:
                        if not cluster.pods:
                            break
                    _time.sleep(0.02)
                with cluster.lock:
                    results[arm] = sorted(cluster.pods)
                results[arm + "_events"] = [
                    e for e in cache.events if e[0] == "Evict"]
            finally:
                remote.stop()
                server.stop()
        assert results["1"] == results["0"] == []
        assert results["1_events"] == results["0_events"]
        assert len(results["0_events"]) == 4


class TestWatchFaults:
    def test_watch_survives_faults_and_reconverges(self):
        from kube_batch_tpu_torch.apis.scheduling import v1alpha1
        from kube_batch_tpu_torch.api import ObjectMeta
        from kube_batch_tpu_torch.cache import Cluster
        from kube_batch_tpu_torch.edge import ApiServer, RemoteCluster
        from tests.test_torch_e2e import mk_pod as e2e_pod

        def mk_pod(name, group):
            return e2e_pod(Loop("torch"), name, group)

        cluster = Cluster()
        cluster.create_queue(v1alpha1.Queue(
            metadata=ObjectMeta(name="q1"),
            spec=v1alpha1.QueueSpec(weight=1)))
        for i in range(4):
            cluster.create_pod(mk_pod(f"seed-{i}", "g"))
        server = ApiServer(cluster).start()
        before = sum(metrics.watch_reconnects.values().values())
        chaos_plan.install(chaos_plan.FaultPlan(
            seed=6, rate=0.25, sites=("watch.*",), budget=24))
        remote = None
        try:
            remote = RemoteCluster(server.url).start(timeout=60)
            for i in range(4):
                cluster.create_pod(mk_pod(f"late-{i}", "g"))
            deadline = time.time() + 20
            want = set(cluster.pods)
            while time.time() < deadline:
                with remote.lock:
                    got = set(remote.pods)
                if got == want:
                    break
                time.sleep(0.05)
            assert got == want, f"mirror never converged: {got ^ want}"
            # The storm actually exercised the reconnect path.
            assert sum(metrics.watch_reconnects.values().values()) > before
        finally:
            chaos_plan.disable()
            if remote is not None:
                remote.stop()
            server.stop()

    def test_start_timeout_names_resource_and_joins_reflectors(self):
        from kube_batch_tpu_torch.edge import RemoteCluster
        remote = RemoteCluster("http://127.0.0.1:9", timeout=0.2)
        with pytest.raises(TimeoutError) as excinfo:
            remote.start(timeout=0.6)
        assert "pods" in str(excinfo.value)  # names what never synced
        for t in remote._threads:
            assert not t.is_alive()  # stopped and joined, not leaked


# ----------------------------------------------------------------------
# pod lineage under chaos (doc/OBSERVABILITY.md): watch faults, resync,
# and ambiguous binds must not corrupt the time-to-bind SLO


def _slo_samples():
    """{queue: count} + total of kube_batch_slo_time_to_bind_seconds."""
    with metrics.slo_time_to_bind._lock:
        per = {labels[0]: n for labels, n
               in metrics.slo_time_to_bind._totals.items() if labels}
    return per, sum(per.values())


class TestEdgeWireLineage:
    def test_wire_run_yields_edge_stamped_lineage(self):
        from kube_batch_tpu_torch.api import ObjectMeta
        from kube_batch_tpu_torch.apis.scheduling import v1alpha1
        from kube_batch_tpu_torch.cache import Cluster, new_scheduler_cache
        from kube_batch_tpu_torch.edge import ApiServer, RemoteCluster
        from kube_batch_tpu_torch.scheduler import (DEFAULT_SCHEDULER_CONF,
                                                    Scheduler)
        from tests.test_torch_utils import (build_node, build_pod,
                                      build_resource_list)

        cluster = Cluster()
        server = ApiServer(cluster).start()
        remote = None
        sched = None
        try:
            cluster.create_node(build_node(
                "n0", build_resource_list("8", "16Gi", pods=110)))
            cluster.create_queue(v1alpha1.Queue(
                metadata=ObjectMeta(name="default"),
                spec=v1alpha1.QueueSpec(weight=1)))
            cluster.create_pod_group(v1alpha1.PodGroup(
                metadata=ObjectMeta(name="pg1", namespace="ns"),
                spec=v1alpha1.PodGroupSpec(min_member=2, queue="default")))
            remote = RemoteCluster(server.url).start()
            cache = new_scheduler_cache(remote)
            sched = Scheduler(cache, device="cpu", scheduler_conf=DEFAULT_SCHEDULER_CONF
                              .replace('"allocate, backfill"',
                                       '"tpu-allocate, backfill"'),
                              schedule_period=0.05)
            sched.run()
            for i in range(2):
                remote.create_pod(build_pod(
                    "ns", f"p{i}", "", "Pending",
                    build_resource_list("2", "4Gi"), "pg1"))
            deadline = time.time() + 30
            lin = None
            while time.time() < deadline:
                lin = pod_lineage.lineage("ns/p0")
                if lin is not None and lin.get("bound") and any(
                        s["stage"] == "echo" for s in lin["stages"]):
                    break
                time.sleep(0.1)
        finally:
            if sched is not None:
                sched.stop()
            if remote is not None:
                remote.stop()
            server.stop()
        assert lin is not None and lin["bound"], lin
        stages = {s["stage"]: s for s in lin["stages"]}
        # The wire run's ingest carries the EDGE decode stamp.
        assert stages["ingest"].get("detail") == "edge"
        for want in ("ingest", "considered", "placed", "bind_sent",
                     "bound", "echo"):
            assert want in stages, (want, sorted(stages))
        assert lin["time_to_bind_s"] >= 0
        # Ingest precedes everything else on the shared monotonic clock.
        assert all(s["t_rel_s"] >= 0 for s in lin["stages"])


# the HTTP edge: mirror / pending / baseline components


@pytest.fixture()
def live_edge():
    from kube_batch_tpu_torch.api import ObjectMeta
    from kube_batch_tpu_torch.apis.scheduling import v1alpha1
    from kube_batch_tpu_torch.cache import Cluster
    from kube_batch_tpu_torch.edge import ApiServer, RemoteCluster
    cluster = Cluster()
    cluster.create_queue(v1alpha1.Queue(
        metadata=ObjectMeta(name="default"),
        spec=v1alpha1.QueueSpec(weight=1)))
    cluster.create_pod_group(v1alpha1.PodGroup(
        metadata=ObjectMeta(name="pg1", namespace="ns"),
        spec=v1alpha1.PodGroupSpec(min_member=1, queue="default")))
    server = ApiServer(cluster).start()
    remote = RemoteCluster(server.url).start()
    yield cluster, remote
    remote.stop()
    server.stop()


def _mk_pod(name):
    from tests.test_torch_utils import build_pod, build_resource_list
    labels = {f"pad.example.com/key-{i}": f"value-{i:032d}"
              for i in range(20)}
    return build_pod("ns", name, "", "Pending",
                     build_resource_list("1", "1Gi"), "pg1", labels=labels)


class TestEdgeLedgers:
    def test_mirror_and_baseline_account_and_release(self, live_edge):
        cluster, remote = live_edge
        from kube_batch_tpu_torch.edge.client import _MIRROR_OBJ_EST
        mirror = memledger.ledger("mirror")
        baseline = memledger.ledger("baseline")
        base_m = mirror.total()
        base_b = baseline.total()
        for i in range(6):
            cluster.create_pod(_mk_pod(f"p{i}"))
        _wait(lambda: len(remote.pods) == 6, msg="pods mirrored")
        # The queue + podgroup were mirrored at start(); the six pods are
        # the only growth since base_m was read.
        grown_m = mirror.total() - base_m
        assert grown_m == 6 * _MIRROR_OBJ_EST, grown_m
        assert baseline.total() > base_b
        # This remote's baseline component equals its own per-kind
        # ledger — the accounting is per-store, not a global smear.
        with baseline._lock:
            component = baseline._components[remote._mem_baseline]
        assert component == sum(remote.wire_baseline_bytes().values())
        memledger.audit_mem_ledgers()
        # Drain: deletes release mirror shells and retained baselines.
        for i in range(6):
            cluster.delete_pod("ns", f"p{i}")
        _wait(lambda: len(remote.pods) == 0, msg="mirror drained")
        assert mirror.total() == base_m
        memledger.audit_mem_ledgers()

    def test_baseline_gauge_parity(self, live_edge):
        """kube_batch_tpu_mem_bytes{ledger="baseline"} tracks the ledger
        exactly (publish granularity 0), alongside the pre-existing
        kube_batch_wire_baseline_bytes surface it generalizes."""
        cluster, remote = live_edge
        for i in range(4):
            cluster.create_pod(_mk_pod(f"g{i}"))
        _wait(lambda: len(remote.pods) == 4, msg="pods mirrored")
        led_total = memledger.ledger("baseline").total()
        gauge = metrics.mem_bytes.values().get(("baseline",))
        assert gauge is not None and int(gauge) == led_total
        wm, _sid = memledger.ledger("baseline").watermark()
        wm_gauge = metrics.mem_watermark.values().get(("baseline",))
        assert wm_gauge is not None and int(wm_gauge) == wm


# ----------------------------------------------------------------------
# /debug/memory over a live server


class TestDebugMemoryEndpoint:
    def test_endpoint_and_index(self, live_edge):
        from kube_batch_tpu_torch.cli.server import start_metrics_server
        from tests.test_torch_e2e import CONF_TPU
        from tests.test_torch_e2e import Harness as LoopHarness

        def Harness(conf):
            return LoopHarness(Loop("torch"), conf=conf)
        cluster, remote = live_edge
        cluster.create_pod(_mk_pod("dbg0"))
        _wait(lambda: len(remote.pods) == 1, msg="pod mirrored")
        h = Harness(conf=CONF_TPU)
        h.add_nodes(2)
        h.create_job("j", 2, 2)
        h.cycle()
        server = start_metrics_server("127.0.0.1:0")
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            status, index = _get(f"{base}/debug")
            assert status == 200
            assert "/debug/memory" in index["endpoints"]
            status, doc = _get(f"{base}/debug/memory")
            assert status == 200
            table = doc["ledgers"]
            assert set(table) == {n for n, _ in
                                  memledger.LEDGER_CATALOGUE}
            # The acceptance floor: at least 10 ledgers have a live
            # registered component once an edge and a scheduler ran.
            registered = [n for n, row in table.items()
                          if row["components"] > 0]
            assert len(registered) >= 10, sorted(registered)
            for row in table.values():
                assert row["watermark_bytes"] >= row["bytes"] >= 0
                assert row["what"]
            assert doc["total_bytes"] == sum(
                row["bytes"] for row in table.values())
            assert doc["rss_bytes"] and doc["rss_bytes"] > 0
            assert doc["tracemalloc"] is None   # MEMTRACE unset
        finally:
            server.shutdown()


