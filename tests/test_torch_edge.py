"""Network-edge tests: the scheduler driving a cluster over HTTP.

Closes VERDICT r1 'What's missing' #4: a network-facing implementation of
the informer/effector boundary, so the framework schedules state living in
another process.  These tests run the ApiServer in-process but talk to it
exclusively through its HTTP surface.

Twin of tests/test_edge.py, all 18 cases, over the port's package
(kube_batch_tpu_torch/edge/, client/, cli/) on the CPU: schedulers and
runtimes are built with ``device="cpu"``.
"""

import gc
import json
import time

import pytest

from kube_batch_tpu_torch.api import ObjectMeta
from kube_batch_tpu_torch.apis.scheduling import v1alpha1
from kube_batch_tpu_torch.cache import Cluster, new_scheduler_cache
from kube_batch_tpu_torch.edge import ApiServer, RemoteCluster
from kube_batch_tpu_torch.edge.codec import decode, encode
from kube_batch_tpu_torch.scheduler import DEFAULT_SCHEDULER_CONF, Scheduler
from tests.test_torch_utils import build_node, build_pod, build_resource_list


@pytest.fixture(autouse=True)
def _unfreeze():
    """Scheduler.run() freezes the collector's view of the synced cache;
    undo it after each case."""
    yield
    gc.unfreeze()



@pytest.fixture()
def api():
    cluster = Cluster()
    server = ApiServer(cluster).start()
    yield cluster, server
    server.stop()


class TestCodec:
    def test_pod_round_trip(self):
        from kube_batch_tpu_torch.api.objects import Affinity, ContainerPort
        pod = build_pod("ns", "p0", "n1", "Running",
                        build_resource_list("2", "4Gi"), "pg1",
                        labels={"app": "web"})
        pod.spec.containers[0].ports = [ContainerPort(host_port=80)]
        pod.spec.affinity = Affinity(
            required_pod_anti_affinity=[{"app": "web"}],
            preferred_pod_affinity=[(10, {"tier": "db"})])
        back = decode(encode(pod))
        assert back.metadata.name == "p0"
        assert back.spec.node_name == "n1"
        assert back.spec.containers[0].requests == {"cpu": "2",
                                                    "memory": "4Gi"}
        assert back.spec.containers[0].ports[0].host_port == 80
        assert back.spec.affinity.required_pod_anti_affinity == [{"app": "web"}]
        w, sel = back.spec.affinity.preferred_pod_affinity[0]
        assert (w, sel) == (10, {"tier": "db"})

    def test_decode_bare_list_copies_and_keeps_none(self):
        """ADVICE r5 #1 regression: the untyped-list decode fast path must
        COPY (not alias the wire doc) and pass None through — a null
        element inside a nested List[List[T]] decodes to None instead of
        raising via list(None)."""
        from typing import List

        from kube_batch_tpu_torch.edge.codec import _decoder_for

        bare = _decoder_for(list)
        src = [1, 2]
        out = bare(src)
        assert out == src and out is not src
        assert bare(None) is None
        assert bare((1, 2)) == [1, 2]

        nested = _decoder_for(List[List[int]])
        assert nested([[1], None, [2, 3]]) == [[1], None, [2, 3]]

    def test_decode_plain_list_field_does_not_alias_doc(self):
        pod = build_pod("ns", "p1", "n1", "Pending",
                        build_resource_list("1", "1Gi"), "pg1")
        pod.spec.volumes = ["vol-a", "vol-b"]
        doc = encode(pod)
        back = decode(doc)
        assert back.spec.volumes == ["vol-a", "vol-b"]
        # mutating the decoded object must not write through to the doc
        back.spec.volumes.append("vol-c")
        assert doc["spec"]["volumes"] == ["vol-a", "vol-b"]

    def test_crd_versions_distinct(self):
        from kube_batch_tpu_torch.apis.scheduling import v1alpha2
        pg1 = v1alpha1.PodGroup(metadata=ObjectMeta(name="a", namespace="ns"),
                                spec=v1alpha1.PodGroupSpec(min_member=2))
        pg2 = v1alpha2.PodGroup(metadata=ObjectMeta(name="a", namespace="ns"),
                                spec=v1alpha2.PodGroupSpec(min_member=2))
        assert isinstance(decode(encode(pg1)), v1alpha1.PodGroup)
        assert isinstance(decode(encode(pg2)), v1alpha2.PodGroup)


class TestRemoteCluster:
    def test_watch_streams_existing_and_live_objects(self, api):
        cluster, server = api
        cluster.create_node(build_node("n0", build_resource_list(
            "8", "16Gi", pods=110)))
        remote = RemoteCluster(server.url).start()
        try:
            assert "n0" in remote.nodes  # initial list
            cluster.create_node(build_node("n1", build_resource_list(
                "8", "16Gi", pods=110)))
            deadline = time.time() + 10
            while time.time() < deadline and "n1" not in remote.nodes:
                time.sleep(0.05)
            assert "n1" in remote.nodes  # live event
        finally:
            remote.stop()

    def test_effector_verbs_round_trip(self, api):
        cluster, server = api
        cluster.create_node(build_node("n0", build_resource_list(
            "8", "16Gi", pods=110)))
        remote = RemoteCluster(server.url).start()
        try:
            remote.create_pod(build_pod("ns", "p0", "", "Pending",
                                        build_resource_list("1", "1Gi"),
                                        "pg"))
            assert cluster.get_pod("ns", "p0") is not None
            remote.bind_pod("ns", "p0", "n0")
            assert cluster.get_pod("ns", "p0").spec.node_name == "n0"
            remote.delete_pod("ns", "p0")
            assert cluster.get_pod("ns", "p0") is None
        finally:
            remote.stop()


class TestSchedulerOverTheEdge:
    def test_gang_scheduled_through_http(self, api):
        cluster, server = api
        # Seed the cluster server-side (any API client could do this).
        for i in range(2):
            cluster.create_node(build_node(
                f"n{i}", build_resource_list("8", "16Gi", pods=110)))
        cluster.create_queue(v1alpha1.Queue(
            metadata=ObjectMeta(name="default"),
            spec=v1alpha1.QueueSpec(weight=1)))
        cluster.create_pod_group(v1alpha1.PodGroup(
            metadata=ObjectMeta(name="pg1", namespace="ns"),
            spec=v1alpha1.PodGroupSpec(min_member=3, queue="default")))

        # The scheduler's ONLY connection to the cluster is the HTTP edge.
        remote = RemoteCluster(server.url).start()
        cache = new_scheduler_cache(remote)
        sched = Scheduler(cache, device="cpu", scheduler_conf=DEFAULT_SCHEDULER_CONF
                          .replace('"allocate, backfill"',
                                   '"tpu-allocate, backfill"'),
                          schedule_period=0.05)
        sched.run()
        try:
            for i in range(3):
                remote.create_pod(build_pod(
                    "ns", f"p{i}", "", "Pending",
                    build_resource_list("2", "4Gi"), "pg1"))
            deadline = time.time() + 30
            while time.time() < deadline:
                with cluster.lock:
                    bound = [p for p in cluster.pods.values()
                             if p.spec.node_name]
                if len(bound) == 3:
                    break
                time.sleep(0.1)
        finally:
            sched.stop()
            remote.stop()
        with cluster.lock:
            binds = {k: p.spec.node_name for k, p in cluster.pods.items()}
            phases = {k: p.status.phase for k, p in cluster.pods.items()}
            pg = cluster.pod_groups["ns/pg1"]
        assert all(binds.values()), binds
        assert all(ph == "Running" for ph in phases.values()), phases
        assert pg.status.phase == "Running"

    def test_gang_blocked_writes_condition_through_http(self, api):
        cluster, server = api
        cluster.create_node(build_node("n0", build_resource_list(
            "2", "4Gi", pods=110)))
        cluster.create_queue(v1alpha1.Queue(
            metadata=ObjectMeta(name="default"),
            spec=v1alpha1.QueueSpec(weight=1)))
        cluster.create_pod_group(v1alpha1.PodGroup(
            metadata=ObjectMeta(name="stuck", namespace="ns"),
            spec=v1alpha1.PodGroupSpec(min_member=3, queue="default")))
        remote = RemoteCluster(server.url).start()
        cache = new_scheduler_cache(remote)
        sched = Scheduler(cache, device="cpu", scheduler_conf=DEFAULT_SCHEDULER_CONF,
                          schedule_period=0.05)
        sched.run()
        try:
            for i in range(3):
                remote.create_pod(build_pod(
                    "ns", f"p{i}", "", "Pending",
                    build_resource_list("2", "4Gi"), "stuck"))
            deadline = time.time() + 30
            conditions = []
            while time.time() < deadline:
                with cluster.lock:
                    pg = cluster.pod_groups["ns/stuck"]
                    conditions = list(pg.status.conditions or [])
                if conditions:
                    break
                time.sleep(0.1)
        finally:
            sched.stop()
            remote.stop()
        assert any(c.type == v1alpha1.PodGroupUnschedulableType
                   for c in conditions), conditions
        with cluster.lock:
            assert not any(p.spec.node_name for p in cluster.pods.values())


class TestReflectorResilience:
    def test_reconnect_reconciles_deletions(self):
        """Objects deleted while the watch is down must be pruned at relist
        (client-go reflector semantics)."""
        cluster = Cluster()
        server = ApiServer(cluster).start()
        cluster.create_node(build_node("n0", build_resource_list(
            "8", "16Gi", pods=110)))
        cluster.create_node(build_node("gone", build_resource_list(
            "8", "16Gi", pods=110)))
        remote = RemoteCluster(server.url).start()
        try:
            assert set(remote.nodes) == {"n0", "gone"}
            deletes = []
            remote.node_informer.add_handlers(
                on_delete=lambda o: deletes.append(o.name))
            # Kill the server (watch drops), delete a node, restart on the
            # SAME port so the reflector reconnects.
            host, port = server._httpd.server_address[:2]
            server.stop()
            cluster.delete_node("gone")
            cluster.create_node(build_node("fresh", build_resource_list(
                "4", "8Gi", pods=110)))
            server2 = ApiServer(cluster, host=host, port=port).start()
            try:
                deadline = time.time() + 15
                while time.time() < deadline:
                    with remote.lock:
                        if ("gone" not in remote.nodes
                                and "fresh" in remote.nodes):
                            break
                    time.sleep(0.05)
                with remote.lock:
                    assert set(remote.nodes) == {"n0", "fresh"}
                assert "gone" in deletes  # fire_delete reached handlers
            finally:
                server2.stop()
        finally:
            remote.stop()


class TestClientsetOverTheEdge:
    def test_typed_crud_over_http(self, api):
        """The typed clientset (reference pkg/client analog) works against
        the RemoteCluster exactly as against the in-process store."""
        from kube_batch_tpu_torch.client import new_for_cluster
        cluster, server = api
        remote = RemoteCluster(server.url).start()
        try:
            cs = new_for_cluster(remote)
            pgs = cs.scheduling_v1alpha1.pod_groups("ns")
            pgs.create(v1alpha1.PodGroup(
                metadata=ObjectMeta(name="pg1", namespace="ns"),
                spec=v1alpha1.PodGroupSpec(min_member=3, queue="default")))
            # Server saw it; the reflector mirror converges for reads.
            assert cluster.pod_groups["ns/pg1"].spec.min_member == 3
            deadline = time.time() + 10
            while time.time() < deadline:
                try:
                    if pgs.get("pg1").spec.min_member == 3:
                        break
                except KeyError:
                    pass
                time.sleep(0.05)
            got = pgs.get("pg1")
            got.spec.min_member = 5
            pgs.update(got)
            assert cluster.pod_groups["ns/pg1"].spec.min_member == 5
            queues = cs.scheduling_v1alpha1.queues()
            queues.create(v1alpha1.Queue(
                metadata=ObjectMeta(name="q9"),
                spec=v1alpha1.QueueSpec(weight=4)))
            assert cluster.queues["q9"].spec.weight == 4
            pgs.delete("pg1")
            assert "ns/pg1" not in cluster.pod_groups
            queues.delete("q9")
            assert "q9" not in cluster.queues
        finally:
            remote.stop()


class TestEgressChain:
    """VERDICT r2 next #2: the observability egress completes the last
    hop — pod conditions and events reach the REMOTE store over HTTP."""

    def test_stuck_gang_pod_conditions_and_events_over_http(self, api):
        cluster, server = api
        cluster.create_node(build_node("n0", build_resource_list(
            "2", "4Gi", pods=110)))
        cluster.create_queue(v1alpha1.Queue(
            metadata=ObjectMeta(name="default"),
            spec=v1alpha1.QueueSpec(weight=1)))
        cluster.create_pod_group(v1alpha1.PodGroup(
            metadata=ObjectMeta(name="stuck", namespace="ns"),
            spec=v1alpha1.PodGroupSpec(min_member=3, queue="default")))
        remote = RemoteCluster(server.url).start()
        cache = new_scheduler_cache(remote)
        sched = Scheduler(cache, device="cpu", schedule_period=0.05)
        sched.run()
        try:
            for i in range(3):
                remote.create_pod(build_pod(
                    "ns", f"p{i}", "", "Pending",
                    build_resource_list("2", "4Gi"), "stuck"))
            deadline = time.time() + 30
            conds, events = [], []
            while time.time() < deadline:
                with cluster.lock:
                    pod = cluster.pods.get("ns/p0")
                    conds = list(pod.status.conditions) if pod else []
                    events = cluster.events.values()
                if conds and any(e.reason == "FailedScheduling"
                                 for e in events):
                    break
                time.sleep(0.1)
        finally:
            sched.stop()
            remote.stop()
        # Pod condition written through the status subresource.
        assert any(c.type == "PodScheduled" and c.status == "False"
                   and c.reason == "Unschedulable" for c in conds), conds
        # FailedScheduling events listable in the remote store, and over
        # plain HTTP (GET /v1/events) as any operator tooling would.
        failed = [e for e in events if e.reason == "FailedScheduling"]
        assert failed and failed[0].type == "Warning"
        import json as _json
        import urllib.request
        with urllib.request.urlopen(f"{server.url}/v1/events",
                                    timeout=5) as resp:
            listed = _json.loads(resp.read())["items"]
        assert any(doc["reason"] == "FailedScheduling" for doc in listed)

    def test_pod_status_subresource_direct(self, api):
        from kube_batch_tpu_torch.api import PodCondition
        cluster, server = api
        cluster.create_pod(build_pod("ns", "p0", "", "Pending",
                                     build_resource_list("1", "1Gi"), "pg"))
        remote = RemoteCluster(server.url)
        remote.update_pod_condition("ns", "p0", PodCondition(
            type="PodScheduled", status="False", reason="Unschedulable",
            message="0 nodes"))
        pod = cluster.get_pod("ns", "p0")
        assert pod.status.conditions[0].reason == "Unschedulable"
        # Missing pod -> 404 surfaced as KeyError.
        import pytest as _pytest
        with _pytest.raises(KeyError):
            remote.update_pod_condition("ns", "ghost", PodCondition(
                type="PodScheduled", status="False"))


class TestWatchResume:
    """resourceVersion watch resume (k8s list+watch contract): reconnects
    replay only the missed delta; falling past the event buffer (or a
    server restart) yields ERROR 410 and a full relist."""

    def _read_frames(self, resp, until_types, limit=50):
        frames = []
        for raw in resp:
            frame = json.loads(raw)
            frames.append(frame)
            if frame["type"] in until_types or len(frames) >= limit:
                break
        return frames

    def test_resume_replays_only_the_delta(self, api):
        import urllib.request
        cluster, server = api
        cluster.create_node(build_node("n0", build_resource_list(
            "8", "16Gi", pods=110)))
        with urllib.request.urlopen(f"{server.url}/v1/nodes?watch=1",
                                    timeout=5) as resp:
            frames = self._read_frames(resp, {"SYNC"})
        assert [f["type"] for f in frames] == ["ADDED", "SYNC"]
        rv = frames[-1]["rv"]
        # Changes while disconnected...
        cluster.create_node(build_node("n1", build_resource_list(
            "8", "16Gi", pods=110)))
        cluster.delete_node("n0")
        # ...reconnect with the last seen rv: delta only, no ADDED replay.
        # Stop at the DELETED frame: waiting for the 5 s keepalive PING
        # races the client socket timeout (flaky).
        with urllib.request.urlopen(
                f"{server.url}/v1/nodes?watch=1&resourceVersion={rv}",
                timeout=10) as resp:
            frames = self._read_frames(resp, {"DELETED", "PING"})
        types = [f["type"] for f in frames]
        assert types[0] == "RESUMED"
        assert types[1:3] == ["ADDED", "DELETED"]
        assert frames[1]["object"]["metadata"]["name"] == "n1"
        assert all(f["rv"] > rv for f in frames[1:3])

    def test_restarted_server_sends_410(self, api):
        import urllib.request
        cluster, server = api
        cluster.create_node(build_node("n0", build_resource_list(
            "8", "16Gi", pods=110)))
        with urllib.request.urlopen(f"{server.url}/v1/nodes?watch=1",
                                    timeout=5) as resp:
            frames = self._read_frames(resp, {"SYNC"})
        rv = frames[-1]["rv"]
        host, port = server._httpd.server_address[:2]
        server.stop()
        server2 = ApiServer(cluster, host=host, port=port).start()
        try:
            with urllib.request.urlopen(
                    f"{server2.url}/v1/nodes?watch=1&resourceVersion={rv}",
                    timeout=5) as resp:
                frames = self._read_frames(resp, {"ERROR", "PING"})
            assert frames[-1]["type"] == "ERROR"
            assert frames[-1]["object"]["code"] == 410
        finally:
            server2.stop()


class TestConcurrentBindEgress:
    """bind_pods_many: the goroutine-per-bind analog — a worker pool of
    keep-alive connections (cache.go:491-535's concurrent bind fan-out)."""

    def _seed(self, cluster, n):
        cluster.create_node(build_node(
            "n0", build_resource_list(str(n), f"{n}Gi", pods=2 * n)))
        for i in range(n):
            cluster.create_pod(build_pod(
                "ns", f"p{i}", "", "Pending",
                build_resource_list("1", "1Gi")))

    @pytest.mark.parametrize("wire", ["native", "k8s"])
    def test_bulk_bind_lands_server_side(self, api, wire):
        cluster, server = api
        self._seed(cluster, 20)
        remote = RemoteCluster(server.url, wire=wire).start()
        try:
            with remote.lock:
                pods = [remote.pods[f"ns/p{i}"] for i in range(20)]
            failures = remote.bind_pods_many(
                [(p, "n0") for p in pods], workers=4)
        finally:
            remote.stop()
        assert failures == []
        with cluster.lock:
            assert all(p.spec.node_name == "n0"
                       for p in cluster.pods.values())

    def test_per_bind_failure_isolation(self, api):
        """One missing pod fails alone; every other bind still lands —
        the same isolation Binder.bind_many's serial default gives."""
        cluster, server = api
        self._seed(cluster, 6)
        remote = RemoteCluster(server.url).start()
        try:
            with remote.lock:
                pods = [remote.pods[f"ns/p{i}"] for i in range(6)]
            ghost = build_pod("ns", "ghost", "", "Pending",
                              build_resource_list("1", "1Gi"))
            failures = remote.bind_pods_many(
                [(p, "n0") for p in pods[:3]] + [(ghost, "n0")]
                + [(p, "n0") for p in pods[3:]], workers=3)
        finally:
            remote.stop()
        assert len(failures) == 1
        assert failures[0][0].metadata.name == "ghost"
        with cluster.lock:
            bound = [p for p in cluster.pods.values() if p.spec.node_name]
        assert len(bound) == 6

    def test_cluster_binder_delegates(self, api):
        """ClusterBinder.bind_many routes through the concurrent path for
        a RemoteCluster and the serial loop for the in-process store."""
        from kube_batch_tpu_torch.cache.cluster import ClusterBinder
        cluster, server = api
        self._seed(cluster, 4)
        remote = RemoteCluster(server.url).start()
        try:
            with remote.lock:
                pods = [remote.pods[f"ns/p{i}"] for i in range(4)]
            assert ClusterBinder(remote).bind_many(
                [(p, "n0") for p in pods]) == []
        finally:
            remote.stop()
        with cluster.lock:
            assert sum(1 for p in cluster.pods.values()
                       if p.spec.node_name) == 4

    def test_bind_retry_readback_asks_the_server(self, api):
        """_pod_bound_to consults the SERVER, not the (lagging) local
        mirror — the delivered-but-unanswered retry case."""
        cluster, server = api
        self._seed(cluster, 1)
        remote = RemoteCluster(server.url).start()
        try:
            with remote.lock:
                pod = remote.pods["ns/p0"]
            assert not remote._pod_bound_to(pod, "n0")
            # Bind server-side only; don't wait for the watch echo.
            cluster.bind_pod("ns", "p0", "n0")
            assert remote._pod_bound_to(pod, "n0")
            assert not remote._pod_bound_to(pod, "elsewhere")
        finally:
            remote.stop()
