"""Lazy mirror materialization (doc/INGEST.md, edge/client.py).

Under ``KUBE_BATCH_TPU_LAZY_MIRROR`` a MODIFIED pod frame for an object
nothing has read yet updates only the retained wire-doc baseline and a
deferred-frame plan; the dataclass is built at the session/debug
chokepoint (``flush_pending``, wired as ``cache.mirror_flush``).  These
tests pin the parity contract (mirror state and informer fan-out
bit-identical to the eager ``LAZY_MIRROR=0`` control), the non-vacuity
of the deferral itself, the frame-receipt ``_ingest_ts`` stamp, and the
flush chokepoints.

Twin of tests/test_lazy_mirror.py, all 6 cases, over the port's package
(kube_batch_tpu_torch/edge/, client/, cli/) on the CPU: schedulers and
runtimes are built with ``device="cpu"``.
"""

import copy
import time

import pytest

from kube_batch_tpu_torch.api import ObjectMeta
from kube_batch_tpu_torch.apis.scheduling import v1alpha1
from kube_batch_tpu_torch.cache import Cluster, new_scheduler_cache
from kube_batch_tpu_torch.edge import ApiServer, RemoteCluster
from kube_batch_tpu_torch.edge.codec import encode
from kube_batch_tpu_torch.metrics import metrics
from tests.test_torch_utils import build_node, build_pod, build_resource_list


def _wait(predicate, timeout=10.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _mk_cluster():
    cluster = Cluster()
    cluster.create_queue(v1alpha1.Queue(
        metadata=ObjectMeta(name="default"),
        spec=v1alpha1.QueueSpec(weight=1)))
    cluster.create_pod_group(v1alpha1.PodGroup(
        metadata=ObjectMeta(name="pg1", namespace="ns"),
        spec=v1alpha1.PodGroupSpec(min_member=1, queue="default")))
    cluster.create_node(build_node("n0", build_resource_list(
        "8", "16Gi", pods=110)))
    return cluster


def _pod(name, node="", phase="Pending", cpu="1"):
    # Fixed creation_timestamp: the parity test compares encoded docs
    # across two separate runs, so wall-clock stamps must not differ.
    return build_pod("ns", name, node, phase,
                     build_resource_list(cpu, "1Gi"), "pg1", ts=1.0)


def _run_workload(lazy, monkeypatch):
    """Drive one canonical mutation mix through a RemoteCluster and
    return (event log, final mirror docs, remote).  ``lazy`` toggles the
    deferral; the event log records every informer delivery with the
    object's encoded doc AT DELIVERY TIME (aliasing bugs would differ)."""
    monkeypatch.setenv("KUBE_BATCH_TPU_LAZY_MIRROR", "1" if lazy else "0")
    cluster = _mk_cluster()
    server = ApiServer(cluster).start()
    remote = RemoteCluster(server.url)
    remote.pending_churn = lambda queue: None  # arm the deferral
    events = []
    remote.pod_informer.add_handlers(
        on_add=lambda o: events.append(("add", encode(o))),
        on_update=lambda o, n: events.append(("upd", encode(o),
                                              encode(n))),
        on_delete=lambda o: events.append(("del", encode(o))))
    remote.start()
    try:
        for i in range(3):
            cluster.create_pod(_pod(f"p{i}"))
        _wait(lambda: len(remote.pods) == 3, msg="pods mirrored")
        # MODIFIED bursts: phase/requests churn, several per pod, then
        # a bind (stream/selector transition) and a delete.
        for rev in ("2", "3"):
            for i in range(3):
                pod = copy.deepcopy(cluster.get_pod("ns", f"p{i}"))
                pod.spec.containers[0].requests = build_resource_list(
                    rev, "1Gi")
                cluster.update_pod(pod)
        cluster.bind_pod("ns", "p0", "n0")
        cluster.delete_pod("ns", "p2")
        deadline = time.time() + 10
        while time.time() < deadline:
            remote.flush_pending()
            with remote.lock:
                done = ("ns/p2" not in remote.pods
                        and "ns/p0" in remote.pods
                        and remote.pods["ns/p0"].spec.node_name == "n0"
                        and all(p.spec.containers[0].requests["cpu"] == "3"
                                for p in remote.pods.values()))
            if done:
                break
            time.sleep(0.02)
        remote.flush_pending()
        with remote.lock:
            mirror = {k: encode(p) for k, p in remote.pods.items()}
        return events, mirror
    finally:
        remote.stop()
        server.stop()


class TestLazyParity:
    def test_mirror_and_events_bit_identical_to_eager(self, monkeypatch):
        """The whole point: binds/updates/deletes land in the same
        mirror state, and the informer fan-out coalesces to the same
        final deliveries, with the deferral on or off."""
        lazy_events, lazy_mirror = _run_workload(True, monkeypatch)
        eager_events, eager_mirror = _run_workload(False, monkeypatch)
        assert lazy_mirror == eager_mirror
        # Event parity is on the COALESCED stream: lazy may legally
        # merge consecutive MODIFIEDs of one key between flushes, so
        # compare each pod's first and last delivered state.
        def ends(events):
            out = {}
            for ev in events:
                doc = ev[-1]
                # The cluster stamps wall-clock deletion_timestamp at
                # delete time: inherently different across two runs,
                # not a parity signal.
                doc["metadata"].pop("deletion_timestamp", None)
                key = (doc["metadata"]["namespace"],
                       doc["metadata"]["name"])
                first, _ = out.get(key, (None, None))
                out[key] = (doc if first is None else first,
                            (ev[0], doc))
            return out
        assert ends(lazy_events) == ends(eager_events)
        # Non-vacuity: the lazy arm actually deferred something.
        counts = metrics.lazy_mirror_counts()
        assert counts.get("deferred", 0) > 0
        assert counts.get("flushed", 0) > 0


class TestDeferral:
    @pytest.fixture()
    def live(self, monkeypatch):
        monkeypatch.setenv("KUBE_BATCH_TPU_LAZY_MIRROR", "1")
        cluster = _mk_cluster()
        server = ApiServer(cluster).start()
        remote = RemoteCluster(server.url)
        remote.pending_churn = lambda queue: None
        remote.start()
        yield cluster, remote
        remote.stop()
        server.stop()

    def _modify(self, cluster, name, cpu):
        pod = copy.deepcopy(cluster.get_pod("ns", name))
        pod.spec.containers[0].requests = build_resource_list(cpu, "1Gi")
        cluster.update_pod(pod)

    def test_modified_defers_and_coalesces(self, live):
        cluster, remote = live
        cluster.create_pod(_pod("p0"))
        _wait(lambda: "ns/p0" in remote.pods, msg="pod mirrored")
        before = metrics.lazy_mirror_counts()
        self._modify(cluster, "p0", "2")
        _wait(lambda: remote.pending_count() == 1, msg="frame deferred")
        # The mirror still holds the OLD materialization; the raw doc
        # waits in the pending store.
        assert remote.pods["ns/p0"].spec.containers[0].requests[
            "cpu"] == "1"
        self._modify(cluster, "p0", "3")
        _wait(lambda: metrics.lazy_mirror_counts().get("coalesced", 0)
              > before.get("coalesced", 0), msg="second frame coalesced")
        assert remote.pending_count() == 1
        t_flush = time.monotonic()
        assert remote.flush_pending() == 1
        pod = remote.pods["ns/p0"]
        assert pod.spec.containers[0].requests["cpu"] == "3"
        # Frame-receipt stamp: the lineage clock started at receipt,
        # before the flush materialized the dataclass.
        assert pod._ingest_ts <= t_flush
        assert remote.pending_count() == 0

    def test_first_sight_and_delete_stay_eager(self, live):
        """ADDED must materialize immediately (there is no baseline to
        defer against), and DELETED must flush-then-remove so the cache
        sees final-state-then-delete."""
        cluster, remote = live
        cluster.create_pod(_pod("p1"))
        _wait(lambda: "ns/p1" in remote.pods, msg="eager ADDED")
        assert remote.pending_count() == 0
        finals = []
        remote.pod_informer.add_handlers(
            on_add=lambda o: None,
            on_update=lambda o, n: finals.append(
                ("upd", n.spec.containers[0].requests["cpu"])),
            on_delete=lambda o: finals.append(("del", o.metadata.name)))
        self._modify(cluster, "p1", "4")
        _wait(lambda: remote.pending_count() == 1, msg="deferred")
        cluster.delete_pod("ns", "p1")
        _wait(lambda: "ns/p1" not in remote.pods, msg="deleted")
        assert finals == [("upd", "4"), ("del", "p1")]

    def test_get_mirror_pod_flushes_its_key(self, live):
        cluster, remote = live
        cluster.create_pod(_pod("p2"))
        _wait(lambda: "ns/p2" in remote.pods, msg="pod mirrored")
        self._modify(cluster, "p2", "5")
        _wait(lambda: remote.pending_count() == 1, msg="deferred")
        pod = remote.get_mirror_pod("ns", "p2")
        assert pod.spec.containers[0].requests["cpu"] == "5"
        assert remote.pending_count() == 0

    def test_unwired_churn_consumer_disables_deferral(self, monkeypatch):
        """Without a flush consumer the mirror must stay fully eager —
        nothing would ever drain the pending store (validity rule)."""
        monkeypatch.setenv("KUBE_BATCH_TPU_LAZY_MIRROR", "1")
        cluster = _mk_cluster()
        server = ApiServer(cluster).start()
        remote = RemoteCluster(server.url)  # pending_churn stays None
        remote.start()
        try:
            cluster.create_pod(_pod("p3"))
            _wait(lambda: "ns/p3" in remote.pods, msg="pod mirrored")
            self._modify(cluster, "p3", "6")
            _wait(lambda: remote.pods["ns/p3"].spec.containers[0]
                  .requests["cpu"] == "6", msg="eager MODIFIED")
            assert remote.pending_count() == 0
        finally:
            remote.stop()
            server.stop()

    def test_cache_snapshot_drains_pending(self, monkeypatch):
        """new_scheduler_cache wires flush_pending as cache.mirror_flush
        and the deferral wakes the scheduler via cache._note_churn;
        snapshot() then drains the pending store before cloning."""
        monkeypatch.setenv("KUBE_BATCH_TPU_LAZY_MIRROR", "1")
        cluster = _mk_cluster()
        server = ApiServer(cluster).start()
        remote = RemoteCluster(server.url).start()
        try:
            cache = new_scheduler_cache(remote)
            assert cache.mirror_flush is not None
            assert remote.pending_churn is not None
            woke = []
            cache.shard_churn = lambda queue: woke.append(queue)
            cluster.create_pod(_pod("p4"))
            _wait(lambda: "ns/p4" in remote.pods, msg="pod mirrored")
            self._modify(cluster, "p4", "7")
            _wait(lambda: remote.pending_count() == 1, msg="deferred")
            assert woke  # the deferred frame still dirtied its shard
            snap = cache.snapshot()
            assert remote.pending_count() == 0
            job = next(j for j in snap.jobs.values()
                       if j.namespace == "ns")
            task = next(t for t in job.tasks.values()
                        if t.name == "p4")
            assert task.resreq.get("cpu") == 7000.0  # millicores
        finally:
            remote.stop()
            server.stop()
