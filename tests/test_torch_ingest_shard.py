"""Shard-scoped reflector ingest (doc/INGEST.md, edge/wire_shard.py).

A federated replica's reflectors connect with server-side selectors
derived from the tenancy shard map, so watch bandwidth and mirror memory
scale with OWNED shards.  These tests pin the correctness edges: the
selector boundary-transition rewrites (queue moves, binds), the
client-side scope check's over-approximation, the malformed-selector
degradation, the lease-handover rescope/relist, and the handover-race
drop accounting.

Twin of tests/test_ingest_shard.py, all 14 cases, over the port's
package (kube_batch_tpu_torch/edge/, client/, cli/) on the CPU:
schedulers and runtimes are built with ``device="cpu"``.
"""

import time

import pytest

from kube_batch_tpu_torch.api import ObjectMeta
from kube_batch_tpu_torch.apis.scheduling import v1alpha1
from kube_batch_tpu_torch.cache import Cluster
from kube_batch_tpu_torch.chaos import plan as chaos_plan
from kube_batch_tpu_torch.edge import (ApiServer, QUEUE_LABEL, RemoteCluster,
                                       ShardScope, attach_shard_scope)
from kube_batch_tpu_torch.edge import server as edge_server
from kube_batch_tpu_torch.metrics import metrics
from kube_batch_tpu_torch.tenancy.shards import ShardMap
from tests.test_torch_utils import build_node, build_pod, build_resource_list


def _mk_queue(name):
    return v1alpha1.Queue(metadata=ObjectMeta(name=name),
                          spec=v1alpha1.QueueSpec(weight=1))


def _mk_pg(name, queue, namespace="ns"):
    return v1alpha1.PodGroup(
        metadata=ObjectMeta(name=name, namespace=namespace),
        spec=v1alpha1.PodGroupSpec(min_member=1, queue=queue))


def _mk_pod(name, queue, node="", namespace="ns", labeled=True,
            group=None):
    labels = {QUEUE_LABEL: queue} if labeled else {}
    return build_pod(namespace, name, node, "Pending",
                     build_resource_list("1", "1Gi"),
                     group if group is not None else f"pg-{queue}",
                     labels=labels)


def _wait(predicate, timeout=10.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


# Two shards, queue names pinned so the test never depends on the hash.
MAP = ShardMap(2, overrides={"qa": 0, "qb": 1})


@pytest.fixture()
def scoped(monkeypatch):
    """Cluster + edge server + a RemoteCluster scoped to shard 0 (qa).
    Yields (cluster, remote, owned_set, scope); mutate ``owned_set`` +
    ``scope.bump()`` to model a lease transition."""
    monkeypatch.setattr(edge_server, "_PING_INTERVAL_S", 0.2)
    cluster = Cluster()
    for q in ("qa", "qb"):
        cluster.create_queue(_mk_queue(q))
        cluster.create_pod_group(_mk_pg(f"pg-{q}", q))
    cluster.create_node(build_node("n0", build_resource_list(
        "8", "16Gi", pods=110)))
    server = ApiServer(cluster).start()
    remote = RemoteCluster(server.url)
    owned = {0}
    scope = ShardScope(MAP, owned=lambda: set(owned))
    remote.attach_scope(scope)
    remote.start()
    yield cluster, remote, owned, scope
    remote.stop()
    server.stop()


class TestScopedMirror:
    def test_mirror_holds_own_unassigned_plus_all_bound(self, scoped):
        cluster, remote, _owned, _scope = scoped
        cluster.create_pod(_mk_pod("own-pending", "qa"))
        cluster.create_pod(_mk_pod("foreign-pending", "qb"))
        cluster.create_pod(_mk_pod("foreign-bound", "qb", node="n0"))
        _wait(lambda: "ns/own-pending" in remote.pods
              and "ns/foreign-bound" in remote.pods,
              msg="scoped pods to mirror")
        # A foreign queue's PENDING pod never lands in the mirror; its
        # BOUND pod always does (node-occupancy accounting).
        time.sleep(0.3)
        assert "ns/foreign-pending" not in remote.pods
        # PodGroups filter server-side by queue.
        assert "ns/pg-qa" in remote.pod_groups
        assert "ns/pg-qb" not in remote.pod_groups
        # Shared streams stay unfiltered.
        assert set(remote.queues) == {"qa", "qb"}

    def test_queue_move_is_an_added_deleted_pair(self, scoped):
        """A label rewrite that moves a pod across the shard boundary
        surfaces as DELETED (exits the selector) / ADDED (enters), and
        the mirror tracks it exactly."""
        cluster, remote, _owned, _scope = scoped
        events = []
        remote.pod_informer.add_handlers(
            on_add=lambda o: events.append(("add", o.metadata.name)),
            on_update=lambda o, n: events.append(("upd", n.metadata.name)),
            on_delete=lambda o: events.append(("del", o.metadata.name)))
        import copy
        pod = _mk_pod("mover", "qb")
        cluster.create_pod(pod)
        time.sleep(0.3)
        assert "ns/mover" not in remote.pods  # foreign: filtered out
        pod = copy.deepcopy(pod)  # the store keeps the old object
        pod.metadata.labels = {QUEUE_LABEL: "qa"}
        cluster.update_pod(pod)
        _wait(lambda: "ns/mover" in remote.pods, msg="queue move in")
        # The mirror changes before its handlers run: wait for the
        # event itself.
        _wait(lambda: ("add", "mover") in events, msg="the ADDED event")
        pod = copy.deepcopy(pod)
        pod.metadata.labels = {QUEUE_LABEL: "qb"}
        cluster.update_pod(pod)
        _wait(lambda: "ns/mover" not in remote.pods, msg="queue move out")
        _wait(lambda: ("del", "mover") in events, msg="the DELETED event")

    def test_bind_transition_never_fires_delete(self, scoped):
        """An own-queue pod binding to a node crosses from the
        unassigned stream to the assigned stream: the cross-stream
        DELETED is suppressed and the peer's ADDED lands as the same
        fire_update the unfiltered control emits for the MODIFIED."""
        cluster, remote, _owned, _scope = scoped
        deletes, updates = [], []
        remote.pod_informer.add_handlers(
            on_add=lambda o: None,
            on_update=lambda o, n: updates.append(n.metadata.name),
            on_delete=lambda o: deletes.append(o.metadata.name))
        cluster.create_pod(_mk_pod("binder", "qa"))
        _wait(lambda: "ns/binder" in remote.pods, msg="pod mirrored")
        cluster.bind_pod("ns", "binder", "n0")
        remote.flush_pending()
        _wait(lambda: "ns/binder" in remote.pods
              and (remote.flush_pending() or True)
              and remote.pods["ns/binder"].spec.node_name == "n0",
              msg="bind visible")
        assert "binder" not in deletes
        assert "binder" in updates

    def test_unlabeled_pod_attributed_via_podgroup(self, scoped):
        """The ``notin`` selector over-approximates (unlabeled pods are
        always sent); the client-side scope check attributes them via
        the podgroup annotation.  An OWN unlabeled pod resolves through
        the mirrored podgroup; a foreign one's podgroup is itself
        filtered out, so the pod is unattributable and admitted — the
        documented safe over-approximation, never a drop."""
        cluster, remote, _owned, _scope = scoped
        cluster.create_pod(_mk_pod("bare-own", "qa", labeled=False,
                                   group="pg-qa"))
        cluster.create_pod(_mk_pod("bare-foreign", "qb", labeled=False,
                                   group="pg-qb"))
        _wait(lambda: "ns/bare-own" in remote.pods, msg="own bare pod")
        _wait(lambda: "ns/bare-foreign" in remote.pods,
              msg="unattributable pod admitted")

    def test_new_queue_universe_gap_drops_client_side(self, scoped):
        """A queue created AFTER the pods stream connected is not in the
        server selector's universe, so its labeled pods reach the client
        — the client-side scope check drops them, counted with
        reason=scope, and never mirrors them."""
        cluster, remote, _owned, _scope = scoped
        # Deterministically find a fresh queue name hashing to the
        # foreign shard (no override, pure blake2b).
        name = next(f"late-q{i}" for i in range(64)
                    if MAP.shard_of(f"late-q{i}") == 1)
        cluster.create_queue(_mk_queue(name))
        before = metrics.ingest_drop_counts().get("pods/scope", 0)
        cluster.create_pod(_mk_pod("gap-pod", name))
        _wait(lambda: metrics.ingest_drop_counts().get("pods/scope", 0)
              > before, msg="scope drop counted")
        assert "ns/gap-pod" not in remote.pods

    def test_unattributable_pod_passes(self, scoped):
        """No label, no known podgroup: the scope check must admit it
        (never drop what we cannot attribute)."""
        cluster, remote, _owned, _scope = scoped
        cluster.create_pod(_mk_pod("mystery", "qb", labeled=False,
                                   group="no-such-group"))
        _wait(lambda: "ns/mystery" in remote.pods,
              msg="unattributable pod admitted")


class TestSelectors:
    def test_pod_selector_is_set_based_notin(self):
        scope = ShardScope(MAP, owned=lambda: {0})
        sel = scope.pod_label_selector(["qa", "qb"])
        assert sel == f"{QUEUE_LABEL} notin (qb)"
        # All shards owned: nothing to exclude, no selector at all.
        assert ShardScope(MAP).pod_label_selector(["qa", "qb"]) is None

    def test_podgroup_selector_chains_field_exclusions(self):
        big = ShardMap(4, overrides={"q0": 0, "q1": 1, "q2": 2, "q3": 3})
        scope = ShardScope(big, owned=lambda: {0, 1})
        sel = scope.podgroup_field_selector(["q0", "q1", "q2", "q3"])
        assert sel == "spec.queue!=q2,spec.queue!=q3"

    def test_malformed_queue_name_raises_value_error(self):
        bad = ShardMap(2, overrides={"qa": 0, "bad queue,": 1})
        scope = ShardScope(bad, owned=lambda: {0})
        with pytest.raises(ValueError):
            scope.pod_label_selector(["qa", "bad queue,"])
        with pytest.raises(ValueError):
            scope.podgroup_field_selector(["qa", "bad queue,"])

    def test_malformed_selector_degrades_stream_not_daemon(self):
        """Satellite: an inexpressible queue name degrades that stream
        to an unfiltered watch with a counted warn-once — the reflector
        keeps running and the client-side scope check still filters."""
        bad = ShardMap(2, overrides={"qa": 0, "bad queue,": 1})
        remote = RemoteCluster("http://127.0.0.1:1")
        remote._scope = ShardScope(bad, owned=lambda: {0})
        with remote.lock:
            remote.queues = {"qa": object(), "bad queue,": object()}
        before = metrics.wire_fast_counts().get("fallback_selector", 0)
        suffix, epoch, domain = remote._watch_params("pods", None)
        # Degraded: the unassigned field selector survives, the label
        # selector is dropped.
        assert "labelSelector" not in suffix
        assert "fieldSelector" in suffix
        assert domain == "unassigned" and epoch is not None
        suffix_pg, _, _ = remote._watch_params("podgroups", None)
        assert suffix_pg == ""
        after = metrics.wire_fast_counts().get("fallback_selector", 0)
        assert after >= before + 2

    def test_namespaced_scoping_composes_with_shard_selector(self, scoped):
        """The shard label selector composes with other scoping the
        server grammar supports — two namespaces, one queue, both
        mirrored; the foreign queue filtered in both."""
        cluster, remote, _owned, _scope = scoped
        cluster.create_pod_group(_mk_pg("pg-qa", "qa", namespace="ns2"))
        cluster.create_pod(_mk_pod("p-ns1", "qa"))
        cluster.create_pod(_mk_pod("p-ns2", "qa", namespace="ns2"))
        cluster.create_pod(_mk_pod("p-foreign", "qb", namespace="ns2"))
        _wait(lambda: "ns/p-ns1" in remote.pods
              and "ns2/p-ns2" in remote.pods, msg="both namespaces")
        time.sleep(0.2)
        assert "ns2/p-foreign" not in remote.pods


class TestHandover:
    def test_lease_change_rescopes_and_purges(self, scoped):
        """Shed shard 0, gain shard 1: the epoch bump forces a full
        scoped relist — qb's world appears, qa's pending pods and
        podgroups are purged and their retained baselines released."""
        cluster, remote, owned, scope = scoped
        cluster.create_pod(_mk_pod("own", "qa"))
        cluster.create_pod(_mk_pod("other", "qb"))
        _wait(lambda: "ns/own" in remote.pods, msg="initial scope")
        owned.clear()
        owned.add(1)
        scope.bump()
        _wait(lambda: "ns/other" in remote.pods, msg="gained shard relist")
        _wait(lambda: "ns/own" not in remote.pods, msg="shed shard purge")
        _wait(lambda: "ns/pg-qb" in remote.pod_groups
              and "ns/pg-qa" not in remote.pod_groups,
              msg="podgroup rescope")
        # The purge released the shed entries' retained baselines: the
        # ledger reconciles with what the mirror actually holds.
        audit = remote.audit_baseline_bytes()
        assert audit["pods"] == 0 and audit["podgroups"] == 0

    def test_handover_race_drops_and_counts(self, scoped):
        """Chaos site ``ingest.handover_race``: a frame that arrives in
        the one-frame window after a lease loss (stale epoch held open)
        is dropped-and-counted with reason=handover, never mirrored."""
        cluster, remote, owned, scope = scoped
        _wait(lambda: True)
        chaos_plan.install(chaos_plan.FaultPlan(
            seed=3, rate=1.0, sites=("ingest.handover_race:pods",)))
        try:
            before = metrics.ingest_drop_counts().get("pods/handover", 0)
            owned.clear()  # lost shard 0; epoch goes stale
            scope.bump()
            cluster.create_pod(_mk_pod("late", "qa"))
            _wait(lambda: metrics.ingest_drop_counts().get(
                "pods/handover", 0) > before, msg="handover drop counted")
            assert "ns/late" not in remote.pods
        finally:
            chaos_plan.disable()
        # After the chaos window the reflector rescopes and converges:
        # no stale-shard entries survive.
        _wait(lambda: not [k for k, p in dict(remote.pods).items()
                           if not p.spec.node_name],
              msg="zero stale-shard mirror entries")

    def test_wire_shard_disabled_is_identity(self, monkeypatch):
        """KUBE_BATCH_TPU_WIRE_SHARD=0: attach_shard_scope is a no-op
        and the legacy unfiltered single stream mirrors everything."""
        monkeypatch.setenv("KUBE_BATCH_TPU_WIRE_SHARD", "0")
        cluster = Cluster()
        for q in ("qa", "qb"):
            cluster.create_queue(_mk_queue(q))
            cluster.create_pod_group(_mk_pg(f"pg-{q}", q))
        server = ApiServer(cluster).start()
        remote = RemoteCluster(server.url)
        assert attach_shard_scope(remote, MAP) is None
        remote.start()
        try:
            cluster.create_pod(_mk_pod("a", "qa"))
            cluster.create_pod(_mk_pod("b", "qb"))
            _wait(lambda: "ns/a" in remote.pods and "ns/b" in remote.pods,
                  msg="unfiltered mirror")
        finally:
            remote.stop()
            server.stop()
