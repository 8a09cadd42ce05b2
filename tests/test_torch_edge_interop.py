"""Each package's edge against the other's, on the CPU: the port's
``RemoteCluster`` over the JAX package's ``ApiServer`` and the JAX
package's ``RemoteCluster`` over the port's ``ApiServer``, on both wires
(native and k8s), and one seeded cluster scheduled over each package's
own edge.

The mirrors must equal the server's store key for key (every object's
document on the client's wire equal across packages;
tests/test_torch_edge_codec.py shows the codecs agree).  The port's
``Scheduler(device="cpu")`` over the port's edge and the reference's
``Scheduler`` over the reference's edge must leave the same placements,
pod-group statuses and events on their servers.  Tolerance: exact.
"""

import copy
import gc
import json
import time

import numpy as np
import pytest

from tests.test_torch_utils import Loop, bind_map
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

STORES = ("pods", "nodes", "pod_groups", "queues", "priority_classes",
          "pdbs")
CONF = """
actions: "tpu-allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


@pytest.fixture(autouse=True)
def _clean():
    yield
    gc.unfreeze()


def _edge(lp):
    import importlib
    root = "kube_batch_tpu_torch" if lp.pkg == "torch" else "kube_batch_tpu"
    return importlib.import_module(f"{root}.edge")


def _encoder(lp, wire):
    """The wire's own document of an object: the native codec, or the
    k8s codec, whose RFC 3339 timestamps keep microseconds only."""
    import importlib
    root = "kube_batch_tpu_torch" if lp.pkg == "torch" else "kube_batch_tpu"
    if wire == "k8s":
        return importlib.import_module(f"{root}.edge.codec_k8s").to_k8s
    return importlib.import_module(f"{root}.edge.codec").encode


def seed_cluster(lp, n_pods, n_nodes, seed, *, bound_share=0.2):
    """A seeded cluster in package ``lp``'s ``Cluster``: two queues,
    gangs of 1-6 pods (min member up to their size), ``bound_share`` of
    the pods already Running on a node, two priority classes and a PDB."""
    rng = np.random.default_rng(seed)
    o, v1 = lp.objects, lp.v1alpha1
    cluster = lp.cache.Cluster()
    for q, w in (("q0", 1), ("q1", 2)):
        lp.queue(cluster, q, weight=w)
    for name, value in (("high", 1000), ("low", 1)):
        cluster.create_priority_class(o.PriorityClass(
            metadata=o.ObjectMeta(name=name), value=value))
    for i in range(n_nodes):
        cluster.create_node(lp.node(
            f"n{i:03d}", {"zone": f"z{i % 3}"},
            cpu=str(int(rng.integers(4, 17))),
            mem=f"{int(rng.integers(8, 65))}Gi"))
    made, g = 0, 0
    while made < n_pods:
        size = int(min(rng.integers(1, 7), n_pods - made))
        group = f"pg{g:03d}"
        prio = str(rng.choice(["", "high", "low"]))
        cluster.create_pod_group(lp.pod_group(
            group, "ns", int(rng.integers(1, size + 1)),
            f"q{int(rng.integers(0, 2))}", priority_class_name=prio))
        for k in range(size):
            bound = rng.random() < bound_share
            node = f"n{int(rng.integers(0, n_nodes)):03d}" if bound else ""
            cluster.create_pod(o.Pod(
                metadata=o.ObjectMeta(
                    name=f"{group}-{k}", namespace="ns",
                    uid=f"ns-{group}-{k}",
                    annotations={v1.GroupNameAnnotationKey: group},
                    labels={"app": f"a{g % 4}"},
                    creation_timestamp=float(made)),
                spec=o.PodSpec(
                    node_name=node,
                    node_selector=({"zone": f"z{int(rng.integers(0, 3))}"}
                                   if rng.random() < 0.2 else {}),
                    priority={"high": 1000, "low": 1}.get(prio),
                    containers=[o.Container(requests={
                        "cpu": f"{int(rng.integers(1, 5)) * 250}m",
                        "memory": f"{int(rng.integers(1, 9)) * 256}Mi"})]),
                status=o.PodStatus(phase="Running" if bound else "Pending")))
            made += 1
        g += 1
    cluster.create_pdb(o.PodDisruptionBudget(
        metadata=o.ObjectMeta(name="pdb0", namespace="ns"),
        min_available=1))
    return cluster


def _docs(lp, store, lock, wire):
    enc = _encoder(lp, wire)
    with lock:
        return {k: json.loads(json.dumps(enc(v))) for k, v in store.items()}


def _wait(pred, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def _mirror_equals_server(server_lp, cluster, client_lp, remote):
    """None when every mirror store equals the server's, key for key and
    document for document on the client's wire; else the first store
    that differs."""
    remote.flush_pending()
    for name in STORES:
        want = _docs(server_lp, getattr(cluster, name), cluster.lock,
                     remote.wire)
        got = _docs(client_lp, getattr(remote, name), remote.lock,
                    remote.wire)
        if got != want:
            return name
    return None


@pytest.mark.parametrize("client,wire", [
    ("torch", "native"), ("torch", "k8s"), ("jax", "native"), ("jax", "k8s")])
def test_client_mirrors_the_other_packages_server(client, wire):
    server_lp = Loop("jax" if client == "torch" else "torch")
    client_lp = Loop(client)
    cluster = seed_cluster(server_lp, 120, 12, seed=4)
    server = _edge(server_lp).ApiServer(cluster).start()
    remote = None
    try:
        remote = _edge(client_lp).RemoteCluster(server.url, wire=wire)
        remote.start()
        assert _mirror_equals_server(server_lp, cluster, client_lp,
                                     remote) is None
        # Live changes from both sides: a server-side create and delete,
        # a client-side bind and pod-group status write.
        o = server_lp.objects
        cluster.create_pod(o.Pod(
            metadata=o.ObjectMeta(name="late", namespace="ns", uid="late"),
            spec=o.PodSpec(containers=[o.Container(
                requests={"cpu": "1", "memory": "1Gi"})])))
        cluster.delete_pod("ns", "pg000-0")
        pending = sorted(k for k, p in cluster.pods.items()
                         if not p.spec.node_name)
        ns, name = pending[0].split("/")
        remote.bind_pod(ns, name, "n001")
        with remote.lock:
            pg = copy.deepcopy(remote.pod_groups["ns/pg001"])
        pg.status.phase = "Running"
        remote.put_pod_group_status(pg)
        assert _wait(lambda: _mirror_equals_server(
            server_lp, cluster, client_lp, remote) is None), \
            _mirror_equals_server(server_lp, cluster, client_lp, remote)
        with cluster.lock:
            assert cluster.pods[pending[0]].spec.node_name == "n001"
            assert cluster.pod_groups["ns/pg001"].status.phase == "Running"
            assert "ns/pg000-0" not in cluster.pods
    finally:
        if remote is not None:
            remote.stop()
        server.stop()


def _schedule_over_edge(lp, wire):
    """One seeded cluster scheduled by ``lp``'s Scheduler over ``lp``'s
    own edge: two cycles, each after the mirror caught up with the
    server.  Returns what the server holds afterwards."""
    cluster = seed_cluster(lp, 300, 30, seed=9)
    server = _edge(lp).ApiServer(cluster).start()
    remote = sched = None
    try:
        remote = _edge(lp).RemoteCluster(server.url, wire=wire).start()
        cache = lp.cache.new_scheduler_cache(remote)
        sched = lp.scheduler(cache, scheduler_conf=CONF,
                             schedule_period=3600)
        cache.run()
        cache.wait_for_cache_sync()
        for _ in range(2):
            assert _wait(lambda: _mirror_equals_server(
                lp, cluster, lp, remote) is None)
            sched.run_once()
        cache.event_recorder.flush()
        counts = []
        assert _wait(lambda: counts.append(len(cluster.events)) or (
            len(counts) > 5 and counts[-1] == counts[-6]))
        with cluster.lock:
            statuses = {k: (pg.status.phase, pg.status.running,
                            [(c.type, c.status, c.reason, c.message)
                             for c in pg.status.conditions])
                        for k, pg in cluster.pod_groups.items()}
            events = sorted((e.involved_object, e.reason, e.message,
                             e.type) for e in cluster.events.values())
        return bind_map(cluster), statuses, events
    finally:
        if sched is not None:
            sched.stop()
        if remote is not None:
            remote.stop()
        server.stop()


@pytest.mark.parametrize("wire", ["native", "k8s"])
def test_same_placements_statuses_and_events_over_both_edges(wire):
    out = {}
    for pkg in ("jax", "torch"):
        lp = Loop(pkg)
        with lp.ctx():
            out[pkg] = _schedule_over_edge(lp, wire)
    binds, statuses, events = out["torch"]
    ref_binds, ref_statuses, ref_events = out["jax"]
    assert binds == ref_binds
    assert statuses == ref_statuses
    assert events == ref_events
    # Non-vacuous: the cycles bound pods beyond the seeded ones and
    # wrote gang statuses and scheduling events.
    assert len(binds) > 100
    assert any(s[0] == "Running" for s in statuses.values())
    assert any(e[1] == "Scheduled" for e in events)
