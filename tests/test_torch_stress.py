"""Concurrency stress on the port: informer churn racing the scheduling
loop, the twin of tests/test_stress.py.

Pods and pod groups are created and deleted by four concurrent writer
threads while the port's Scheduler loop (on the CPU) snapshots and binds.
Passes when no exception escapes either side and the final state is
consistent.  Two write surfaces: the in-process store, and the port's
HTTP edge (its ``RemoteCluster`` reflectors ingest, the concurrent bind
egress writes back).  The writers and their checks are the reference
test's own (``_churn``, ``_run_writers``, ``_wait_all_bound``), given
the port's objects.
"""

import random
import threading
import time

from kube_batch_tpu_torch.api import (Container, ObjectMeta, Pod, PodSpec,
                                      PodStatus)
from kube_batch_tpu_torch.apis.scheduling import v1alpha1
from kube_batch_tpu_torch.cache import Cluster, new_scheduler_cache
from kube_batch_tpu_torch.scheduler import Scheduler
from tests.test_torch_utils import build_node, build_resource_list


def _seed(cluster):
    cluster.create_queue(v1alpha1.Queue(
        metadata=ObjectMeta(name="default"),
        spec=v1alpha1.QueueSpec(weight=1)))
    for i in range(8):
        cluster.create_node(build_node(
            f"n{i}", build_resource_list("16", "32Gi", pods=110)))


def _churn(surface, iterations, errors, worker):
    """One writer: create gang-of-1 pods against ``surface`` (the
    in-process Cluster or a RemoteCluster), occasionally delete them.
    Only not-found errors are tolerated (the scheduler may have raced a
    delete); anything else fails the test."""
    rng = random.Random(worker)
    try:
        for i in range(iterations):
            name = f"w{worker}-{i}"
            surface.create_pod_group(v1alpha1.PodGroup(
                metadata=ObjectMeta(name=name, namespace="churn"),
                spec=v1alpha1.PodGroupSpec(min_member=1,
                                           queue="default")))
            surface.create_pod(Pod(
                metadata=ObjectMeta(
                    name=name, namespace="churn",
                    annotations={v1alpha1.GroupNameAnnotationKey: name}),
                spec=PodSpec(containers=[Container(
                    requests={"cpu": "100m", "memory": "64Mi"})]),
                status=PodStatus(phase="Pending")))
            if rng.random() < 0.3:
                time.sleep(0.005)
            if rng.random() < 0.25:
                for deleter in (surface.delete_pod,
                                surface.delete_pod_group):
                    try:
                        deleter("churn", name)
                    except KeyError as exc:
                        # RemoteCluster maps every HTTP error to KeyError;
                        # swallow only not-found.
                        msg = str(exc)
                        if "404" not in msg and "not found" not in msg:
                            raise
    except Exception as exc:  # lint: allow-swallow(the writer thread reports into errors, which the test asserts empty)
        errors.append(exc)


def _run_writers(surface, iterations, n_workers=4):
    errors = []
    threads = [threading.Thread(target=_churn,
                                args=(surface, iterations, errors, w))
               for w in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return errors


def _wait_all_bound(cluster, deadline_s):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        with cluster.lock:
            if all(p.spec.node_name for p in cluster.pods.values()):
                return
        time.sleep(0.05)


def test_churn_under_scheduling_loop():
    import gc
    cluster = Cluster()
    _seed(cluster)
    cache = new_scheduler_cache(cluster)
    sched = Scheduler(cache, schedule_period=0.02, device="cpu")
    sched.run()
    try:
        errors = _run_writers(cluster, iterations=40)
        _wait_all_bound(cluster, 20)
    finally:
        sched.stop()
        gc.unfreeze()

    assert not errors, errors
    assert all(p.spec.node_name for p in cluster.pods.values())
    # Cache accounting stayed consistent: all nodes remain Ready.
    assert len(cache.snapshot().nodes) == 8


def test_churn_over_the_wire():
    """The same race through the port's network edge: writers hammer the
    HTTP API while the scheduler's only view is the RemoteCluster
    reflector and every bind rides the concurrent egress pool."""
    import gc

    from kube_batch_tpu_torch.edge import ApiServer, RemoteCluster

    cluster = Cluster()
    server = ApiServer(cluster).start()
    sched = remote = None
    try:
        _seed(cluster)
        remote = RemoteCluster(server.url).start()
        cache = new_scheduler_cache(remote)
        sched = Scheduler(cache, schedule_period=0.02, device="cpu")
        sched.run()

        errors = _run_writers(remote, iterations=25)
        _wait_all_bound(cluster, 30)

        # The reflector's mirror converged to the server's end state:
        # same pod keys, binds included.
        deadline = time.time() + 10
        while time.time() < deadline:
            remote.flush_pending()
            with cluster.lock:
                server_state = {k: p.spec.node_name
                                for k, p in cluster.pods.items()}
            with remote.lock:
                mirror_state = {k: p.spec.node_name
                                for k, p in remote.pods.items()}
            if server_state == mirror_state:
                break
            time.sleep(0.05)
        assert server_state == mirror_state
    finally:
        if sched is not None:
            sched.stop()
        if remote is not None:
            remote.stop()
        server.stop()
        gc.unfreeze()

    assert not errors, errors
    assert all(p.spec.node_name for p in cluster.pods.values())
