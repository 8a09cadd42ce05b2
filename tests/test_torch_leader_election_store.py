"""Store-backed leader election (VERDICT r2 next #3): the HA lock is a
lease object in the cluster store — any standby that can reach the store
(in-process or over the HTTP edge) coordinates through CAS, like the
reference's ConfigMap lock (server.go:115-139).

Twin of tests/test_leader_election_store.py, all 6 cases, the ApiServer
standby takeover with ``ServerRuntime(--master)`` included, over the
port's package (kube_batch_tpu_torch/edge/, client/, cli/) on the CPU:
schedulers and runtimes are built with ``device="cpu"``.
"""

import gc
import time

import pytest

from kube_batch_tpu_torch.api import ObjectMeta
from kube_batch_tpu_torch.apis.scheduling import v1alpha1
from kube_batch_tpu_torch.cache import Cluster
from kube_batch_tpu_torch.cli.leader_election import (LeaderElectionConfig,
                                                      LeaderElector, StoreLock)
from kube_batch_tpu_torch.cli.options import ServerOption
from kube_batch_tpu_torch.cli.server import ServerRuntime
from kube_batch_tpu_torch.edge import ApiServer
from tests.test_torch_utils import build_node, build_pod, build_resource_list


@pytest.fixture(autouse=True)
def _unfreeze():
    """Scheduler.run() freezes the collector's view of the synced cache;
    undo it after each case."""
    yield
    gc.unfreeze()



def _fast_config(identity):
    return LeaderElectionConfig(identity=identity, lease_duration=1.0,
                                renew_deadline=0.4, retry_period=0.1)


class TestStoreLock:
    def test_cas_conflict_rejected(self):
        cluster = Cluster()
        lock = StoreLock(cluster, "kube-system")
        v0, rec = lock.get()
        assert (v0, rec) == (0, None)
        assert lock.cas({"holderIdentity": "a"}, v0)
        v1, rec = lock.get()
        assert rec["holderIdentity"] == "a"
        # A competing CAS against the stale version must lose.
        assert not lock.cas({"holderIdentity": "b"}, v0)
        assert lock.get()[1]["holderIdentity"] == "a"
        assert lock.cas({"holderIdentity": "b"}, v1)

    def test_standby_takes_over_after_lease_expiry(self):
        cluster = Cluster()
        lock = StoreLock(cluster, "kube-system")
        events = []
        a = LeaderElector(_fast_config("a"), lambda: events.append("a-up"),
                          lambda: events.append("a-down"), lock=lock)
        b = LeaderElector(_fast_config("b"), lambda: events.append("b-up"),
                          lambda: events.append("b-down"), lock=lock)
        import threading
        ta = threading.Thread(target=a.run, daemon=True)
        ta.start()
        deadline = time.time() + 5
        while time.time() < deadline and not a.is_leader:
            time.sleep(0.02)
        assert a.is_leader
        tb = threading.Thread(target=b.run, daemon=True)
        tb.start()
        time.sleep(0.5)
        assert not b.is_leader  # live lease held by a
        a.stop()  # "process dies": renewals cease, lease expires
        deadline = time.time() + 5
        while time.time() < deadline and not b.is_leader:
            time.sleep(0.02)
        assert b.is_leader
        b.stop()
        ta.join(timeout=2.0)
        tb.join(timeout=2.0)
        assert events[0] == "a-up" and "b-up" in events


class TestFileLock:
    def test_cas_conflict_rejected(self, tmp_path):
        from kube_batch_tpu_torch.cli.leader_election import FileLock
        path = str(tmp_path / "lock.json")
        # Two standbys both read version 0 of an absent/expired lease.
        a, b = FileLock(path), FileLock(path)
        va, _ = a.get()
        vb, _ = b.get()
        assert va == vb == 0
        assert a.cas({"holderIdentity": "a"}, va)
        # b's CAS against the stale version must LOSE (the r3 file backend
        # was last-writer-wins here: both would have become leader).
        assert not b.cas({"holderIdentity": "b"}, vb)
        v1, rec = b.get()
        assert rec["holderIdentity"] == "a"
        assert b.cas({"holderIdentity": "b"}, v1)
        assert b.get()[1]["holderIdentity"] == "b"

    def test_crashed_holder_cannot_wedge_mutex(self, tmp_path):
        """flock is kernel-released on process death: a contender killed
        -9 mid-CAS must not block later acquisitions."""
        import signal
        import subprocess
        import sys
        from kube_batch_tpu_torch.cli.leader_election import FileLock
        path = str(tmp_path / "lock.json")
        lock = FileLock(path)
        # A child takes the sidecar flock and hangs (a crash mid-CAS).
        child = subprocess.Popen(
            [sys.executable, "-c",
             "import fcntl, os, sys, time\n"
             f"fd = os.open({lock._sidecar!r}, os.O_CREAT | os.O_RDWR)\n"
             "fcntl.flock(fd, fcntl.LOCK_EX)\n"
             "print('held', flush=True)\n"
             "time.sleep(60)\n"],
            stdout=subprocess.PIPE)
        try:
            assert child.stdout.readline().strip() == b"held"
            v, _ = lock.get()
            assert not lock.cas({"holderIdentity": "a"}, v)  # child holds it
            child.send_signal(signal.SIGKILL)
            child.wait()
            assert lock.cas({"holderIdentity": "a"}, v)  # kernel released it
            assert lock.get()[1]["holderIdentity"] == "a"
        finally:
            child.kill()
            child.wait()


class TestWriteFence:
    def test_cache_refuses_writes_after_leadership_loss(self):
        """ADVICE r3 #3: an in-flight cycle must not bind/evict once the
        lease is gone (the reference fences by process exit)."""
        from kube_batch_tpu_torch.cache import new_scheduler_cache
        cluster = Cluster()
        cluster.create_node(build_node("n0", build_resource_list(
            "8", "16Gi", pods=110)))
        cluster.create_pod(build_pod("ns", "p0", "", "Pending",
                                     build_resource_list("1", "1Gi")))
        cache = new_scheduler_cache(cluster)
        cache.run()
        cache.wait_for_cache_sync()
        leading = [True]
        cache.write_fence = lambda: leading[0]
        task = next(iter(next(iter(cache.jobs.values())).tasks.values()))
        leading[0] = False
        with pytest.raises(RuntimeError, match="leadership lost"):
            cache.bind(task, "n0")
        with pytest.raises(RuntimeError, match="leadership lost"):
            cache.evict(task, "test")
        with pytest.raises(RuntimeError, match="leadership lost"):
            cache.bind_batch([task])
        with pytest.raises(RuntimeError, match="leadership lost"):
            cache.update_job_status(next(iter(cache.jobs.values())))
        # Writes resume when leading again.
        leading[0] = True
        cache.bind(task, "n0")
        with cluster.lock:
            assert cluster.pods["ns/p0"].spec.node_name == "n0"


class TestFailoverOverTheEdge:
    def test_standby_runtime_takes_over_and_zombie_stops(self):
        cluster = Cluster()
        cluster.create_node(build_node("n0", build_resource_list(
            "8", "16Gi", pods=110)))
        cluster.create_queue(v1alpha1.Queue(
            metadata=ObjectMeta(name="default"),
            spec=v1alpha1.QueueSpec(weight=1)))
        server = ApiServer(cluster).start()

        def submit(gen):
            cluster.create_pod_group(v1alpha1.PodGroup(
                metadata=ObjectMeta(name=f"pg{gen}", namespace="ns"),
                spec=v1alpha1.PodGroupSpec(min_member=1, queue="default")))
            cluster.create_pod(build_pod("ns", f"p{gen}", "", "Pending",
                                         build_resource_list("1", "1Gi"),
                                         groupname=f"pg{gen}"))

        def wait_bound(gen, timeout=20):
            deadline = time.time() + timeout
            while time.time() < deadline:
                with cluster.lock:
                    pod = cluster.pods.get(f"ns/p{gen}")
                if pod is not None and pod.spec.node_name:
                    return True
                time.sleep(0.05)
            return False

        def opt():
            return ServerOption(master=server.url,
                                enable_leader_election=True,
                                lock_object_namespace="kube-system",
                                schedule_period=0.05, listen_address="")

        rt_a = ServerRuntime(opt(), lease_config=_fast_config("a"),
                             device="cpu")
        rt_b = ServerRuntime(opt(), lease_config=_fast_config("b"),
                             device="cpu")
        try:
            rt_a.run()
            submit(0)
            assert wait_bound(0), "leader A did not schedule"
            rt_b.run()
            time.sleep(0.5)
            assert not rt_b.elector.is_leader  # standby while A renews

            # A dies: stop its renewals (and its loop, as a crash would).
            rt_a.elector.stop()
            rt_a.scheduler.stop()
            submit(1)
            assert wait_bound(1), "standby B did not take over"
            assert rt_b.elector.is_leader

            # Zombie fencing: steal B's lease; its loop must halt.
            v, _rec = cluster.get_lease("kube-system", "kube-batch-lock")
            cluster.cas_lease("kube-system", "kube-batch-lock",
                              {"holderIdentity": "intruder",
                               "renewTime": time.time() + 3600,
                               "leaseDurationSeconds": 3600}, v)
            deadline = time.time() + 5
            while time.time() < deadline and rt_b.elector.is_leader:
                time.sleep(0.05)
            assert not rt_b.elector.is_leader
            # The ex-leader's scheduling loop is stopped: no binds for a
            # newly-submitted job.
            submit(2)
            assert not wait_bound(2, timeout=1.5)
        finally:
            rt_a.stop()
            rt_b.stop()
            server.stop()
