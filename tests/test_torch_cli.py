"""The port's CLI and server runtime (kube_batch_tpu_torch/cli/) on the
CPU.

Twin of tests/test_cli.py, case for case, with ``ServerRuntime(...,
device="cpu")``: the options (every flag and default the reference's),
the leader election store-locked and file-locked, the metrics endpoint
and the cluster-state loader.  Added: ``--master`` boots over the
port's ``edge.ApiServer`` and binds there, ``--replica-federation`` over
``--master`` attaches a ``ShardScope``, ``main`` without a card exits
non-zero, and ``python -m kube_batch_tpu_torch.cli.main --version``
prints the port's version.
"""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from kube_batch_tpu.cli.options import parse_options as ref_parse_options
from kube_batch_tpu_torch.cache import Cluster
from kube_batch_tpu_torch.cli.leader_election import (LeaderElectionConfig,
                                                      LeaderElector)
from kube_batch_tpu_torch.cli.options import ServerOption, parse_options
from kube_batch_tpu_torch.cli.server import ServerRuntime, load_cluster_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _unfreeze():
    """Scheduler.run() freezes the collector's view of the synced cache;
    undo it after each case."""
    yield
    gc.unfreeze()


def runtime(opt, **kw):
    return ServerRuntime(opt, device="cpu", **kw)


def wait_leader(elector, seconds=10):
    deadline = time.time() + seconds
    while time.time() < deadline and not elector.is_leader:
        time.sleep(0.05)
    return elector.is_leader


class TestOptions:
    def test_defaults(self):
        opt = parse_options([])
        assert opt.scheduler_name == "kube-batch"
        assert opt.schedule_period == 1.0
        assert opt.default_queue == "default"
        assert opt.listen_address == ":8080"
        assert opt.enable_leader_election is False
        assert dataclasses.asdict(opt) == dataclasses.asdict(
            ref_parse_options([]))

    def test_flags(self):
        argv = ["--schedule-period", "0.5", "--default-queue", "batch",
                "--leader-elect", "--lock-object-namespace", "/tmp"]
        opt = parse_options(argv)
        assert opt.schedule_period == 0.5
        assert opt.default_queue == "batch"
        assert opt.enable_leader_election
        assert dataclasses.asdict(opt) == dataclasses.asdict(
            ref_parse_options(argv))

    def test_compile_ahead_flags_parse(self):
        argv = ["--warmup-buckets", "50000x10000x2000x4",
                "--compile-cache-dir", "/tmp/kbt-cache",
                "--jax-profile-dir", "/tmp/kbt-prof", "--tenancy-shards",
                "2", "--replica-federation", "--shard-lease-duration", "2",
                "--no-priority-class", "--cluster-state", "s.json"]
        opt = parse_options(argv)
        assert opt.warmup_buckets == "50000x10000x2000x4"
        assert opt.compile_cache_dir == "/tmp/kbt-cache"
        assert parse_options([]).warmup_buckets == ""
        # A command line written for the reference parses the same.
        assert dataclasses.asdict(opt) == dataclasses.asdict(
            ref_parse_options(argv))

    def test_malformed_warmup_buckets_fail_boot(self):
        opt = ServerOption(warmup_buckets="not-a-bucket",
                           enable_leader_election=False, listen_address="")
        with pytest.raises(ValueError, match="warmup bucket"):
            runtime(opt)

    def test_leader_election_requires_namespace(self):
        opt = ServerOption(enable_leader_election=True)
        with pytest.raises(ValueError):
            opt.check_option_or_die()

    def test_file_lock_refused_without_opt_in(self, tmp_path):
        """A process-private store cannot host the election, and the
        per-host FileLock is refused without the explicit opt-in."""
        opt = ServerOption(enable_leader_election=True,
                           lock_object_namespace=str(tmp_path),
                           listen_address="")
        rt = runtime(opt)  # self-built private Cluster
        with pytest.raises(ValueError, match="SAME-HOST"):
            rt.run()

    def test_injected_cluster_elects_through_store(self):
        opt = ServerOption(enable_leader_election=True,
                           lock_object_namespace="kube-system",
                           listen_address="", schedule_period=0.1)
        rt = runtime(opt, cluster=Cluster())
        rt.run()
        try:
            assert wait_leader(rt.elector)
            assert rt.cluster.get_lease("kube-system",
                                        "kube-batch-lock")[1]
            # The write fence: the cache refuses writes without a lease.
            assert rt.cache.write_fence == rt.elector.has_live_lease
        finally:
            rt.stop()

    def test_file_lock_allowed_with_opt_in(self, tmp_path):
        opt = ServerOption(enable_leader_election=True,
                           lock_object_namespace=str(tmp_path),
                           listen_address="", file_lock_same_host_ok=True)
        rt = runtime(opt)
        rt.run()
        try:
            assert wait_leader(rt.elector)
        finally:
            rt.stop()

    def test_injected_lease_config_not_mutated(self, tmp_path):
        injected = LeaderElectionConfig(retry_period=0.05)
        assert injected.lock_path == ""
        opt = ServerOption(enable_leader_election=True,
                           lock_object_namespace=str(tmp_path),
                           listen_address="", file_lock_same_host_ok=True)
        rt = runtime(opt, lease_config=injected)
        rt.run()
        try:
            assert wait_leader(rt.elector)
            assert injected.lock_path == ""  # caller's object untouched
            assert rt.elector.config.lock_path.endswith(
                "kube-batch-lock.json")
        finally:
            rt.stop()

    def test_two_standbys_one_file_lock_single_leader(self, tmp_path):
        def mk():
            return runtime(ServerOption(
                enable_leader_election=True,
                lock_object_namespace=str(tmp_path), listen_address="",
                file_lock_same_host_ok=True, schedule_period=0.1))
        a, b = mk(), mk()
        a.run()
        b.run()
        try:
            deadline = time.time() + 10
            while (time.time() < deadline
                   and not (a.elector.is_leader or b.elector.is_leader)):
                time.sleep(0.05)
            time.sleep(1.0)  # give a wrongful second election time to land
            assert a.elector.is_leader != b.elector.is_leader
        finally:
            a.stop()
            b.stop()

    def test_file_lock_flag_parses(self):
        opt = parse_options(["--leader-elect", "--lock-object-namespace",
                             "/tmp", "--leader-elect-file-lock"])
        assert opt.file_lock_same_host_ok


class TestLeaderElection:
    def test_single_candidate_acquires(self, tmp_path):
        events = []
        elector = LeaderElector(
            LeaderElectionConfig(lock_path=str(tmp_path / "lock.json"),
                                 identity="a", retry_period=0.05),
            on_started_leading=lambda: events.append("started"),
            on_stopped_leading=lambda: events.append("stopped"))
        t = threading.Thread(target=elector.run, daemon=True)
        t.start()
        time.sleep(0.3)
        assert elector.is_leader
        assert events == ["started"]
        elector.stop()
        t.join(timeout=2.0)

    def test_second_candidate_blocked_until_lease_expires(self, tmp_path):
        lock = str(tmp_path / "lock.json")
        a = LeaderElector(LeaderElectionConfig(lock_path=lock, identity="a"),
                          lambda: None, lambda: None)
        assert a.try_acquire_or_renew()
        b = LeaderElector(
            LeaderElectionConfig(lock_path=lock, identity="b",
                                 lease_duration=0.2),
            lambda: None, lambda: None)
        assert not b.try_acquire_or_renew()
        with open(lock) as f:
            rec = json.load(f)
        rec["leaseDurationSeconds"] = 0.1
        rec["renewTime"] = time.time() - 1
        with open(lock, "w") as f:
            json.dump(rec, f)
        assert b.try_acquire_or_renew()


class TestServerRuntime:
    def test_end_to_end_with_metrics(self, tmp_path):
        state = {
            "nodes": [{"name": "n1",
                       "allocatable": {"cpu": "8", "memory": "16Gi",
                                       "pods": 110}}],
            "queues": [{"name": "default", "weight": 1}],
            "podGroups": [{"name": "pg1", "namespace": "ns", "minMember": 1,
                           "queue": "default"}],
            "pods": [{"name": "p1", "namespace": "ns", "group": "pg1",
                      "requests": {"cpu": "1", "memory": "1Gi"}}],
        }
        state_file = tmp_path / "cluster.json"
        state_file.write_text(json.dumps(state))
        opt = ServerOption(schedule_period=0.1, listen_address="127.0.0.1:0",
                           enable_leader_election=False,
                           cluster_state=str(state_file))
        rt = runtime(opt)
        rt.run()
        try:
            deadline = time.time() + 30
            while time.time() < deadline:
                pod = rt.cluster.pods.get("ns/p1")
                if pod is not None and pod.spec.node_name:
                    break
                time.sleep(0.1)
            assert rt.cluster.pods["ns/p1"].spec.node_name == "n1"
            port = rt.metrics_server.server_address[1]
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics").read().decode()
            assert "kube_batch_e2e_scheduling_latency_milliseconds" in body
            assert "kube_batch_schedule_attempts_total" in body
            health = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz").read()
            assert health == b"ok"
        finally:
            rt.stop()

    def test_load_cluster_state(self, tmp_path):
        state_file = tmp_path / "s.json"
        state_file.write_text(json.dumps({
            "nodes": [{"name": "x", "allocatable": {"cpu": "1",
                                                    "memory": "1Gi"}}],
            "queues": [{"name": "q", "weight": 3}],
        }))
        cluster = Cluster()
        load_cluster_state(cluster, str(state_file))
        assert "x" in cluster.nodes
        assert cluster.queues["q"].spec.weight == 3

    def test_replica_federation_over_a_shared_store(self):
        """--tenancy-shards with --replica-federation over one injected
        (shared) in-process store: this replica claims every shard
        through the store's leases and releases them on stop."""
        cluster = Cluster()
        opt = ServerOption(enable_leader_election=False,
                           replica_federation=True, tenancy_shards=2,
                           lock_object_namespace="kube-system",
                           listen_address="", schedule_period=0.1,
                           shard_lease_duration=1.0)
        rt = runtime(opt, cluster=cluster)
        assert rt.scheduler.tenancy is not None
        rt.run()
        try:
            deadline = time.time() + 10
            while (time.time() < deadline
                   and rt.shard_leases.owned_shards() != [0, 1]):
                time.sleep(0.05)
            assert rt.shard_leases.owned_shards() == [0, 1]
        finally:
            rt.stop()
        assert rt.shard_leases.owned_shards() == []

    def test_master_boots_over_the_ports_api_server_and_binds(
            self, tmp_path):
        """--master points the runtime at an edge.ApiServer: the store is
        a RemoteCluster, --cluster-state submits over REST, a gang binds
        in the server's store and the runtime stops its reflectors."""
        from kube_batch_tpu_torch.edge import ApiServer, RemoteCluster
        state = {
            "nodes": [{"name": f"n{i}", "allocatable": {
                "cpu": "4", "memory": "8Gi", "pods": 110}}
                for i in range(2)],
            "queues": [{"name": "default", "weight": 1}],
            "podGroups": [{"name": "pg", "namespace": "ns",
                           "minMember": 3, "queue": "default"}],
            "pods": [{"name": f"p{i}", "namespace": "ns", "group": "pg",
                      "requests": {"cpu": "2", "memory": "2Gi"}}
                     for i in range(3)],
        }
        cluster = Cluster()
        server = ApiServer(cluster).start()
        rt = None
        try:
            state_file = str(tmp_path / "state.json")
            with open(state_file, "w") as fh:
                json.dump(state, fh)
            opt = ServerOption(master=server.url, cluster_state=state_file,
                               enable_leader_election=False,
                               listen_address="", schedule_period=0.05)
            rt = runtime(opt)
            assert isinstance(rt.cluster, RemoteCluster)
            with cluster.lock:  # submitted over REST at boot
                assert len(cluster.pods) == 3 and len(cluster.nodes) == 2
            rt.run()
            deadline = time.time() + 30
            while time.time() < deadline:
                with cluster.lock:
                    binds = {k: p.spec.node_name
                             for k, p in cluster.pods.items()}
                    phase = cluster.pod_groups["ns/pg"].status.phase
                if all(binds.values()) and phase == "Running":
                    break
                time.sleep(0.05)
            assert all(binds.values()), binds
            assert phase == "Running"  # the gang's status, over REST
        finally:
            if rt is not None:
                rt.stop()
                assert rt.cluster._stop.is_set()
            server.stop()

    def test_replica_federation_over_master_attaches_a_shard_scope(self):
        """--replica-federation over --master: the shard leases live in
        the API server's store, and the RemoteCluster's reflectors are
        scoped to the owned shards (attach_shard_scope after
        attach_leases)."""
        from kube_batch_tpu_torch.edge import ApiServer, ShardScope
        cluster = Cluster()
        server = ApiServer(cluster).start()
        rt = None
        try:
            opt = ServerOption(master=server.url,
                               enable_leader_election=False,
                               replica_federation=True, tenancy_shards=2,
                               lock_object_namespace="kube-system",
                               listen_address="", schedule_period=0.1,
                               shard_lease_duration=1.0)
            rt = runtime(opt)
            rt.run()
            scope = rt.cluster._scope
            assert isinstance(scope, ShardScope)
            deadline = time.time() + 10
            while (time.time() < deadline
                   and rt.shard_leases.owned_shards() != [0, 1]):
                time.sleep(0.05)
            assert rt.shard_leases.owned_shards() == [0, 1]
            with cluster.lock:  # the leases are server-side objects
                held = {key.split("/", 1)[1] for key in cluster.leases
                        if key.startswith("kube-system/")}
            assert {"kube-batch-shard-0", "kube-batch-shard-1"} <= held
        finally:
            if rt is not None:
                rt.stop()
            server.stop()
        assert rt.shard_leases.owned_shards() == []


def _main(*argv, env=None):
    return subprocess.run(
        [sys.executable, "-m", "kube_batch_tpu_torch.cli.main", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, **(env or {})))


class TestMain:
    def test_version_prints_the_ports_version(self):
        from kube_batch_tpu_torch.version import version_string
        proc = _main("--version")
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip() == version_string()
        assert version_string().startswith("kube-batch-tpu-torch ")

    def test_main_without_a_card_exits_non_zero(self):
        """The daemon runs on the card: with none it exits non-zero with
        resolve_device's message, and never boots on the CPU."""
        proc = _main("--listen-address", "127.0.0.1:0",
                     env={"CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert "no CUDA device is available" in proc.stderr
