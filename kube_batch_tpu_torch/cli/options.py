"""CLI options (kube_batch_tpu/cli/options.py).

Every flag of the reference, with its name and default, so a command line
written for the reference boots the port unchanged (schedule-period 1s,
default-queue "default", listen address :8080).  Two flags keep the
reference's names for the port's counterparts: ``--compile-cache-dir`` is
the directory of K1's built library and the warmup manifest
(ops/compile_cache.py), and ``--jax-profile-dir`` sets
``KUBE_BATCH_TPU_PROFILE``, the port's ``torch.profiler`` trace of each
session.  ``--master`` points the daemon at an ``edge.server.ApiServer``
(the port's or the reference's: the wire is the same).  There is no
device flag: the daemon runs on the card.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field

DEFAULT_SCHEDULER_NAME = "kube-batch"
DEFAULT_SCHEDULE_PERIOD = 1.0
DEFAULT_QUEUE = "default"
DEFAULT_LISTEN_ADDRESS = ":8080"


@dataclass
class ServerOption:
    master: str = ""
    kubeconfig: str = ""
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    scheduler_conf: str = ""
    schedule_period: float = DEFAULT_SCHEDULE_PERIOD
    default_queue: str = DEFAULT_QUEUE
    enable_leader_election: bool = True
    lock_object_namespace: str = ""
    print_version: bool = False
    listen_address: str = DEFAULT_LISTEN_ADDRESS
    priority_class: bool = True
    # Explicit opt-in to the per-host FileLock HA backend (flock
    # coherence does not span hosts on common network filesystems; see
    # leader_election.FileLock).  Without it, a cluster edge that cannot
    # host a store lock refuses leader election at config time.
    file_lock_same_host_ok: bool = False
    # Simulator extras (no reference counterpart): cluster spec to load.
    cluster_state: str = ""
    # Compile-ahead subsystem (ops/compile_cache.py): solver buckets to
    # warm at boot, and the directory of K1's library so its build
    # survives restarts and leader failover.
    warmup_buckets: str = ""
    compile_cache_dir: str = ""
    # Observability: direct torch.profiler at a directory to capture a
    # CPU + CUDA trace of every session (actions/tpu_allocate.PROFILE_ENV
    # hook); the reference's flag name is kept.
    jax_profile_dir: str = ""
    # Queue-shard tenancy engine + active-active replica federation
    # (tenancy/, doc/TENANCY.md): shard count (0 defers
    # to KUBE_BATCH_TPU_TENANCY / disabled), per-shard CAS leases in the
    # shared store instead of one global leader, and the shard lease
    # timing (renew deadline is derived as 3/5 of the duration, the
    # global elector's 15s/10s/5s ratio).
    tenancy_shards: int = 0
    replica_federation: bool = False
    shard_lease_duration: float = 5.0

    def check_option_or_die(self) -> None:
        """options.go:81-88: leader election requires a lock namespace."""
        if self.enable_leader_election and not self.lock_object_namespace:
            raise ValueError(
                "lock-object-namespace must not be nil when LeaderElection is enabled")
        if self.replica_federation:
            if self.enable_leader_election:
                raise ValueError(
                    "--replica-federation replaces --leader-elect: "
                    "per-shard leases ARE the election — enable one, "
                    "not both (doc/TENANCY.md)")
            if not self.lock_object_namespace:
                raise ValueError(
                    "lock-object-namespace must not be nil when replica "
                    "federation is enabled (the shard leases live there)")
            if self.shard_lease_duration <= 0:
                raise ValueError("shard-lease-duration must be > 0")


def add_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--master", default="",
                        help="The address of the cluster state server")
    parser.add_argument("--kubeconfig", default="",
                        help="Path to a cluster connection config file")
    parser.add_argument("--scheduler-name", default=DEFAULT_SCHEDULER_NAME,
                        help="Only schedule pods with this schedulerName")
    parser.add_argument("--scheduler-conf", default="",
                        help="Path to the YAML scheduler configuration")
    parser.add_argument("--schedule-period", type=float,
                        default=DEFAULT_SCHEDULE_PERIOD,
                        help="Seconds between scheduling cycles")
    parser.add_argument("--default-queue", default=DEFAULT_QUEUE,
                        help="Queue for jobs that specify none")
    parser.add_argument("--leader-elect", action="store_true", default=False,
                        help="Enable leader election for HA deployments")
    parser.add_argument("--lock-object-namespace", default="",
                        help="Namespace of the leader-election lock object")
    parser.add_argument("--version", action="store_true", default=False,
                        help="Print version and exit")
    parser.add_argument("--listen-address", default=DEFAULT_LISTEN_ADDRESS,
                        help="Address for the /metrics endpoint")
    parser.add_argument("--priority-class", dest="priority_class",
                        action="store_true", default=True,
                        help="Enable PriorityClass-based job priority")
    parser.add_argument("--no-priority-class", dest="priority_class",
                        action="store_false",
                        help="Disable PriorityClass-based job priority")
    parser.add_argument("--leader-elect-file-lock", dest="file_lock",
                        action="store_true", default=False,
                        help="Accept the file-based election lock (flock "
                             "coherence is PER-HOST: safe only for "
                             "same-host standbys or a flock-coherent "
                             "shared filesystem)")
    parser.add_argument("--cluster-state", default="",
                        help="Path to a JSON cluster snapshot for the simulator")
    parser.add_argument("--warmup-buckets", default="",
                        help="Comma-separated TASKSxNODES[xJOBS[xQUEUES]] "
                             "shape buckets to warm the solver family for "
                             "at boot (e.g. 50000x10000x2000x4), so no "
                             "live session pays the kernel's first build, "
                             "load and launch")
    parser.add_argument("--compile-cache-dir", default="",
                        help="Directory of the session kernel's built "
                             "library and the warmup manifest; the build "
                             "survives process restarts and leader "
                             "failover")
    parser.add_argument("--tenancy-shards", type=int, default=0,
                        help="Queue-shard count for the tenancy engine: "
                             "per-tenant micro-sessions pipeline per "
                             "shard instead of one global cycle "
                             "(0 defers to KUBE_BATCH_TPU_TENANCY; "
                             "doc/TENANCY.md)")
    parser.add_argument("--replica-federation", action="store_true",
                        default=False,
                        help="Active-active replicas: claim queue-shards "
                             "via per-shard CAS leases in the shared "
                             "store (replaces --leader-elect; requires "
                             "--tenancy-shards and "
                             "--lock-object-namespace)")
    parser.add_argument("--shard-lease-duration", type=float, default=5.0,
                        help="Per-shard lease duration in seconds; an "
                             "orphaned shard is stolen within one "
                             "duration of its owner's death")
    parser.add_argument("--jax-profile-dir", default="",
                        help="Capture a torch.profiler trace (CPU + "
                             "CUDA) of each session into this directory "
                             "(Perfetto-loadable); empty disables "
                             "profiling")


def parse_options(argv=None) -> ServerOption:
    parser = argparse.ArgumentParser(prog="kube-batch-tpu-torch")
    add_flags(parser)
    ns = parser.parse_args(argv)
    return ServerOption(
        master=ns.master, kubeconfig=ns.kubeconfig,
        scheduler_name=ns.scheduler_name, scheduler_conf=ns.scheduler_conf,
        schedule_period=ns.schedule_period, default_queue=ns.default_queue,
        enable_leader_election=ns.leader_elect,
        lock_object_namespace=ns.lock_object_namespace,
        print_version=ns.version, listen_address=ns.listen_address,
        priority_class=ns.priority_class,
        file_lock_same_host_ok=ns.file_lock,
        cluster_state=ns.cluster_state,
        warmup_buckets=ns.warmup_buckets,
        compile_cache_dir=ns.compile_cache_dir,
        jax_profile_dir=ns.jax_profile_dir,
        tenancy_shards=ns.tenancy_shards,
        replica_federation=ns.replica_federation,
        shard_lease_duration=ns.shard_lease_duration)
