"""Server runtime: scheduler startup, boot warmup, /metrics + /debug
endpoints, leader election (kube_batch_tpu/cli/server.py).

``ServerRuntime.run()`` starts the metrics endpoint, then the boot warmup
of K1 and its family for the configured buckets (ops/compile_cache.py,
on a thread beside the scheduler loop), and runs the scheduling loop,
wrapped in leader election when enabled.  The scheduler's default actions
run on ``device`` (the card unless the caller passes the CPU, as the tests
do).  ``--master`` points the runtime at an ``edge.server.ApiServer``:
ingest rides the ``edge.client.RemoteCluster`` reflectors and every
effector verb rides REST, so the store is shared with every other
scheduler pointed at the same server.  The flight-recorder endpoints
(doc/OBSERVABILITY.md) ride the same server:

  /debug                     index of every debug endpoint (JSON)
  /debug/sessions            recent session summaries (JSON)
  /debug/trace?session=<id>  one session as Chrome trace-event JSON
                             (open in Perfetto / chrome://tracing)
  /debug/why?job=<name>      the gating predicate/quota/gang reason for a
                             Pending job, answered from the recorder
  /debug/lineage?pod=<name>  one pod's end-to-end scheduling timeline
                             (ingest -> considered -> placed -> bind ->
                             echo), answered from the lineage ring
  /debug/tenants             per-queue fairness table (share vs
                             deserved, starvation age) from the last
                             session's proportion/drf opens
  /debug/topology            per-pool fragmentation (free nodes,
                             largest contiguous free block, frag
                             ratio) + slice placement outcomes
  /debug/memory              fleet memory ledger: per-subsystem bytes,
                             watermarks (with the session that set
                             them), process RSS, optional tracemalloc
                             top-K (KUBE_BATCH_TPU_MEMTRACE=1)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

import torch

from ..cache import Cluster, new_scheduler_cache
from ..device import resolve_device
from ..metrics import metrics
from ..metrics.metrics import registry
from ..scheduler import Scheduler
from ..trace import export as trace_export
from ..trace import flight_recorder
from .leader_election import (LeaderElectionConfig, LeaderElector,
                              StoreLock)
from .options import ServerOption


class _MetricsHandler(BaseHTTPRequestHandler):
    def do_GET(self):
        parts = urlsplit(self.path)
        path = parts.path
        if path == "/metrics":
            body = registry.expose().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path == "/healthz":
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")
        elif path == "/debug" or path.startswith("/debug/"):
            try:
                self._debug(path, parse_qs(parts.query))
            except Exception:  # a debug read must never kill the server
                metrics.note_swallowed("debug_endpoint")
                self._send_json({"error": "internal error"}, 500)
        else:
            self.send_response(404)
            self.end_headers()

    # One-line description per endpoint: the /debug index page, so
    # operators stop guessing URLs (doc/OBSERVABILITY.md).
    _DEBUG_INDEX = {
        "/debug/sessions": "recent session summaries: phases, verdicts, "
                           "evictions, degraded reasons, floors",
        "/debug/trace?session=<id|latest>": "one session as Chrome "
                           "trace-event JSON (open in ui.perfetto.dev)",
        "/debug/why?job=<[ns/]name>": "why is this job still Pending — "
                           "the gating plugin verdict + solver tally",
        "/debug/lineage?pod=<[ns/]name>": "one pod's end-to-end timeline:"
                           " ingest -> considered -> placed -> bind -> "
                           "echo, with time-to-bind",
        "/debug/tenants": "per-queue fairness: share vs deserved, "
                          "pending demand, starvation age",
        "/debug/shards": "queue-shard tenancy: shard -> owner -> queues "
                         "-> lease expiry, per-shard session counts "
                         "(doc/TENANCY.md)",
        "/debug/topology": "per-pool fragmentation: free nodes, largest "
                           "contiguous free block, frag ratio, slice "
                           "placement outcomes",
        "/debug/memory": "fleet memory ledger: per-subsystem bytes, "
                         "watermarks with owning session, process RSS, "
                         "tracemalloc top-K (KUBE_BATCH_TPU_MEMTRACE=1)",
    }

    def _debug(self, path: str, query: dict) -> None:
        """The flight-recorder read endpoints.  Read-only: everything is
        answered from recorded traces, nothing re-runs."""
        from ..metrics.tenants import tenant_table
        from ..trace import pod_lineage

        if path in ("/debug", "/debug/"):
            self._send_json({"endpoints": self._DEBUG_INDEX,
                             "tracing_enabled": _trace_enabled(),
                             "lineage": pod_lineage.summary()})
        elif path == "/debug/lineage":
            pod = (query.get("pod") or [""])[0]
            if not pod:
                self._send_json({"error": "pass ?pod=<[namespace/]name>"},
                                400)
                return
            answer = pod_lineage.lineage(pod)
            if answer is None:
                self._send_json(
                    {"pod": pod,
                     "error": "not in the lineage ring: the pod was "
                              "never ingested Pending, aged out of the "
                              "ring, or lineage is disabled "
                              "(KUBE_BATCH_TPU_LINEAGE=0)"}, 404)
                return
            self._send_json(answer)
        elif path == "/debug/tenants":
            self._send_json(tenant_table.snapshot())
        elif path == "/debug/shards":
            from ..tenancy import shard_table
            doc = shard_table.snapshot()
            doc["rebalances"] = metrics.shard_rebalance_counts()
            self._send_json(doc)
        elif path == "/debug/topology":
            from ..models.topology import topo_table
            doc = topo_table.snapshot()
            doc["slices"] = metrics.topo_slice_counts()
            self._send_json(doc)
        elif path == "/debug/memory":
            from ..metrics import memledger
            self._send_json(memledger.debug_doc())
        elif path == "/debug/sessions":
            self._send_json({"sessions": flight_recorder.summaries(),
                             "capacity": flight_recorder.capacity,
                             "evictions_total":
                                 metrics.evictions_by_action(),
                             # Mirror-memory accounting (ROADMAP item 1):
                             # retained raw-doc delta baselines per
                             # resource kind ({} for in-process caches).
                             "wire_baseline_bytes":
                                 metrics.wire_baseline_totals(),
                             "tracing_enabled":
                                 _trace_enabled()})
        elif path == "/debug/trace":
            raw = (query.get("session") or [""])[0]
            trace = None
            if raw == "latest":
                trace = flight_recorder.latest()
            elif raw.isdigit():
                trace = flight_recorder.get(int(raw))
            if trace is None:
                self._send_json(
                    {"error": "unknown session; pass ?session=<id> from "
                              "/debug/sessions (or session=latest)"}, 404)
                return
            self._send_json(trace_export.to_chrome_trace(trace))
        elif path == "/debug/why":
            job = (query.get("job") or [""])[0]
            if not job:
                self._send_json({"error": "pass ?job=<name>"}, 400)
                return
            answer = flight_recorder.why(job)
            if answer is None:
                self._send_json(
                    {"job": job,
                     "error": "no recorded verdict: the job was absent, "
                              "schedulable, or tracing is disabled "
                              "(KUBE_BATCH_TPU_TRACE=0)"}, 404)
                return
            self._send_json(answer)
        else:
            self.send_response(404)
            self.end_headers()

    def _send_json(self, obj, status: int = 200) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # quiet
        pass


def _trace_enabled() -> bool:
    from ..trace import spans
    return spans.enabled()


def start_metrics_server(listen_address: str) -> ThreadingHTTPServer:
    """Serve /metrics like server.go:83-86; returns the server (its port is
    discoverable via .server_address for ':0' style binds)."""
    host, _, port = listen_address.rpartition(":")
    server = ThreadingHTTPServer((host or "0.0.0.0", int(port or 8080)),
                                 _MetricsHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def stop_metrics_server(server: ThreadingHTTPServer) -> None:
    """Tear down a start_metrics_server() server: stops serve_forever
    (the serving thread exits with it) and closes the listening socket —
    shutdown() alone leaks the bound port for the life of the process."""
    server.shutdown()
    server.server_close()


def load_cluster_state(cluster: Cluster, path: str) -> None:
    """Populate the simulator from a JSON snapshot file (the standalone
    analog of pointing --master at an API server)."""
    from ..api.objects import (Container, Node, NodeSpec, NodeStatus,
                               ObjectMeta, Pod, PodSpec, PodStatus)
    from ..apis.scheduling import v1alpha1

    with open(path) as f:
        state = json.load(f)
    for n in state.get("nodes", []):
        cluster.create_node(Node(
            metadata=ObjectMeta(name=n["name"], labels=n.get("labels", {})),
            spec=NodeSpec(),
            status=NodeStatus(allocatable=n.get("allocatable", {}),
                              capacity=n.get("capacity",
                                             n.get("allocatable", {})))))
    for q in state.get("queues", []):
        cluster.create_queue(v1alpha1.Queue(
            metadata=ObjectMeta(name=q["name"]),
            spec=v1alpha1.QueueSpec(weight=q.get("weight", 1))))
    for pg in state.get("podGroups", []):
        cluster.create_pod_group(v1alpha1.PodGroup(
            metadata=ObjectMeta(name=pg["name"],
                                namespace=pg.get("namespace", "default")),
            spec=v1alpha1.PodGroupSpec(
                min_member=pg.get("minMember", 1),
                queue=pg.get("queue", "default"))))
    for p in state.get("pods", []):
        annotations = {}
        if p.get("group"):
            annotations[v1alpha1.GroupNameAnnotationKey] = p["group"]
        cluster.create_pod(Pod(
            metadata=ObjectMeta(name=p["name"],
                                namespace=p.get("namespace", "default"),
                                annotations=annotations),
            spec=PodSpec(node_name=p.get("nodeName", ""),
                         containers=[Container(requests=p.get("requests", {}))]),
            status=PodStatus(phase=p.get("phase", "Pending"))))


class ServerRuntime:
    """The running process: cluster edge + scheduler + metrics endpoint.
    ``device`` and ``dtype`` go to the Scheduler and the warmup: ``None``
    is the card (``device.resolve_device``, which raises without one)."""

    def __init__(self, opt: ServerOption, cluster: Optional[Cluster] = None,
                 lease_config: Optional[LeaderElectionConfig] = None, *,
                 device=None, dtype: torch.dtype = torch.float32):
        self.opt = opt
        self._lease_config = lease_config
        self.device = resolve_device(device)
        # Compile-ahead subsystem (ops/compile_cache.py): point K1's build
        # at the configured directory BEFORE anything can build it (so
        # the build persists across restarts), and parse the warmup
        # buckets now — a malformed flag must fail boot, not the first
        # session.  The warmup thread itself starts in run().
        self.warmup = None
        self._warmup_buckets = []
        if opt.compile_cache_dir:
            from ..ops.compile_cache import enable_persistent_cache
            enable_persistent_cache(opt.compile_cache_dir)
        if opt.warmup_buckets:
            from ..ops.compile_cache import parse_warmup_buckets
            self._warmup_buckets = parse_warmup_buckets(opt.warmup_buckets)
        if opt.jax_profile_dir:
            # The torch.profiler hook reads PROFILE_ENV per session
            # (actions/tpu_allocate.py): the flag, under the reference's
            # name, is just its configuration surface.
            import os
            from ..actions.tpu_allocate import PROFILE_ENV
            os.environ[PROFILE_ENV] = opt.jax_profile_dir
        # Whether the backing store is SHARED with other standbys — the
        # precondition for a store-hosted election lock.  An injected
        # cluster is shared by construction (the embedder hands the same
        # object/edge to every runtime); a --master edge is shared by the
        # server behind it; a self-built in-process Cluster is private to
        # this process, so a lease in it would only ever elect ourselves.
        self._cluster_shared = True
        self._owns_edge = False
        if cluster is not None:
            self.cluster = cluster
        elif opt.master:
            # The network edge (reference server.go:55-60 buildConfig):
            # --master points at an edge.server.ApiServer; ingest and
            # effectors ride HTTP instead of the in-process store.
            from ..edge import RemoteCluster
            self.cluster = RemoteCluster(opt.master).start()
            self._owns_edge = True
        else:
            self.cluster = Cluster()
            self._cluster_shared = False
        if opt.cluster_state:
            # Works against both edges: RemoteCluster exposes the same
            # create verbs over REST, so a seed file submits remotely too.
            load_cluster_state(self.cluster, opt.cluster_state)
        self.cache = new_scheduler_cache(
            self.cluster, scheduler_name=opt.scheduler_name,
            default_queue=opt.default_queue,
            priority_class_enabled=opt.priority_class)
        conf_str = None
        if opt.scheduler_conf:
            with open(opt.scheduler_conf) as f:
                conf_str = f.read()
        self.scheduler = Scheduler(self.cache, scheduler_conf=conf_str,
                                   schedule_period=opt.schedule_period,
                                   device=self.device, dtype=dtype)
        # Queue-shard tenancy by flag (doc/TENANCY.md): the env route
        # (KUBE_BATCH_TPU_TENANCY) already built an engine inside the
        # Scheduler; --tenancy-shards builds one here when it did not.
        if opt.tenancy_shards and self.scheduler.tenancy is None:
            from ..tenancy import ShardMap, TenancyEngine
            self.scheduler.tenancy = TenancyEngine(
                self.scheduler, ShardMap.from_env(opt.tenancy_shards))
        self.metrics_server: Optional[ThreadingHTTPServer] = None
        self.elector: Optional[LeaderElector] = None
        self.shard_leases = None  # Optional[tenancy.ShardLeaseManager]

    def run(self) -> None:
        """server.go Run(): metrics endpoint, then leader-elect or start."""
        if self.opt.listen_address:
            self.metrics_server = start_metrics_server(self.opt.listen_address)
        if self._warmup_buckets:
            # Warm the solver family for the configured buckets in the
            # background: the scheduler loop starts immediately, and the
            # first live session of a warmed bucket that the warmup has
            # finished meets a built library and a warmed signature (one
            # that races the warmup is a miss, as in the reference).  A
            # standby wins doubly — by the time it acquires the lease
            # its warmup is done (or its library already on disk).  The
            # cfg is derived from the LOADED conf (the key carries it, as
            # the reference's does); a conf that needs the host fallback
            # skips warmup entirely.
            from ..models.tensor_snapshot import solver_config_from_tiers
            cfg = solver_config_from_tiers(self.scheduler.tiers)
            if cfg is not None:
                from ..ops.compile_cache import SolverWarmup
                self.warmup = SolverWarmup(
                    self._warmup_buckets, cfg=cfg,
                    cache_dir=self.opt.compile_cache_dir or None,
                    device=self.scheduler.device,
                    dtype=self.scheduler.dtype).start()
        if self.opt.replica_federation:
            # Active-active federation (doc/TENANCY.md): no global
            # leader — this replica claims queue-shards via per-shard
            # CAS leases in the SHARED store and schedules exactly what
            # it owns; the shard lease fences each shard's write egress
            # the way the global write fence fences a lost leadership.
            self.opt.check_option_or_die()
            engine = self.scheduler.tenancy
            if engine is None:
                raise ValueError(
                    "--replica-federation requires the tenancy engine: "
                    "pass --tenancy-shards N (or KUBE_BATCH_TPU_TENANCY)")
            if not (self._cluster_shared
                    and hasattr(self.cluster, "cas_lease")):
                raise ValueError(
                    "replica federation needs a SHARED store for its "
                    "shard leases (point every replica at one cluster "
                    "edge via --master); a process-private store would "
                    "elect this replica onto every shard in its own "
                    "world")
            from ..tenancy import ShardLeaseManager
            duration = self.opt.shard_lease_duration
            self.shard_leases = ShardLeaseManager(
                self.cluster, self.opt.lock_object_namespace,
                engine.map.num_shards,
                lease_duration=duration,
                renew_deadline=duration * 0.6,
                retry_period=max(0.05, duration / 5.0))
            engine.attach_leases(self.shard_leases)
            # Shard-filtered ingest (doc/INGEST.md): over the HTTP edge,
            # scope the reflectors to the shards this replica owns.
            # MUST come after attach_leases — attach_shard_scope pins
            # the lease manager's load-based shed off (a filtered
            # mirror undercounts foreign load) and chains its
            # ownership-change hook.
            from ..edge import RemoteCluster, attach_shard_scope
            if isinstance(self.cluster, RemoteCluster):
                attach_shard_scope(self.cluster, engine.map,
                                   self.shard_leases)
            self.shard_leases.start()
            self.scheduler.run()
        elif self.opt.enable_leader_election:
            self.opt.check_option_or_die()
            # The HA lock lives IN THE STORE whenever the cluster edge
            # supports leases (in-process simulator or the HTTP edge) —
            # kube-batch's ConfigMap lock: any standby pointing at the
            # same store can take over.  The lock file remains the
            # fallback for bare shared-filesystem runs.
            if self._cluster_shared and hasattr(self.cluster, "cas_lease"):
                lock = StoreLock(self.cluster,
                                 self.opt.lock_object_namespace)
                config = self._lease_config or LeaderElectionConfig()
            else:
                # A process-private store cannot host the election lock
                # (every standby would elect itself in its own world), so
                # HA falls to the lock FILE.  But FileLock's flock CAS is
                # coherent per-host only; two standbys on different hosts
                # over NFS/SMB could dual-acquire.  Refuse at config time
                # unless the deployment explicitly accepts same-host
                # failover — by flag, or by injecting a lease_config with
                # its own lock_path (already a deliberate opt-in).
                # Reference analog: HA is always store-locked,
                # server.go:115-139.
                if (not self.opt.file_lock_same_host_ok
                        and not (self._lease_config is not None
                                 and self._lease_config.lock_path)):
                    raise ValueError(
                        "leader election needs a SHARED store for its "
                        "lock, but this runtime's store is process-"
                        "private (or has no lease support); the file-"
                        "lock fallback is safe for SAME-HOST standbys "
                        "only (flock coherence is per-host on network "
                        "filesystems).  Point every standby at one "
                        "cluster edge (--master), or pass "
                        "--leader-elect-file-lock to accept same-host-"
                        "only failover.")
                default_path = (f"{self.opt.lock_object_namespace}/"
                                f"kube-batch-lock.json")
                if self._lease_config is None:
                    config = LeaderElectionConfig(lock_path=default_path)
                elif not self._lease_config.lock_path:
                    # Timing-only injected config: fill the default on a
                    # COPY — the caller's dataclass may be shared across
                    # runtimes and must not be mutated from here.
                    import dataclasses
                    config = dataclasses.replace(self._lease_config,
                                                 lock_path=default_path)
                else:
                    config = self._lease_config
                lock = None
            self.elector = LeaderElector(
                config,
                on_started_leading=self.scheduler.run,
                on_stopped_leading=self.scheduler.stop,
                lock=lock)
            # Write fence: scheduler.stop() only signals the loop; an
            # in-flight cycle would still bind/evict after a standby took
            # the lease.  The cache refuses cluster writes the moment the
            # lease is stale — wall-clock-based (has_live_lease), so a
            # process pause past the deadline fences even before the
            # elector thread wakes (the reference fences by process exit,
            # server.go:135-137).
            self.cache.write_fence = self.elector.has_live_lease
            threading.Thread(target=self.elector.run, daemon=True).start()
        else:
            self.scheduler.run()

    def stop(self) -> None:
        if self.warmup is not None:
            # Signal between buckets; a build in flight cannot be
            # interrupted, so don't block shutdown on it (daemon thread).
            self.warmup.stop(timeout=0.5)
        if self.elector is not None:
            self.elector.stop()
        self.scheduler.stop()
        if self.shard_leases is not None:
            # AFTER the loop stops (no further egress), release every
            # owned shard so surviving replicas claim immediately
            # instead of waiting out the expiry.
            self.shard_leases.stop(release=True)
        recorder = getattr(self.cache, "event_recorder", None)
        if recorder is not None and hasattr(recorder, "stop"):
            recorder.stop()
        if self.metrics_server is not None:
            stop_metrics_server(self.metrics_server)
        if self._owns_edge:
            # The reflectors of the edge this runtime built (an injected
            # store belongs to its caller) are told to stop here, so a
            # stopped runtime stops watching the server.
            self.cluster.stop()
