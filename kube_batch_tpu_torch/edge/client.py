"""RemoteCluster: the client-go analog over the REST edge.

A reflector per watched resource streams list+watch events from
edge.server.ApiServer into local mirror stores and Informer fan-outs, so
``cache.cluster.new_scheduler_cache(RemoteCluster(url).start())`` wires a
SchedulerCache to a REMOTE cluster exactly as it wires to the in-process
simulator — same informers in (cache.go:255-352), and the effector verbs
(bind/evict/status, cache.go:425-535) become REST calls out.
"""

from __future__ import annotations

import http.client
import json
import logging
import socket
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from typing import Dict, Optional
from urllib.parse import quote as _quote

from ..api import objects as _objects
from ..cache.cluster import Informer
from ..cache.interface import AmbiguousOutcomeError
from ..chaos import plan as chaos_plan
from ..metrics import memledger, metrics
from . import baseline as baseline_store
from . import codec, codec_k8s, wire_shard

_LOG = logging.getLogger(__name__)

# Watch reconnect backoff (doc/CHAOS.md "Graceful degradation"): a
# flapping or erroring stream backs off exponentially instead of
# hammering the server twice a second forever; a successful sync resets.
_WATCH_BACKOFF_BASE_S = 0.1
_WATCH_BACKOFF_CAP_S = 5.0


class _NodelayConnection(http.client.HTTPConnection):
    """Keep-alive connection with Nagle off: headers and body go out as
    separate small sends, and without NODELAY the second send can sit
    behind Nagle until the server's delayed ACK (~40 ms per request).
    Subclassed so the retry path's auto-reconnect keeps the option."""

    def connect(self):
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class _NodelayHTTPSConnection(http.client.HTTPSConnection):
    def connect(self):
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

_WATCHED = ("pods", "nodes", "podgroups", "queues", "priorityclasses",
            "pdbs")

# Kubernetes-convention collection paths (wire="k8s"): the scheduler
# speaks the same path grammar client-go does against a real apiserver.
_K8S_PATHS = {
    "pods": "/api/v1/pods",
    "nodes": "/api/v1/nodes",
    "events": "/api/v1/events",
    "pvcs": "/api/v1/persistentvolumeclaims",
    "priorityclasses": "/apis/scheduling.k8s.io/v1/priorityclasses",
    "pdbs": "/apis/policy/v1beta1/poddisruptionbudgets",
    "podgroups": "/apis/scheduling.incubator.k8s.io/v1alpha1/podgroups",
    "queues": "/apis/scheduling.incubator.k8s.io/v1alpha1/queues",
}

_MISSING = object()


class _PvcStore(dict):
    """PVC mirror that refetches the remote list on a miss (PVCs have no
    watch stream; volume binding must still see late-created claims).
    Misses are negative-cached for a few seconds: the refetch can run
    while the caller holds RemoteCluster.lock, so a pod referencing a
    genuinely absent PVC must not stall reflector ingest every cycle."""

    _NEG_TTL = 5.0

    def __init__(self, remote: "RemoteCluster"):
        super().__init__()
        self._remote = remote
        self._neg: Dict[str, float] = {}

    def replace(self, items) -> None:
        self.clear()
        self.update(items)
        self._neg.clear()

    def get(self, key, default=None):
        import time as _time
        value = dict.get(self, key)
        if value is None:
            now = _time.monotonic()
            if self._neg.get(key, 0.0) > now:
                return default
            try:
                self._remote._refresh_pvcs()
            except (OSError, KeyError):  # _request maps HTTPError→KeyError
                return default
            value = dict.get(self, key, default)
            if value is default:
                self._neg[key] = now + self._NEG_TTL
        return value

    # Mapping syntax must see the same on-miss refetch + negative cache
    # as .get(), so future callers can't silently read a stale miss.
    def __getitem__(self, key):
        value = self.get(key, _MISSING)
        if value is _MISSING:
            raise KeyError(key)
        return value

    def __contains__(self, key):
        return self.get(key, _MISSING) is not _MISSING


def _key_fn(resource: str):
    if resource in ("pods", "podgroups", "pdbs", "pvcs"):
        return lambda o: f"{o.metadata.namespace}/{o.metadata.name}"
    if resource == "nodes":
        return lambda o: o.name
    return lambda o: o.metadata.name


def _raw_key(resource: str, doc) -> str:
    """The mirror-store key straight from the RAW wire doc (both wire
    formats carry ``metadata`` as a plain dict) — the fast path must find
    the previous object BEFORE any decode runs.  Must agree with
    ``_key_fn`` of the decoded object; KeyError/TypeError on a malformed
    doc routes the frame to the full decode path."""
    md = doc["metadata"]
    if resource in ("pods", "podgroups", "pdbs", "pvcs"):
        return f"{md.get('namespace', 'default')}/{md['name']}"
    # nodes key on o.name == metadata.name (api/objects.Node.name);
    # queues/priorityclasses key on metadata.name directly.
    return md["name"]


#: Flat per-object shell estimate for a mirrored dataclass (pod shell +
#: metadata strings, excluding the separately-ledgered `_wire_doc`
#: baseline).  The mirror ledger's hook AND its auditor both price
#: objects at this constant, so the audit checks hook coverage, not
#: estimate quality (doc/OBSERVABILITY.md "Memory ledger").
_MIRROR_OBJ_EST = 512


def _mirror_actual_nbytes(c: "RemoteCluster") -> int:
    """Audit sizer: recompute the mirror ledger from the live stores."""
    with c.lock:
        return sum(len(c._store(r)) for r in _WATCHED) * _MIRROR_OBJ_EST


def _pending_actual_nbytes(c: "RemoteCluster") -> int:
    """Audit sizer: raw bytes of every deferred lazy-mirror frame."""
    with c.lock:
        return sum(entry[3] for pend in c._pending.values()
                   for entry in pend.values())


def _baseline_actual_nbytes(c: "RemoteCluster") -> int:
    """Audit sizer: `_wire_nbytes` actually retained on mirror objects
    — the same truth `audit_baseline_bytes` reconciles per kind."""
    with c.lock:
        return sum(getattr(o, "_wire_nbytes", 0)
                   for r in _WATCHED for o in c._store(r).values())


class RemoteCluster:
    """Duck-types the Cluster surface the scheduler wiring consumes:
    ``*_informer`` fan-outs + mirror stores (ingest) and the effector
    verbs (egress), all over HTTP.

    Memory accounting (metrics/memledger.py):
    # mem-ledger: mirror
    # mem-ledger: pending
    # mem-ledger: baseline
    """

    def __init__(self, base_url: str, timeout: float = 10.0,
                 wire: str = "native"):
        """``wire="k8s"`` speaks Kubernetes API conventions end to end:
        /api + /apis paths, camelCase kind/apiVersion bodies
        (codec_k8s), the Binding subresource for binds, and merge-patch
        for the stuck-pod condition writeback — the full client-go
        surface (SURVEY.md §2.2) instead of the native /v1 codec."""
        if wire not in ("native", "k8s"):
            raise ValueError(f"unknown wire mode {wire!r}")
        self.wire = wire
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.lock = threading.RLock()
        # Mirror stores: written by six reflector threads, read by the
        # scheduler's resync path — guarded-by enforced by graftlint.
        self.pods: Dict[str, object] = {}              # guarded-by: lock
        self.nodes: Dict[str, object] = {}             # guarded-by: lock
        self.pod_groups: Dict[str, object] = {}        # guarded-by: lock
        self.queues: Dict[str, object] = {}            # guarded-by: lock
        self.priority_classes: Dict[str, object] = {}  # guarded-by: lock
        self.pdbs: Dict[str, object] = {}              # guarded-by: lock
        self.pvcs = _PvcStore(self)
        self.pod_informer = Informer()
        self.node_informer = Informer()
        self.pod_group_informer = Informer()
        self.queue_informer = Informer()
        self.priority_class_informer = Informer()
        self.pdb_informer = Informer()
        self._stop = threading.Event()
        self._threads = []
        self._synced: Dict[str, threading.Event] = {}
        # Retained raw-doc baseline memory, per resource kind (ROADMAP
        # item 1 accounting): the wire fast path keeps each mirror
        # object's raw wire doc (`_wire_doc`, edge/codec.py) as its
        # delta baseline — roughly one raw dict per pod.  Each frame's
        # byte length approximates its doc's retained footprint; the
        # running per-kind totals land on the
        # ``kube_batch_wire_baseline_bytes{kind}`` gauge so the 1M-pod
        # memory-budget work has a measurable target.  One int per
        # resource, written only by that resource's reflector thread.
        self._baseline_bytes: Dict[str, int] = {
            r: 0 for r in _WATCHED}
        # Shard-scoped ingest (edge/wire_shard.py, doc/INGEST.md): once
        # a ShardScope attaches, pods split into the unassigned (scoped)
        # + assigned (occupancy) streams and podgroups filter by queue.
        self._scope = None  # attach_scope(); read per frame, no lock
        self._selector_warned: set = set()  # guarded-by: lock
        # Cumulative watch bytes per reflector stream key ("pods",
        # "pods@assigned", ...) — each stream's thread is its key's only
        # writer; ingest_bytes() folds the streams per resource.
        self._ingest_bytes: Dict[str, int] = {}
        # Lazy mirror (doc/INGEST.md): deferred MODIFIED pod frames,
        # {resource: {key: [prev_obj, doc, frame_ts, nbytes]}} — the raw
        # doc waits here until flush_pending() materializes it at the
        # session/debug chokepoint.  guarded-by: lock
        self._pending: Dict[str, Dict[str, list]] = {"pods": {}}
        # Wake hook the cache wiring installs (cache._note_churn): a
        # deferred frame still dirties its queue's shard at receipt so
        # the scheduler loop wakes.  None = no flush consumer is wired,
        # so ingest stays fully eager (lazy-mirror validity rule).
        self.pending_churn = None
        # Baseline byte budgets (edge/baseline.py) + per-kind LRU of
        # retained baselines, cold end first.  guarded-by: lock
        self._baseline_budget = baseline_store.parse_budgets()
        self._budget: Dict[str, Optional[int]] = {
            r: baseline_store.budget_for(self._baseline_budget, r)
            for r in _WATCHED}
        self._baseline_lru: Dict[str, OrderedDict] = {
            r: OrderedDict() for r in _WATCHED}
        # Fleet memory ledger components (metrics/memledger.py), keyed
        # to this client's lifetime: mirror prices dataclass shells at
        # a flat estimate, pending carries the deferred frames' raw
        # bytes, baseline absorbs the per-kind ``_baseline_bytes``
        # totals behind kube_batch_wire_baseline_bytes.  The auditors
        # recompute each from the stores under ``lock``.
        self._mem_mirror = memledger.ledger("mirror").track(
            self, sizer=_mirror_actual_nbytes)
        self._mem_pending = memledger.ledger("pending").track(
            self, sizer=_pending_actual_nbytes)
        self._mem_baseline = memledger.ledger("baseline").track(
            self, sizer=_baseline_actual_nbytes)

    # -- ingest: reflectors -------------------------------------------------

    def _store(self, resource: str) -> Dict[str, object]:
        return {"pods": self.pods, "nodes": self.nodes,
                "podgroups": self.pod_groups, "queues": self.queues,
                "priorityclasses": self.priority_classes,
                "pdbs": self.pdbs, "pvcs": self.pvcs}[resource]

    def _informer(self, resource: str) -> Informer:
        return {"pods": self.pod_informer, "nodes": self.node_informer,
                "podgroups": self.pod_group_informer,
                "queues": self.queue_informer,
                "priorityclasses": self.priority_class_informer,
                "pdbs": self.pdb_informer}[resource]

    def _reflect(self, resource: str, stream: Optional[str] = None) -> None:
        """One reflector: stream watch events into the mirror + informer.
        A fresh connect replays the server's current state as ADDED
        events ending in SYNC (objects deleted during a disconnect are
        reconciled out of the mirror then — client-go's relist).  A
        RECONNECT resumes from the last seen resourceVersion: the server
        replays only the missed delta (RESUMED frame, no reconciliation),
        or answers ERROR 410 when the client fell past its event buffer,
        forcing a full relist — the k8s list+watch contract.

        ``stream`` is the shard-scoped pod split (doc/INGEST.md): None
        serves the whole collection (the legacy single stream; once a
        ShardScope attaches it carries the UNASSIGNED half, scoped by
        queue), "assigned" is the static bound-pod occupancy stream.
        A scoped connection records the scope epoch its selector came
        from; a lease claim/steal/shed bumps the epoch and the next
        frame (keep-alive PINGs bound the wait) forces a reconnect
        WITHOUT a resume version — the full scoped relist whose SYNC
        reconciliation purges the shed shard and admits the gained
        one."""
        store = self._store(resource)
        informer = self._informer(resource)
        key_of = _key_fn(resource)
        skey = f"{resource}@{stream}" if stream else resource
        base = f"{self.base_url}{self._collection(resource)}?watch=1"
        last_rv = 0
        backoff = _WATCH_BACKOFF_BASE_S
        while not self._stop.is_set():
            replay_seen = set()
            replaying = True
            suffix, scope_epoch, domain = self._watch_params(resource,
                                                             stream)
            url = base + suffix + (f"&resourceVersion={last_rv}"
                                   if last_rv else "")
            try:
                # Read timeout >> the server's 5s keep-alive ping: a
                # half-open connection surfaces as socket.timeout (OSError)
                # and reconnects instead of freezing the mirror forever.
                with urllib.request.urlopen(url, timeout=30) as resp:
                    for raw in resp:
                        if self._stop.is_set():
                            return
                        # Watch bandwidth ledger (make bench-ingest):
                        # every received byte counts, dropped frames
                        # included — this measures wire cost, not
                        # mirror admission.  Sole writer of skey.
                        self._ingest_bytes[skey] = (
                            self._ingest_bytes.get(skey, 0) + len(raw))
                        # Frame-receipt stamp: the lineage ingest clock
                        # starts HERE, not after materialization — the
                        # fast path skips most of the decode and must
                        # not silently shift the SLO baseline relative
                        # to the full path (tests/test_wire_fast.py).
                        frame_ts = time.monotonic()
                        # Chaos sites (doc/CHAOS.md): stream disconnect,
                        # stale-resume forcing a full relist, and a
                        # truncated frame (exercises the malformed-frame
                        # relist below).  Site names carry the resource
                        # qualifier so each reflector consumes its own
                        # deterministic decision stream.  One no-op
                        # branch when the chaos engine is off.
                        plan = chaos_plan.PLAN
                        if plan is not None:
                            if plan.fire(f"watch.disconnect:{resource}"):
                                raise OSError(
                                    "chaos: watch stream disconnected "
                                    "(injected)")
                            if plan.fire(f"watch.stale:{resource}"):
                                last_rv = 0
                                raise OSError(
                                    "chaos: stale watch resume, forcing "
                                    "full relist (injected)")
                            if plan.fire(f"watch.truncate:{resource}"):
                                raw = raw[:max(1, len(raw) // 2)]
                        # Scope-epoch staleness: shard ownership changed
                        # since this connection derived its selector.
                        # Reconnect WITHOUT a resume version (the server
                        # history cannot replay a gained shard's
                        # pre-existing objects) — unless the
                        # handover-race chaos site holds the stale
                        # window open one frame so the in-scope drop
                        # below is exercised deterministically.
                        if self._scope_stale(resource, stream,
                                             scope_epoch):
                            if not (plan is not None and plan.fire(
                                    f"ingest.handover_race:{resource}")):
                                last_rv = 0
                                metrics.note_watch_reconnect(
                                    resource, "rescope")
                                break
                        event = json.loads(raw)
                        etype = event["type"]
                        # NOTE: last_rv advances only AFTER a frame is
                        # fully applied — advancing first would make a
                        # frame that fails to decode/apply permanently
                        # invisible to the resume path (no relist ever
                        # heals it).
                        frame_rv = event.get("rv")
                        if etype == "SYNC":
                            # Reconciliation is scoped to THIS stream's
                            # domain: the scoped pod split partitions the
                            # key space by assignment, and one stream's
                            # relist must not purge the other's objects.
                            # A shed shard's entries fall in the scoped
                            # domain but out of the replay — purged here,
                            # releasing their retained baselines.
                            with self.lock:
                                for stale in [
                                        k for k in store
                                        if k not in replay_seen
                                        and self._in_domain(
                                            resource, domain, store[k])]:
                                    gone = store.pop(stale)
                                    gone_pend = self._pending.get(
                                        resource, {}).pop(stale, None)
                                    if gone_pend is not None:
                                        memledger.ledger("pending").add(
                                            self._mem_pending,
                                            -gone_pend[3])
                                    self._drop_baseline_key(resource,
                                                            stale)
                                    self._note_baseline(resource, gone,
                                                        None)
                                    informer.fire_delete(gone)
                            replaying = False
                            self._synced[skey].set()
                            backoff = _WATCH_BACKOFF_BASE_S  # healthy again
                            if frame_rv is not None:
                                last_rv = max(last_rv, int(frame_rv))
                            continue
                        if etype == "RESUMED":
                            # Continuous delta stream: mirror is already
                            # current, no reconciliation needed.
                            replaying = False
                            self._synced[skey].set()
                            backoff = _WATCH_BACKOFF_BASE_S  # healthy again
                            continue
                        if etype == "ERROR":
                            # 410 Gone: fall back to a full relist.
                            last_rv = 0
                            break
                        if etype == "PING":
                            continue
                        edoc = event["object"]
                        if domain is not None:
                            # Client-side scope check (always on under a
                            # scope, selector or no selector): a frame
                            # for a foreign queue — the server's
                            # over-approximating selector still sends
                            # unlabeled pods, and a raced lease loss
                            # sends a just-shed shard's — must be
                            # dropped-and-counted, never mirrored.
                            if etype in ("ADDED", "MODIFIED") \
                                    and not self._frame_in_scope(
                                        resource, domain, edoc):
                                try:
                                    mirrored = _raw_key(resource,
                                                        edoc) in store
                                except (KeyError, TypeError,
                                        AttributeError):
                                    mirrored = False
                                if not mirrored:
                                    metrics.note_ingest_drop(
                                        resource,
                                        "handover" if self._scope_stale(
                                            resource, stream, scope_epoch)
                                        else "scope")
                                    if frame_rv is not None:
                                        last_rv = max(last_rv,
                                                      int(frame_rv))
                                    continue
                                # A MIRRORED object exiting the scope is
                                # a boundary transition, not a drop: the
                                # server's own selector rewrites it to
                                # DELETED, and the over-approximating
                                # client-side check must rewrite
                                # identically (e.g. a stream that
                                # connected before the queue universe
                                # synced carries no label selector).
                                etype = "DELETED"
                            # A DELETED on one pod stream whose carried
                            # object now belongs to the OTHER stream is
                            # a boundary transition (bind), not a
                            # removal: the peer stream delivers the
                            # matching ADDED, and the upsert below turns
                            # it into the same fire_update the
                            # unfiltered control emits for the MODIFIED.
                            if etype == "DELETED" and resource == "pods":
                                target = self._pod_domain_of(edoc)
                                if target is not None and target != domain:
                                    if frame_rv is not None:
                                        last_rv = max(last_rv,
                                                      int(frame_rv))
                                    continue
                        # Lazy mirror: absorb a MODIFIED pod frame into
                        # the deferred store instead of materializing —
                        # flush_pending() finishes the job at the
                        # session/debug chokepoint.
                        if etype == "MODIFIED" and self._maybe_defer(
                                resource, edoc, raw, frame_ts):
                            if frame_rv is not None:
                                last_rv = max(last_rv, int(frame_rv))
                            continue
                        # Previous mirror object for this key = the
                        # delta baseline.  Read without the lock: writes
                        # to a key come only from its own stream's
                        # thread (the scoped pod split partitions keys
                        # by assignment), and dict.get is atomic under
                        # the GIL.  A doc too malformed to key routes to
                        # the full decode, whose error handling is
                        # unchanged.
                        try:
                            prev = store.get(_raw_key(resource, edoc))
                        except (KeyError, TypeError, AttributeError):
                            # AttributeError included: a falsy/non-dict
                            # metadata (None/[]/"") the FULL k8s decode
                            # tolerates must route to it, not kill the
                            # reflector thread.
                            prev = None
                        t_dec = time.perf_counter()
                        obj = self._decode(edoc, prev=prev,
                                           ingest_ts=frame_ts)
                        metrics.note_decode_seconds(
                            time.perf_counter() - t_dec)
                        # Baseline footprint stamp: the retained
                        # `_wire_doc` came from (roughly) this frame's
                        # bytes; nothing is retained with the fast path
                        # off.  Instance attribute like _ingest_ts —
                        # dataclass __eq__ ignores it.
                        if codec.wire_fast_enabled():
                            obj._wire_nbytes = len(raw)
                        key = key_of(obj)
                        with self.lock:
                            if etype in ("ADDED", "MODIFIED"):
                                if etype == "ADDED" and replaying:
                                    replay_seen.add(key)
                                # This frame's doc supersedes any
                                # deferred one for the key (wire docs
                                # are complete snapshots, not diffs).
                                superseded = self._pending.get(
                                    resource, {}).pop(key, None)
                                if superseded is not None:
                                    memledger.ledger("pending").add(
                                        self._mem_pending,
                                        -superseded[3])
                                old = store.get(key)
                                store[key] = obj
                                self._note_baseline(resource, old, obj)
                                self._touch_baseline(resource, key)
                                if old is None:
                                    informer.fire_add(obj)
                                else:  # upsert of a known object
                                    informer.fire_update(old, obj)
                            elif etype == "DELETED":
                                # Deliver any deferred update first so
                                # the cache sees final-state-then-delete
                                # — the unfiltered control's order.
                                self._flush_key_locked(resource, key)
                                old = store.pop(key, None)
                                self._drop_baseline_key(resource, key)
                                self._note_baseline(resource, old, None)
                                informer.fire_delete(obj)
                            self._enforce_budget_locked(resource)
                        if frame_rv is not None:  # applied successfully
                            last_rv = max(last_rv, int(frame_rv))
            except (OSError, http.client.HTTPException):
                # Connection loss (incl. IncompleteRead mid-chunk):
                # reconnect with bounded exponential backoff (reset by
                # the next successful sync) and resume from last_rv.
                if self._stop.is_set():
                    return
                metrics.note_watch_reconnect(resource, "disconnect")
                self._stop.wait(backoff)
                backoff = min(backoff * 2.0, _WATCH_BACKOFF_CAP_S)
            except ValueError:
                # Malformed frame (truncated chunk, undecodable object):
                # the frame was never applied and last_rv did not
                # advance, so resuming would replay the same poisoned
                # frame forever — drop the resume point and relist from
                # scratch instead.
                if self._stop.is_set():
                    return
                last_rv = 0
                metrics.note_watch_reconnect(resource, "malformed")
                self._stop.wait(backoff)
                backoff = min(backoff * 2.0, _WATCH_BACKOFF_CAP_S)

    # -- shard scope + lazy mirror + baseline budget ------------------------

    def attach_scope(self, scope) -> "RemoteCluster":
        """Install a ShardScope (edge/wire_shard.py).  Before ``start()``
        the scoped streams come up scoped; after it, running reflectors
        notice the presence change on their next frame (keep-alive PINGs
        bound the wait) and reconnect scoped, and the assigned-pod
        occupancy stream is spawned here."""
        with self.lock:
            self._scope = scope
        if self._threads and "pods@assigned" not in self._synced:
            self._spawn("pods", "assigned")
        return self

    def _watch_params(self, resource: str, stream: Optional[str]):
        """(url-suffix, connect-epoch, domain) for one reflector
        connection.  domain None = unscoped legacy stream; "unassigned"
        / "assigned" = the scoped pod split; "scoped" = scoped
        podgroups.  connect-epoch None marks a connection whose selector
        does not depend on the owned-shard set (unscoped, or the static
        assigned stream)."""
        scope = self._scope
        if scope is None or resource not in ("pods", "podgroups"):
            return "", None, None
        if resource == "pods" and stream == "assigned":
            # Every bound pod, any queue: node-occupancy accounting
            # must see foreign pods or the replica double-books nodes.
            return ("&fieldSelector=" + _quote("spec.nodeName!="),
                    None, "assigned")
        epoch = scope.epoch
        # The queue stream is unfiltered, so its mirror is the
        # selector's queue-name universe — wait for its initial sync
        # (bounded) so the first scoped connection filters server-side
        # instead of degrading to the client-side check.  Queues created
        # AFTER this connect stay foreign-unfiltered until the next
        # rescope; the client-side check covers the gap.
        sync = self._synced.get("queues")
        if sync is not None:
            sync.wait(5.0)
        with self.lock:
            universe = list(self.queues)
        if resource == "podgroups":
            try:
                sel = scope.podgroup_field_selector(universe)
            except ValueError:
                self._warn_selector(resource)
                sel = None
            return (("&fieldSelector=" + _quote(sel)) if sel else "",
                    epoch, "scoped")
        parts = ["fieldSelector=" + _quote("spec.nodeName=")]
        try:
            sel = scope.pod_label_selector(universe)
        except ValueError:
            # Malformed shard selector: degrade THIS stream to the
            # unfiltered unassigned watch (the client-side scope check
            # still keeps the mirror scoped) — never kill the daemon.
            self._warn_selector(resource)
            sel = None
        if sel:
            parts.append("labelSelector=" + _quote(sel))
        return "&" + "&".join(parts), epoch, "unassigned"

    def _warn_selector(self, resource: str) -> None:
        metrics.note_wire_fast_fallback("selector")
        with self.lock:
            if resource in self._selector_warned:
                return
            self._selector_warned.add(resource)
        _LOG.warning(
            "shard selector for %r failed to compile (a queue name "
            "outside the selector charset?); degrading to an unfiltered "
            "%s watch — bandwidth scoping is OFF for this stream, the "
            "client-side scope check still applies", resource, resource)

    def _scope_stale(self, resource: str, stream: Optional[str],
                     scope_epoch) -> bool:
        """Did the owned-shard set change under this connection's
        selector?  Presence changes count (a scope attached mid-stream
        must rescope the legacy connection); the static assigned stream
        never goes stale."""
        if resource not in ("pods", "podgroups") or stream == "assigned":
            return False
        scope = self._scope
        if scope is None:
            return scope_epoch is not None
        if scope_epoch is None:
            return True  # connected unscoped, scope attached since
        return scope.epoch != scope_epoch

    def _frame_in_scope(self, resource: str, domain: str, edoc) -> bool:
        """Client-side shard admission for one ADDED/MODIFIED frame.
        Unresolvable queues pass (over-approximation: never drop what we
        cannot attribute); assigned-domain pods always pass
        (occupancy)."""
        scope = self._scope
        if scope is None:
            return True
        try:
            if resource == "pods":
                if domain != "unassigned" \
                        or wire_shard.node_of_pod_doc(edoc, self.wire):
                    return True
                with self.lock:
                    q = wire_shard.queue_of_pod_doc(
                        edoc, self.pod_groups, self.wire)
            else:
                q = wire_shard.queue_of_podgroup_doc(edoc, self.wire)
        except (AttributeError, TypeError):
            return True  # malformed doc: the decode path owns the error
        return q is None or scope.allows(q)

    def _pod_domain_of(self, edoc) -> Optional[str]:
        """Which scoped pod stream owns this doc NOW — "assigned",
        "unassigned", or None when it is out of scope entirely (foreign
        unassigned pod: a removal is a real removal)."""
        try:
            if wire_shard.node_of_pod_doc(edoc, self.wire):
                return "assigned"
            with self.lock:
                q = wire_shard.queue_of_pod_doc(
                    edoc, self.pod_groups, self.wire)
        except (AttributeError, TypeError):
            return None
        scope = self._scope
        if q is not None and scope is not None and not scope.allows(q):
            return None
        return "unassigned"

    def _in_domain(self, resource: str, domain: Optional[str],
                   obj) -> bool:
        """Does a MIRRORED object fall in this stream's relist-purge
        domain?  Unscoped streams (and scoped single-stream resources)
        own every key; the scoped pod split partitions by assignment."""
        if domain is None or resource != "pods" or domain == "scoped":
            return True
        assigned = bool(getattr(obj.spec, "node_name", "") or "")
        return assigned == (domain == "assigned")

    def _maybe_defer(self, resource: str, edoc, raw, frame_ts) -> bool:
        """Lazy mirror: queue a MODIFIED pod frame's raw doc instead of
        materializing a fresh dataclass nobody will read before the next
        frame.  Active only with a wired flush consumer (pending_churn,
        installed by the cache wiring), the fast path on, and a known
        previous object (first sight must fire_add eagerly).  Returns
        True when the frame was absorbed; the deferred doc still dirties
        its queue's shard so the scheduler wakes."""
        if resource != "pods" or self.pending_churn is None \
                or not wire_shard.lazy_mirror_enabled() \
                or not codec.wire_fast_enabled():
            return False
        try:
            key = _raw_key(resource, edoc)
        except (KeyError, TypeError, AttributeError):
            return False
        with self.lock:
            cur = self.pods.get(key)
            if cur is None:
                return False
            pend = self._pending[resource]
            entry = pend.get(key)
            if entry is None:
                pend[key] = [cur, edoc, frame_ts, len(raw)]
                memledger.ledger("pending").add(self._mem_pending,
                                                len(raw))
                metrics.note_lazy_mirror("deferred")
            else:
                # Coalesce: keep the prev the informer last delivered
                # (entry[0]); only the latest doc + receipt stamp
                # matter — wire docs are complete snapshots.
                memledger.ledger("pending").add(self._mem_pending,
                                                len(raw) - entry[3])
                entry[1] = edoc
                entry[2] = frame_ts
                entry[3] = len(raw)
                metrics.note_lazy_mirror("coalesced")
            queue = wire_shard.queue_of_pod_doc(edoc, self.pod_groups,
                                                self.wire)
        churn = self.pending_churn
        if churn is not None:  # outside the lock: churn takes cache.mutex
            churn(queue)
        return True

    def _flush_key_locked(self, resource: str, key: str) -> None:
        entry = self._pending.get(resource, {}).pop(key, None)
        if entry is not None:
            memledger.ledger("pending").add(self._mem_pending, -entry[3])
            self._materialize_locked(resource, key, entry)

    def _materialize_locked(self, resource: str, key: str,
                            entry: list) -> None:
        """Decode one deferred frame against its retained baseline and
        deliver the coalesced informer update.  ``_ingest_ts`` carries
        the stored frame-receipt stamp, so the lineage SLO clock is the
        one the eager path would have stamped."""
        store = self._store(resource)
        old = store.get(key)
        _prev, doc, frame_ts, nbytes = entry
        try:
            t_dec = time.perf_counter()
            obj = self._decode(doc, prev=old, ingest_ts=frame_ts)
            metrics.note_decode_seconds(time.perf_counter() - t_dec)
        except Exception:  # lint: allow-swallow(a malformed deferred doc must not poison the session chokepoint; the mirror keeps the prior materialization, the next frame or relist heals it, and the drop is counted)
            metrics.note_lazy_mirror("error")
            return
        if codec.wire_fast_enabled():
            obj._wire_nbytes = nbytes
        store[key] = obj
        self._note_baseline(resource, old, obj)
        self._touch_baseline(resource, key)
        metrics.note_lazy_mirror("flushed")
        informer = self._informer(resource)
        if old is None:
            informer.fire_add(obj)
        else:
            informer.fire_update(old, obj)

    def flush_pending(self) -> int:
        """Materialize every deferred MODIFIED frame into the mirror and
        informer fan-out — the lazy-mirror chokepoint.  Wired as
        ``cache.mirror_flush`` so ``snapshot()``/the session open and
        the debug surfaces see a current mirror; also safe to call
        directly.  Returns the number of frames materialized."""
        n = 0
        with self.lock:
            for resource in list(self._pending):
                pend = self._pending[resource]
                while pend:
                    key, entry = pend.popitem()
                    memledger.ledger("pending").add(self._mem_pending,
                                                    -entry[3])
                    self._materialize_locked(resource, key, entry)
                    n += 1
                if n:
                    self._enforce_budget_locked(resource)
        return n

    def pending_count(self) -> int:
        with self.lock:
            return sum(len(p) for p in self._pending.values())

    def _touch_baseline(self, resource: str, key: str) -> None:
        """Mark ``key`` hottest in its kind's baseline LRU (enforcement
        compresses/evicts from the cold end).  Lock held."""
        if self._budget.get(resource) is None:
            return
        lru = self._baseline_lru[resource]
        lru.pop(key, None)
        lru[key] = True

    def _drop_baseline_key(self, resource: str, key: str) -> None:
        lru = self._baseline_lru.get(resource)
        if lru:
            lru.pop(key, None)

    def _enforce_budget_locked(self, resource: str) -> None:
        """Hold the kind's retained baseline bytes to its budget:
        compress cold baselines in place first, evict (counted) only
        when compression cannot get there.  Runs under the lock so the
        ledger and the objects move together; the gauge publishes every
        step, so ``kube_batch_wire_baseline_bytes`` only goes DOWN at a
        fixed workload once the budget binds."""
        budget = self._budget.get(resource)
        if budget is None \
                or self._baseline_bytes.get(resource, 0) <= budget:
            return
        store = self._store(resource)
        lru = self._baseline_lru[resource]
        for op in ("compress", "evict"):
            for key in list(lru):
                if self._baseline_bytes[resource] <= budget:
                    return
                obj = store.get(key)
                if obj is None:
                    lru.pop(key, None)
                    continue
                old_n = getattr(obj, "_wire_nbytes", 0)
                if op == "compress":
                    if old_n < 128:
                        continue  # zlib overhead would inflate it
                    new_n = baseline_store.compress(obj)
                    if new_n is None:
                        continue  # already cold / nothing retained
                else:
                    popped = baseline_store.evict(obj)
                    lru.pop(key, None)
                    if not popped:
                        continue
                    new_n = 0
                try:
                    obj._wire_nbytes = new_n
                except AttributeError:  # lint: allow-swallow(slotted/foreign object: it never carried retained bytes, the ledger is untouched)
                    continue
                delta = new_n - old_n
                if delta:
                    total = self._baseline_bytes.get(resource, 0) + delta
                    self._baseline_bytes[resource] = total
                    metrics.set_wire_baseline(resource, total)
                    # Budget enforcement mutates `_wire_nbytes` in
                    # place, outside _note_baseline — the ledger must
                    # follow or audit_mem_ledgers drifts here.
                    memledger.ledger("baseline").add(
                        self._mem_baseline, delta)
                metrics.note_baseline_budget(resource, op)

    def audit_baseline_bytes(self) -> Dict[str, int]:
        """{kind: ledger - actual}: zero everywhere iff the
        ``_baseline_bytes`` ledger reconciles with the ``_wire_nbytes``
        actually retained on mirror objects — the relist/DELETE release
        invariant (tests/test_baseline_budget.py)."""
        out = {}
        with self.lock:
            for resource in _WATCHED:
                actual = sum(getattr(o, "_wire_nbytes", 0)
                             for o in self._store(resource).values())
                out[resource] = (self._baseline_bytes.get(resource, 0)
                                 - actual)
        return out

    def ingest_bytes(self) -> Dict[str, int]:
        """Cumulative watch bytes received per resource (the scoped pod
        streams folded together) — `make bench-ingest`'s directional
        key."""
        out: Dict[str, int] = {}
        for skey, v in self._ingest_bytes.items():
            base = skey.split("@", 1)[0]
            out[base] = out.get(base, 0) + v
        return out

    def mirrored_objects(self) -> Dict[str, int]:
        """{resource: mirror entry count} — the soak's O(own shards)
        scoping assertions."""
        with self.lock:
            return {r: len(self._store(r)) for r in _WATCHED}

    def _spawn(self, resource: str, stream: Optional[str] = None) -> None:
        skey = f"{resource}@{stream}" if stream else resource
        # setdefault: start() pre-registers every stream's sync event
        # before ANY reflector thread runs, so the scoped pod/podgroup
        # connections can wait on the queue stream's sync no matter the
        # spawn order.
        self._synced.setdefault(skey, threading.Event())
        self._ingest_bytes.setdefault(skey, 0)
        t = threading.Thread(target=self._reflect,
                             args=(resource, stream), daemon=True,
                             name=f"reflector-{skey}")
        t.start()
        self._threads.append(t)

    def start(self, timeout: float = 30.0) -> "RemoteCluster":
        for resource in _WATCHED:
            self._synced.setdefault(resource, threading.Event())
        for resource in _WATCHED:
            self._spawn(resource)
        if self._scope is not None:
            self._spawn("pods", "assigned")
        for skey in list(self._synced):
            if not self._synced[skey].wait(timeout):
                # Don't leak reflector threads into a caller that will
                # retry or give up: each holds a socket and keeps
                # mutating the mirrors.  Stop and join them before
                # surfacing WHICH streams never synced.
                unsynced = [s for s in self._synced
                            if not self._synced[s].is_set()]
                self._stop.set()
                for t in self._threads:
                    t.join(timeout=2.0)
                alive = [t.name for t in self._threads if t.is_alive()]
                raise TimeoutError(
                    f"watch sync timeout after {timeout:.1f}s; streams "
                    f"never synced: {', '.join(unsynced)}"
                    + (f" (reflectors still draining a blocked read: "
                       f"{', '.join(alive)})" if alive else ""))
        self._refresh_pvcs()
        return self

    def _note_baseline(self, resource: str, old, new) -> None:
        """Apply one mirror-store entry change (old -> new, either side
        None) to the per-kind retained-baseline byte total and publish
        the gauge.  Reflector thread only (each resource has exactly one
        writer)."""
        delta = (getattr(new, "_wire_nbytes", 0) if new is not None else 0) \
            - (getattr(old, "_wire_nbytes", 0) if old is not None else 0)
        if delta:
            total = self._baseline_bytes.get(resource, 0) + delta
            self._baseline_bytes[resource] = total
            metrics.set_wire_baseline(resource, total)
            memledger.ledger("baseline").add(self._mem_baseline, delta)
        # Every mirror-store entry change routes through here (upsert,
        # DELETED, SYNC purge, lazy-mirror materialize), so the mirror
        # ledger's count delta piggybacks on the same call.
        count_delta = (new is not None) - (old is not None)
        if count_delta:
            memledger.ledger("mirror").add(
                self._mem_mirror, count_delta * _MIRROR_OBJ_EST)

    def wire_baseline_bytes(self) -> Dict[str, int]:
        """{kind: retained raw-doc baseline bytes} — the mirror-memory
        accounting surfaced on /debug/sessions and the bench artifact."""
        return dict(self._baseline_bytes)

    def _refresh_pvcs(self) -> None:
        """PVCs are list-only; _PvcStore refetches on a miss so claims
        created after start() are still found at allocate time."""
        items = {}
        for doc in self._request("GET", self._collection("pvcs"))["items"]:
            pvc = self._decode(doc)
            items[f"{pvc.metadata.namespace}/{pvc.metadata.name}"] = pvc
        self.pvcs.replace(items)

    def stop(self) -> None:
        self._stop.set()

    # -- egress: REST verbs -------------------------------------------------

    def _collection(self, resource: str) -> str:
        return (_K8S_PATHS[resource] if self.wire == "k8s"
                else f"/v1/{resource}")

    def _object_path(self, resource: str, namespace, name: str) -> str:
        if self.wire != "k8s":
            return (f"/v1/{resource}/{name}" if namespace is None
                    else f"/v1/{resource}/{namespace}/{name}")
        base = _K8S_PATHS[resource]
        if namespace is None:
            return f"{base}/{name}"
        head, _, res = base.rpartition("/")
        return f"{head}/namespaces/{namespace}/{res}/{name}"

    def _encode(self, obj):
        return (codec_k8s.to_k8s(obj) if self.wire == "k8s"
                else codec.encode(obj))

    def _decode(self, doc, prev=None, ingest_ts=None):
        """Decode one wire doc; ``prev`` (the mirror's current object for
        the same key) arms the columnar fast path — changed fields only,
        unchanged subtrees reused by identity (edge/codec.decode_delta /
        codec_k8s.from_k8s_delta).  Any fast-path surprise degrades to
        the full decode, counted by reason — a weird frame must never
        kill the reflector thread (the ValueError contract below is
        unchanged: a doc the FULL decode rejects still raises)."""
        obj = None
        if prev is not None and codec.wire_fast_enabled():
            try:
                obj = (codec_k8s.from_k8s_delta(doc, prev)
                       if self.wire == "k8s"
                       else codec.decode_delta(doc, prev))
                metrics.note_wire_decode("delta")
            except LookupError as exc:
                # No usable baseline (first sight after a relist gap,
                # foreign object) or a kind outside the delta plans —
                # the codec names which; anything else folds into
                # "baseline" so the label set stays bounded.
                reason = str(exc)
                metrics.note_wire_fast_fallback(
                    reason if reason in ("kind", "evicted")
                    else "baseline")
            except ValueError:
                # The full decode would reject this doc too: let the
                # reflector's malformed-frame relist handle it.
                raise
            except Exception:  # lint: allow-swallow(fast-path isolation: the full decode below is always correct, and the degradation is counted)
                metrics.note_wire_fast_fallback("error")
        if obj is None:
            obj = (codec_k8s.from_k8s(doc) if self.wire == "k8s"
                   else codec.decode(doc))
            metrics.note_wire_decode("full")
            if codec.wire_fast_enabled():
                # Baseline for the NEXT frame of this key (the delta
                # compare needs the raw doc the object came from).
                codec.remember_wire_doc(obj, doc)
        # Pod-lineage ingest stamp (trace/lineage.py): monotonic so the
        # SLO clock survives wall-clock steps.  ``ingest_ts`` carries the
        # FRAME-RECEIPT stamp the reflector took before any decode ran,
        # so the lineage timestamp does not silently shift between the
        # fast path (near-zero decode) and the full path (the
        # materialization delay the old stamp-after-decode absorbed).
        # Stamped HERE (the client edge, both wire modes, one
        # chokepoint) and not in the codecs — the server decodes through
        # the same codec functions and must not mark ITS objects as
        # scheduler-ingested.  An instance attribute: dataclass __eq__
        # ignores it, the codec never re-encodes it.
        if isinstance(obj, _objects.Pod):
            obj._ingest_ts = (ingest_ts if ingest_ts is not None
                              else time.monotonic())
        return obj

    def _request(self, method: str, path: str, payload=None,
                 content_type: str = "application/json"):
        body = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(
            f"{self.base_url}{path}", data=body, method=method,
            headers={"Content-Type": content_type})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            detail = exc.read().decode(errors="replace")
            err = KeyError(f"{method} {path}: {exc.code} {detail}")
            err.status = exc.code  # type: ignore[attr-defined]
            raise err from exc

    # effectors the SchedulerCache wiring uses (cluster.py effectors):
    def _bind_request(self, namespace: str, name: str, hostname: str):
        """(path, payload) for one bind, by wire mode."""
        if self.wire == "k8s":  # the real Binding subresource
            return (self._object_path("pods", namespace, name) + "/binding",
                    {"apiVersion": "v1", "kind": "Binding",
                     "metadata": {"name": name, "namespace": namespace},
                     "target": {"kind": "Node", "name": hostname}})
        return (f"/v1/pods/{namespace}/{name}/bind", {"node": hostname})

    def bind_pods_many(self, pairs, workers: int = 8) -> list:
        """Bind [(pod, hostname)] concurrently over persistent
        connections; returns [(pod, hostname, exc)] failures.

        The reference fires one goroutine per bind (cache.go:491-535 via
        the bind channel); the HTTP analog is a small worker pool where
        each worker keeps ONE keep-alive connection and streams its
        share of Binding POSTs down it — n_binds round trips become
        ~n_binds/workers serialized on each of ``workers`` sockets,
        without per-request TCP setup."""
        from urllib.parse import urlsplit

        if not pairs:
            return []
        parts = urlsplit(self.base_url)
        prefix = parts.path.rstrip("/")  # reverse-proxied edge prefix
        conn_cls = (_NodelayHTTPSConnection if parts.scheme == "https"
                    else _NodelayConnection)
        failures = []
        flock = threading.Lock()
        workers = max(1, min(workers, len(pairs)))

        def post(conn, pod, hostname, path, body):
            sent = False
            for attempt in (0, 1):
                try:
                    sent = False
                    conn.request("POST", prefix + path, body,
                                 {"Content-Type": "application/json"})
                    sent = True  # delivered; a later failure may have
                    # been applied server-side — don't blind-retry
                    resp = conn.getresponse()
                    data = resp.read()
                except (http.client.HTTPException, OSError) as exc:
                    conn.close()  # next request auto-reconnects
                    if attempt or sent:
                        # After delivery, binds are non-idempotent —
                        # check the pod instead of re-POSTing.
                        if sent and self._pod_bound_to(pod, hostname):
                            # Ambiguity resolved by the read-back: it
                            # landed, the skipped retry was correct.
                            metrics.note_bind_ambiguous("landed")
                            return
                        if sent:
                            # Delivered but unproven either way (the
                            # read-back probe could not confirm): surface
                            # the ambiguity explicitly — the cache routes
                            # it through resync instead of assuming the
                            # bind failed (counted there as "unproven").
                            raise AmbiguousOutcomeError(
                                f"bind POST for "
                                f"{pod.metadata.namespace}/"
                                f"{pod.metadata.name} was delivered but "
                                f"its outcome is unproven") from exc
                        raise
                    # Send-phase failure: the bytes PROBABLY never
                    # reached the server, but TCP cannot prove it (an
                    # RST can race a request that was delivered and
                    # applied).  Read the pod back before the resend:
                    # if the first POST landed, skip the retry rather
                    # than lean on duplicate binds being idempotent.
                    if self._pod_bound_to(pod, hostname):
                        metrics.note_bind_ambiguous("landed")
                        return
                    continue
                if resp.status >= 400:
                    if attempt and self._pod_bound_to(pod, hostname):
                        # First attempt did land; 409-shaped echo.
                        metrics.note_bind_ambiguous("landed")
                        return
                    err = KeyError(f"POST {path}: {resp.status} "
                                   f"{data.decode(errors='replace')}")
                    # Status carried for the cache's retry classifier:
                    # 4xx rejections are permanent, 5xx are transient.
                    err.status = resp.status  # type: ignore[attr-defined]
                    raise err
                return

        def run(chunk):
            conn = conn_cls(parts.hostname, parts.port,
                            timeout=self.timeout)
            try:
                for pod, hostname in chunk:
                    path, payload = self._bind_request(
                        pod.metadata.namespace, pod.metadata.name, hostname)
                    try:
                        post(conn, pod, hostname, path,
                             json.dumps(payload))
                    except Exception as exc:  # per-task failure isolation
                        with flock:
                            failures.append((pod, hostname, exc))
            finally:
                conn.close()

        threads = [threading.Thread(
            target=run, args=(pairs[i::workers],), daemon=True)
            for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return failures

    def _pod_bound_to(self, pod, hostname: str) -> bool:
        """Read-back check for the bind retry path: was the first POST
        applied before the connection died?  GETs the SERVER (the local
        mirror lags the watch stream); GETs are idempotent, so this is
        safe where re-POSTing a Binding is not."""
        try:
            doc = self._request("GET", self._object_path(
                "pods", pod.metadata.namespace, pod.metadata.name))
            current = self._decode(doc)
            return current.spec.node_name == hostname
        except Exception:  # lint: allow-swallow(read-back probe: any failure means "unproven", and False makes the retry path surface the original error)
            return False

    def evict_pods_many(self, pods, workers: int = 8) -> list:
        """Evict (DELETE) pods concurrently over persistent
        connections; returns [(pod, exc)] failures — the bind_pods_many
        twin for the batched commit flush (framework/commit.py).

        Simpler than the bind pool: a pod DELETE is idempotent (the
        object either exists or it does not), so a connection that dies
        mid-request retries once on a fresh connection and a 404 on the
        retry proves the first attempt landed."""
        if not pods:
            return []
        from urllib.parse import urlsplit

        parts = urlsplit(self.base_url)
        prefix = parts.path.rstrip("/")
        conn_cls = (_NodelayHTTPSConnection if parts.scheme == "https"
                    else _NodelayConnection)
        failures = []
        flock = threading.Lock()
        pods = list(pods)
        workers = max(1, min(workers, len(pods)))

        def delete(conn, pod):
            path = prefix + self._object_path(
                "pods", pod.metadata.namespace, pod.metadata.name)
            for attempt in (0, 1):
                try:
                    conn.request("DELETE", path)
                    resp = conn.getresponse()
                    data = resp.read()
                except (http.client.HTTPException, OSError):
                    conn.close()  # next request auto-reconnects
                    if attempt:
                        raise
                    continue  # DELETE is idempotent: one clean retry
                if resp.status == 404 and attempt:
                    return  # first attempt landed; the retry's 404 proves it
                if resp.status >= 400:
                    err = KeyError(f"DELETE {path}: {resp.status} "
                                   f"{data.decode(errors='replace')}")
                    err.status = resp.status  # type: ignore[attr-defined]
                    raise err
                return

        def run(chunk):
            conn = conn_cls(parts.hostname, parts.port,
                            timeout=self.timeout)
            try:
                for pod in chunk:
                    try:
                        delete(conn, pod)
                    except Exception as exc:  # per-pod failure isolation
                        with flock:
                            failures.append((pod, exc))
            finally:
                conn.close()

        threads = [threading.Thread(
            target=run, args=(pods[i::workers],), daemon=True)
            for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return failures

    def bind_pod(self, namespace: str, name: str, hostname: str) -> None:
        path, payload = self._bind_request(namespace, name, hostname)
        self._request("POST", path, payload)

    def delete_pod(self, namespace: str, name: str) -> None:
        self._request("DELETE",
                      self._object_path("pods", namespace, name))

    def put_pod_group_status(self, pg) -> None:
        self._request(
            "PUT",
            self._object_path("podgroups", pg.metadata.namespace,
                              pg.metadata.name) + "/status",
            self._encode(pg))

    def update_pod_condition(self, namespace: str, name: str,
                             condition) -> None:
        """Pod status subresource: PodCondition upsert (the stuck-pod
        writeback, cache.go:548-568).  Native wire PUTs the bare
        condition; k8s wire strategic-merge-patches ONLY this condition
        (merged by ``type`` server-side), so concurrent status writers'
        conditions are never clobbered by a stale read-modify-write."""
        if self.wire == "k8s":
            self._request(
                "PATCH",
                self._object_path("pods", namespace, name) + "/status",
                {"status": {"conditions": [
                    {"type": condition.type, "status": condition.status,
                     "reason": condition.reason,
                     "message": condition.message}]}},
                content_type="application/strategic-merge-patch+json")
        else:
            self._request("PUT", f"/v1/pods/{namespace}/{name}/status",
                          codec.encode(condition))

    def create_event(self, event) -> None:
        self._request("POST", self._collection("events"),
                      self._encode(event))

    # leader-election lease (ConfigMap-lock analog, server.go:115-139):
    def get_lease(self, namespace: str, name: str):
        doc = self._request("GET", f"/v1/leases/{namespace}/{name}")
        return int(doc["version"]), doc["record"]

    def cas_lease(self, namespace: str, name: str, record: dict,
                  expected_version: int) -> int:
        try:
            doc = self._request(
                "PUT", f"/v1/leases/{namespace}/{name}",
                {"record": record, "expectedVersion": expected_version})
        except KeyError as exc:  # 409 conflict surfaced by _request
            raise ValueError(str(exc)) from exc
        return int(doc["version"])

    def bind_pvc(self, namespace: str, name: str, volume_name: str) -> None:
        self._request(
            "POST",
            self._object_path("pvcs", namespace, name) + "/bind",
            {"volume": volume_name})

    def get_pod(self, namespace: str, name: str):
        """Authoritative ground-truth fetch — the resync path's read
        (cache.go:602-611 queries the apiserver, not an informer store).
        Resync exists precisely because the mirror may LAG the effect
        being repaired; answering from the mirror can resurrect a stale
        Pending for a bind that actually landed, and the re-placement
        then double-books the node (found by tools/chaos_soak.py under
        watch faults).  404 -> None (the pod is truly gone); transport
        errors propagate — the resync worker re-queues the task."""
        try:
            doc = self._request(
                "GET", self._object_path("pods", namespace, name))
        except KeyError as exc:
            if getattr(exc, "status", None) == 404:
                return None
            raise
        return self._decode(doc)

    def get_mirror_pod(self, namespace: str, name: str):
        """The local mirror's view (may lag truth): the zero-round-trip
        read for callers that only need informer-consistent state.  A
        debug/resync read is a materialization touch — any deferred
        frame for the key flushes first (lazy-mirror validity rule)."""
        with self.lock:
            self._flush_key_locked("pods", f"{namespace}/{name}")
            return self.pods.get(f"{namespace}/{name}")

    # mutation verbs (typed clientsets / workload submission clients):
    def update_pod_group(self, pg) -> None:
        if self.wire == "k8s":
            self._request(
                "PUT",
                self._object_path("podgroups", pg.metadata.namespace,
                                  pg.metadata.name),
                self._encode(pg))
        else:
            self._request("PUT", "/v1/podgroups", codec.encode(pg))

    def delete_pod_group(self, namespace: str, name: str) -> None:
        self._request("DELETE",
                      self._object_path("podgroups", namespace, name))

    def delete_queue(self, name: str) -> None:
        self._request("DELETE", self._object_path("queues", None, name))

    # creation verbs (tests / workload submission clients):
    def create_pod(self, pod) -> None:
        self._request("POST", self._collection("pods"), self._encode(pod))

    def create_node(self, node) -> None:
        self._request("POST", self._collection("nodes"),
                      self._encode(node))

    def create_pod_group(self, pg) -> None:
        self._request("POST", self._collection("podgroups"),
                      self._encode(pg))

    def create_queue(self, queue) -> None:
        self._request("POST", self._collection("queues"),
                      self._encode(queue))

    def create_priority_class(self, pc) -> None:
        self._request("POST", self._collection("priorityclasses"),
                      self._encode(pc))

    def create_pvc(self, pvc) -> None:
        self._request("POST", self._collection("pvcs"),
                      self._encode(pvc))
