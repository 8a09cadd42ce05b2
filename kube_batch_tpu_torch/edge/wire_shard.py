"""Shard-scoped reflector ingest (doc/INGEST.md).

A federated replica owns a subset of queue-shards (tenancy/leases.py)
but its reflectors historically mirrored the WHOLE cluster and filtered
at snapshot time — N replicas paid N x O(cluster) watch bandwidth and
mirror memory.  ``ShardScope`` turns the tenancy queue->shard map plus a
live owned-shards callable into the server-side watch selectors each
reflector connects with (edge/selectors.py grammar, served by
edge/server.py), so ingest scales with OWNED shards:

* pods ride TWO streams: *unassigned* (``spec.nodeName=`` + a
  ``queue notin (<foreign queues>)`` label selector — the replica's own
  schedulable work) and *assigned* (``spec.nodeName!=`` — every bound
  pod, kept for node-occupancy accounting; exactly the cache
  ``pod_filter`` contract, so the scheduler cache state is bit-identical
  to the unfiltered control).  ``notin`` also matches objects WITHOUT
  the key (selectors.py), so unlabeled pods are always received — a safe
  over-approximation the client-side scope check then attributes via the
  podgroup annotation.
* podgroups filter server-side on ``spec.queue!=<foreign>`` pairs.
* nodes/queues/priorityclasses/pdbs stay shared, unfiltered streams
  (the queue stream is also the selector's queue-name universe).

Lease acquisition/steal/shed bumps the scope ``epoch``; a reflector
notices the stale epoch on its next frame (keep-alive PINGs bound the
latency) and reconnects WITHOUT a resume version — a full scoped relist,
because the server's event history cannot replay a gained shard's
pre-existing objects.  The relist's SYNC reconciliation purges the shed
shard's mirror entries and releases their retained baselines.

``KUBE_BATCH_TPU_WIRE_SHARD=0`` is the bit-parity control: the scope is
simply never attached and every reflector runs the legacy unfiltered
single stream.  ``KUBE_BATCH_TPU_LAZY_MIRROR=0`` likewise pins the lazy
MODIFIED-frame deferral (edge/client.flush_pending) eager.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional

from .. import knobs
from ..apis.scheduling.v1alpha1 import GroupNameAnnotationKey
from . import selectors as _selectors

WIRE_SHARD_ENV = knobs.WIRE_SHARD.env
LAZY_MIRROR_ENV = knobs.LAZY_MIRROR.env

# Pods carry their queue as a label so the SERVER can shard-filter the
# watch (annotations are not selectable — the k8s contract).  Pods
# without the label still reach every replica (``notin`` matches the
# missing key) and are attributed client-side via the podgroup
# annotation; labeling is a bandwidth optimization, never a correctness
# requirement.
QUEUE_LABEL = "queue.kube-batch.tpu/name"


def wire_shard_enabled() -> bool:
    return knobs.WIRE_SHARD.enabled()


def lazy_mirror_enabled() -> bool:
    return knobs.LAZY_MIRROR.enabled()


def queue_of_pod_doc(doc, pod_groups, wire: str) -> Optional[str]:
    """Resolve a raw pod wire doc to its queue name: the queue label
    first, then the podgroup annotation through the podgroup mirror
    (a group and its pods share one queue, so the shard-filtered
    podgroup mirror still covers every attributable pod).  None when
    unresolvable — callers must treat that as in-scope
    (over-approximation: never drop what we cannot attribute)."""
    md = doc.get("metadata") or {}
    labels = md.get("labels") or {}
    q = labels.get(QUEUE_LABEL)
    if q:
        return q
    ann = md.get("annotations") or {}
    group = ann.get(GroupNameAnnotationKey)
    if not group:
        return None
    ns = md.get("namespace", "default")
    pg = pod_groups.get(f"{ns}/{group}")
    if pg is None:
        return None
    return getattr(pg.spec, "queue", None) or None


def node_of_pod_doc(doc, wire: str) -> str:
    spec = doc.get("spec") or {}
    return (spec.get("nodeName" if wire == "k8s" else "node_name")
            or "")


def queue_of_podgroup_doc(doc, wire: str) -> Optional[str]:
    spec = doc.get("spec") or {}
    return spec.get("queue") or None


class ShardScope:
    """The live shard ownership window a RemoteCluster's reflectors
    filter by.  ``owned`` is re-read on every check (it tracks the lease
    manager); ``epoch`` increments on every ownership change so running
    watch connections notice their selector went stale."""

    def __init__(self, shard_map,
                 owned: Optional[Callable[[], Iterable[int]]] = None):
        self.map = shard_map
        self._owned = owned
        self._lock = threading.Lock()
        self._epoch = 1

    @property
    def epoch(self) -> int:
        return self._epoch

    def bump(self) -> int:
        """Ownership changed (claim/steal/shed/loss): invalidate every
        selector derived from the previous owned set."""
        with self._lock:
            self._epoch += 1
            return self._epoch

    def owned(self) -> frozenset:
        if self._owned is None:
            return frozenset(range(self.map.num_shards))
        return frozenset(self._owned())

    def allows(self, queue: str) -> bool:
        """Is this queue's shard currently owned?  Pure client-side hash
        (ShardMap.shard_of works for queue names never seen before), so
        the scope check never waits on the queue mirror."""
        return self.map.shard_of(queue) in self.owned()

    def foreign_queues(self, universe: Iterable[str]) -> List[str]:
        """The known queue names whose shard we do NOT own — the
        ``notin`` exclusion list.  Sorted so the derived selector string
        is deterministic for a given (universe, owned) pair."""
        owned = self.owned()
        return sorted(q for q in universe
                      if self.map.shard_of(q) not in owned)

    def pod_label_selector(self, universe: Iterable[str]) -> Optional[str]:
        """``<QUEUE_LABEL> notin (f1,f2,...)`` over the foreign queues,
        or None when every known queue is owned (nothing to exclude).
        Raises ValueError when a foreign queue name cannot be expressed
        in the selector value charset — the caller degrades that stream
        to an unfiltered watch (satellite: never kill the reflector)."""
        foreign = self.foreign_queues(universe)
        if not foreign:
            return None
        sel = f"{QUEUE_LABEL} notin ({','.join(foreign)})"
        # Compile through the real grammar: a queue name with a comma,
        # space, or other out-of-charset byte must fail HERE, not as a
        # server-side 400 loop.
        _selectors.parse_label_selector(sel)
        return sel

    def podgroup_field_selector(self,
                                universe: Iterable[str]) -> Optional[str]:
        """``spec.queue!=f1,spec.queue!=f2,...`` over the foreign
        queues (field selectors AND together, so a chain of != excludes
        the set), or None when nothing is foreign.  ValueError on an
        inexpressible queue name, same contract as the label form."""
        foreign = self.foreign_queues(universe)
        if not foreign:
            return None
        for q in foreign:
            if "," in q or not _selectors._VAL_RE.match(q):
                raise ValueError(
                    f"queue name {q!r} not expressible in a field "
                    f"selector value")
        return ",".join(f"spec.queue!={q}" for q in foreign)


def attach_shard_scope(remote, shard_map, lease_mgr=None,
                       owned: Optional[Callable[[], Iterable[int]]] = None):
    """Wire a RemoteCluster's reflectors to the tenancy shard map.

    Call AFTER ``TenancyEngine.attach_leases`` (ordering matters: a
    shard-filtered mirror undercounts foreign shards' load, so this
    helper pins ``lease_mgr.shard_load = None`` — the count-based spread
    rule — and attach_leases would re-install the full-mirror load
    probe if it ran later).  Returns the attached ShardScope, or None
    when ``KUBE_BATCH_TPU_WIRE_SHARD=0`` pinned the legacy unfiltered
    ingest."""
    if not wire_shard_enabled():
        return None
    if owned is None and lease_mgr is not None:
        owned = lease_mgr.owned_shards
    scope = ShardScope(shard_map, owned)
    if lease_mgr is not None:
        prev = getattr(lease_mgr, "on_change", None)

        def _ownership_changed(shard: int, kind: str, _prev=prev) -> None:
            if _prev is not None:
                _prev(shard, kind)
            scope.bump()

        lease_mgr.on_change = _ownership_changed
        # Load-weighted claim targets read per-shard load from the FULL
        # mirror; a filtered replica sees ~zero foreign load and would
        # shed-oscillate.  None selects the count-based spread rule.
        lease_mgr.shard_load = None
    remote.attach_scope(scope)
    return scope
