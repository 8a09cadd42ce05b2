"""Per-shard leases: active-active replica federation.

Instead of ONE leader owning the whole cluster (cli/leader_election.py,
the reference's ConfigMap-lock LeaderElector), each queue-shard is its
own lease object in the shared store — ``kube-batch-shard-<i>`` —
claimed, renewed, and stolen via the same StoreLock CAS the global
elector uses (Cluster and RemoteCluster both serialize the CAS; over
the edge it rides the version-guarded PUT that 409s on conflict).  N
replicas each own a subset of shards and schedule only those; a crashed
replica's shards expire and are stolen by survivors within one lease
duration.  Counterpart of kube_batch_tpu/tenancy/leases.py, copied whole
(host Python).

Lease state machine per (replica, shard) — doc/TENANCY.md:

    free/expired --claim/steal--> owned --renew--> owned
    owned --renew failures past renew_deadline--> lost (fenced)
    owned --lease observed under another holder--> lost (fenced)
    owned --release (clean shutdown)--> free

The fence is WALL-CLOCK based like LeaderElector.has_live_lease: a
replica that cannot prove a renewal within ``renew_deadline`` refuses
all writes for the shard (ShardView._check_shard_fence) even before the
lease thread runs again.  The truth store's 409 re-bind rejection
remains the cross-replica backstop for the ambiguity window.

Chaos sites (doc/CHAOS.md): ``lease.cas_conflict:<shard>`` makes a
claim/renew CAS lose as if another replica raced it;
``lease.clock_skew:<shard>`` makes this replica's clock appear to have
run past its own lease — it must ABANDON the shard (fence closes)
instead of racing the next owner.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

from ..chaos import plan as chaos_plan
from ..cli.leader_election import StoreLock
from ..metrics import metrics
from .debug import shard_table

log = logging.getLogger(__name__)

SHARD_LOCK_PREFIX = "kube-batch-shard"

DEFAULT_SHARD_LEASE_DURATION = 5.0
DEFAULT_SHARD_RENEW_DEADLINE = 3.0
DEFAULT_SHARD_RETRY_PERIOD = 1.0


def shard_lock_name(shard: int) -> str:
    return f"{SHARD_LOCK_PREFIX}-{int(shard)}"


def _default_identity() -> str:
    import uuid
    return (f"{socket.gethostname()}-{os.getpid()}-"
            f"{uuid.uuid4().hex[:8]}")


class ShardLeaseManager:
    """Claim-and-renew loop over one CAS lease per shard."""

    def __init__(self, cluster, namespace: str, num_shards: int,
                 identity: str = "",
                 lease_duration: float = DEFAULT_SHARD_LEASE_DURATION,
                 renew_deadline: float = DEFAULT_SHARD_RENEW_DEADLINE,
                 retry_period: float = DEFAULT_SHARD_RETRY_PERIOD,
                 target_shards: Optional[int] = None,
                 on_claim: Optional[Callable[[int], None]] = None,
                 shard_load: Optional[Callable[[int], float]] = None):
        if renew_deadline >= lease_duration:
            raise ValueError(
                "renew_deadline must be < lease_duration (a replica must "
                "fence itself before its lease can expire under it)")
        self.identity = identity or _default_identity()
        self.lease_duration = float(lease_duration)
        self.renew_deadline = float(renew_deadline)
        self.retry_period = float(retry_period)
        # Soft spread target: a replica at/over target defers claiming a
        # FREE shard for one extra lease duration so an under-loaded
        # replica can take it first — but never forever (an orphan shard
        # beats a balanced outage).
        self.target_shards = target_shards
        # Load-weighted claim targets (ROADMAP 2c): when a shard-load
        # estimator is attached (the tenancy engine's pods+churn EWMA —
        # every replica mirrors the whole cluster, so its own estimate
        # covers every shard), the spread deferral compares owned LOAD
        # against the fair load share target_shards implies, instead of
        # raw shard counts — a whale tenant's shard weighs what it
        # costs, so the whale's owner defers claiming extra shards while
        # its peers soak up the small ones.
        self.shard_load = shard_load
        self.num_shards = int(num_shards)
        self.locks: List[StoreLock] = [
            StoreLock(cluster, namespace, name=shard_lock_name(i))
            for i in range(num_shards)]
        self._on_claim = on_claim
        # Ownership-change hook, fired on EVERY transition — claim,
        # steal, shed, loss — with (shard, kind).  The shard-scoped
        # reflector wiring (edge/wire_shard.attach_shard_scope) installs
        # its scope-epoch bump here so a filtered watch rescopes the
        # moment the owned set moves; _on_claim above stays claim-only
        # (the engine's churn wake).  Assignable any time; called from
        # the lease thread.
        self.on_change: Optional[Callable[[int, str], None]] = None
        self._lock = threading.Lock()
        self._renewed: Dict[int, float] = {}   # shard -> last renew  guarded-by: _lock
        # Spread-target deferral bookkeeping (lease thread only): when
        # this replica first saw each claimable shard while sitting at
        # or over its target.
        self._deferred_since: Dict[int, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Deterministic per-replica claim order (rotate by identity
        # hash): replicas racing a cold federation start claiming from
        # different shards, so the initial CAS races spread ownership
        # instead of serializing every replica onto shard 0 first.
        import hashlib
        rot = int.from_bytes(hashlib.blake2b(
            self.identity.encode(), digest_size=4).digest(), "big")
        self._order = [(i + rot) % num_shards for i in range(num_shards)]

    # -- ownership queries (any thread) -------------------------------------

    def owned_shards(self) -> List[int]:
        now = time.time()
        with self._lock:
            return sorted(s for s, renewed in self._renewed.items()
                          if now - renewed < self.renew_deadline)

    def lease_live(self, shard: int) -> bool:
        """Wall-clock write fence: True only while the shard's lease was
        renewed within renew_deadline (LeaderElector.has_live_lease
        semantics — a paused process fences itself the moment the clock
        says so, before the lease thread ever runs again)."""
        with self._lock:
            renewed = self._renewed.get(shard)
        return renewed is not None and \
            time.time() - renewed < self.renew_deadline

    # -- the claim/renew loop -----------------------------------------------

    def tick(self) -> None:
        """One pass over every shard (also driven directly by tests and
        the replica soak for deterministic stepping)."""
        for shard in self._order:
            try:
                self._tick_shard(shard)
            except Exception:  # lint: allow-swallow(one shard's store hiccup must not stall the other shards' renewals; the failed shard retries next tick and the renew deadline fences it meanwhile)
                metrics.note_swallowed("shard_lease_tick")
        try:
            self._maybe_shed_load(time.time())
        except Exception:  # lint: allow-swallow(load shedding is balance polish, never liveness: a failed shed retries next tick; counted)
            metrics.note_swallowed("shard_lease_shed")
        self._publish()

    def _maybe_shed_load(self, now: float) -> None:
        """Load-weighted rebalance, shed side (ROADMAP 2c): with a load
        estimator attached, a replica whose owned LOAD exceeds its fair
        share even after giving up its lightest shard cleanly releases
        that shard (at most one per tick) so an under-loaded replica
        claims it — a whale tenant's owner converges to owning the whale
        alone while its peers soak up the small shards.  The guard
        ``mine - lightest >= fair`` is the oscillation fence: after the
        shed we are still at/over fair, so our own claim deferral keeps
        us from immediately taking the shard back, and a replica at
        exactly fair (the uniform-load fleet) never sheds at all.
        Count-based targets (no estimator) never shed — the count rule's
        behavior unchanged."""
        if self.shard_load is None or self.target_shards is None:
            return
        with self._lock:
            owned = [s for s, renewed in self._renewed.items()
                     if now - renewed < self.renew_deadline]
        if len(owned) <= 1:
            return  # never shed the last owned shard
        loads = {s: max(float(self.shard_load(s)), 0.0) + 1.0
                 for s in range(self.num_shards)}
        total = sum(loads.values())
        fair = total * (float(self.target_shards)
                        / max(self.num_shards, 1))
        mine = sum(loads[s] for s in owned)
        victim = min(owned, key=lambda s: loads[s])
        if mine - loads[victim] < fair:
            return
        # Absorption check: shed only when some OTHER live replica could
        # take the victim without itself going over fair — read the
        # store's current lease records and sum each holder's owned
        # load.  Without this, a shrunken fleet (post-kill: 2 survivors
        # over 3 shards, both necessarily over the stale static fair
        # share) livelocks: shed -> peer defers the free shard -> the
        # claim-anyway floor re-claims it -> shed again, and the shard
        # spends most of its time unowned.  A peer that holds NOTHING is
        # invisible to this scan, so we conservatively keep the shard —
        # the free-shard claim deferral already gives idle replicas
        # their window.
        peer_load: dict = {}
        for shard in range(self.num_shards):
            try:
                _version, record = self.locks[shard].get()
            except Exception:  # lint: allow-swallow(an unreadable lease record just vetoes shedding this tick; counted, retried next tick)
                metrics.note_swallowed("shard_lease_shed")
                return
            holder = (record or {}).get("holderIdentity") or ""
            expires = ((record or {}).get("renewTime", 0.0)
                       + (record or {}).get("leaseDurationSeconds",
                                            self.lease_duration))
            if holder and holder != self.identity and now < expires:
                peer_load[holder] = peer_load.get(holder, 0.0) \
                    + loads[shard]
        if not any(pl + loads[victim] <= fair
                   for pl in peer_load.values()):
            return
        from ..cli.leader_election import cas_release
        if cas_release(self.locks[victim], self.identity,
                       self.lease_duration):
            with self._lock:
                self._renewed.pop(victim, None)
            log.info("shard %d shed by %s (owned load %.1f > fair %.1f)",
                     victim, self.identity, mine, fair)
            metrics.note_shard_lease(victim, "shed")
            metrics.note_shard_rebalance("shed")
            metrics.clear_shard_owner(victim, self.identity)
            self._notify_change(victim, "shed")

    def _notify_change(self, shard: int, kind: str) -> None:
        hook = self.on_change
        if hook is None:
            return
        try:
            hook(shard, kind)
        except Exception:  # lint: allow-swallow(an observer must never kill the lease loop mid-transition; the miss is counted and the next tick re-notifies nothing worse than a late rescope)
            metrics.note_swallowed("lease_on_change")

    def _record(self, now: float) -> dict:
        return {"holderIdentity": self.identity,
                "renewTime": now,
                "leaseDurationSeconds": self.lease_duration}

    def _lose(self, shard: int, kind: str) -> None:
        with self._lock:
            was_owned = self._renewed.pop(shard, None) is not None
        if was_owned:
            log.warning("shard %d lease lost (%s): fencing writes and "
                        "abandoning the shard", shard, kind)
            metrics.note_shard_lease(shard, kind)
            metrics.note_shard_rebalance("lost")
            metrics.clear_shard_owner(shard, self.identity)
            self._notify_change(shard, kind)

    def _tick_shard(self, shard: int) -> None:
        plan = chaos_plan.PLAN
        now = time.time()
        with self._lock:
            renewed = self._renewed.get(shard)
        owned = renewed is not None
        if owned and plan is not None and \
                plan.fire(f"lease.clock_skew:{shard}"):
            # Injected clock skew: our clock claims the lease already
            # expired under us.  The only safe move is to abandon the
            # shard — the fence refuses its bind egress — and re-claim
            # through the normal CAS path (doc/CHAOS.md).
            self._lose(shard, "clock_skew")
            return
        lock = self.locks[shard]
        version, record = lock.get()
        holder = (record or {}).get("holderIdentity") or ""
        expires = ((record or {}).get("renewTime", 0.0)
                   + (record or {}).get("leaseDurationSeconds",
                                        self.lease_duration))
        if owned:
            if record is not None and holder != self.identity:
                # Another replica's CAS landed (our lease expired and
                # was stolen): we are no longer the owner, regardless of
                # what our clock thinks.
                self._lose(shard, "stolen_from")
                return
            cas_ok = False
            if not (plan is not None
                    and plan.fire(f"lease.cas_conflict:{shard}")):
                cas_ok = self._cas(lock, self._record(now), version)
            if cas_ok:
                with self._lock:
                    self._renewed[shard] = now
                return
            if now - renewed > self.renew_deadline:
                self._lose(shard, "renew_timeout")
            return
        # Not owned: claim free/expired leases (and our own stale record
        # — re-acquiring a lease we still hold at the store is the
        # normal recovery from an injected clock skew).
        if record is not None and holder and holder != self.identity \
                and now < expires:
            self._deferred_since.pop(shard, None)
            return  # live lease elsewhere
        if self.target_shards is not None and not holder:
            # Soft spread over FREE shards only (never claimed, or
            # cleanly released): at/over target, sit out one lease
            # duration so an under-loaded replica claims first — then
            # claim anyway (an orphan shard beats balance).  An EXPIRED
            # lease (holder set) is a dead replica's shard: steal it
            # immediately, spread be damned — the reclaim-within-one-
            # lease-duration failover bound outranks balance
            # (doc/TENANCY.md).
            with self._lock:
                owned = list(self._renewed)
            if self._over_target(owned):
                since = self._deferred_since.setdefault(shard, now)
                if now - since < self.lease_duration:
                    return
            else:
                self._deferred_since.pop(shard, None)
        if plan is not None and plan.fire(f"lease.cas_conflict:{shard}"):
            return  # injected: another replica won the claim race
        if not self._cas(lock, self._record(now), version):
            return  # genuinely lost the race; next tick re-reads
        self._deferred_since.pop(shard, None)
        kind = ("steal" if holder and holder != self.identity
                else "claim")
        with self._lock:
            self._renewed[shard] = now
        log.info("shard %d lease %sed by %s", shard, kind, self.identity)
        metrics.note_shard_lease(shard, kind)
        metrics.note_shard_rebalance(kind)
        metrics.set_shard_owner(shard, self.identity)
        if self._on_claim is not None:
            self._on_claim(shard)
        self._notify_change(shard, kind)

    def _over_target(self, owned) -> bool:
        """Whether claiming one more shard should defer for spread.
        Count-based without a load estimator (the count rule);
        load-weighted with one: defer once this replica's owned load
        reaches the fair share its target fraction implies.  A +1 floor
        per shard keeps empty shards claimable-but-weighted (every shard
        costs at least a session to own), and any estimator failure
        degrades to the count rule — never to a stuck shard."""
        if self.target_shards is None:
            return False
        if self.shard_load is not None:
            try:
                loads = [max(float(self.shard_load(s)), 0.0) + 1.0
                         for s in range(self.num_shards)]
                total = sum(loads)
                mine = sum(loads[s] for s in owned)
                fair = total * (float(self.target_shards)
                                / max(self.num_shards, 1))
                return mine >= fair
            except Exception:  # lint: allow-swallow(load estimator failure degrades the deferral to the count rule; counted, and the orphan-beats-balance bound is unaffected)
                metrics.note_swallowed("shard_load_estimate")
        return len(owned) >= self.target_shards

    @staticmethod
    def _cas(lock: StoreLock, record: dict, version: int) -> bool:
        try:
            return lock.cas(record, version)
        except Exception:  # lint: allow-swallow(CAS conflict or unreachable store both mean "did not acquire"; the renew deadline fences a persistently failing renewal)
            return False

    def _publish(self) -> None:
        """Metrics + /debug/shards rows from the store's current lease
        records (covers shards owned by OTHER replicas too)."""
        now = time.time()
        with self._lock:
            renewed = dict(self._renewed)
        for shard in range(self.num_shards):
            try:
                _version, record = self.locks[shard].get()
            except Exception:  # lint: allow-swallow(debug/metrics publication is best-effort; an unreachable store already degrades the renew path visibly)
                metrics.note_swallowed("shard_lease_publish")
                continue
            holder = (record or {}).get("holderIdentity") or ""
            renew_time = (record or {}).get("renewTime", 0.0)
            duration = (record or {}).get("leaseDurationSeconds",
                                          self.lease_duration)
            owned_here = shard in renewed
            if holder:
                metrics.set_shard_owner(shard, holder)
                metrics.set_shard_lease_age(shard, max(0.0,
                                                       now - renew_time))
            shard_table.note_lease(shard, holder, renew_time, duration,
                                   owned_here)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(self.retry_period)

    def start(self) -> "ShardLeaseManager":
        thread = threading.Thread(target=self._loop, daemon=True,
                                  name=f"shard-leases-{self.identity[:8]}")
        thread.start()
        self._thread = thread
        return self

    def stop(self, release: bool = True, timeout: float = 5.0) -> None:
        """Stop renewing.  ``release=True`` (clean shutdown) CAS-clears
        every owned lease so survivors claim immediately instead of
        waiting out the expiry; ``release=False`` simulates a crash —
        the soak's mid-run replica kill."""
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout)
        if not release:
            with self._lock:
                self._renewed.clear()
            return
        from ..cli.leader_election import cas_release
        for shard in list(self.owned_shards()):
            if cas_release(self.locks[shard], self.identity,
                           self.lease_duration):
                metrics.note_shard_lease(shard, "release")
                metrics.note_shard_rebalance("release")
                metrics.clear_shard_owner(shard, self.identity)
        with self._lock:
            self._renewed.clear()
