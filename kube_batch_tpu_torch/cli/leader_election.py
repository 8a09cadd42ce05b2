"""Leader election over a shared lock object.

Counterpart of kube_batch_tpu/cli/leader_election.py, copied whole: host
Python, no device work.  kube-batch coordinates HA standbys with a
ConfigMap-lock LeaderElector (lease 15s / renew 10s / retry 5s,
cmd/kube-batch/app/server.go); loss of lease kills the scheduling loop
and a standby takes over.  Two lock backends:

- ``StoreLock``: a lease object in the cluster-state store, updated via
  compare-and-swap on its resource version (the ConfigMap analog) — any
  standby anywhere that can reach the store (in-process Cluster or the
  HTTP edge) coordinates through it.
- ``FileLock``: a lock file with the same lease semantics, for
  multi-process deployments sharing a filesystem (no store required).
"""

from __future__ import annotations

import fcntl  # FileLock is Unix-only; fail at import, not silently in cas()
import json
import os
import socket
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

DEFAULT_LEASE_DURATION = 15.0
DEFAULT_RENEW_DEADLINE = 10.0
DEFAULT_RETRY_PERIOD = 5.0

LOCK_NAME = "kube-batch-lock"


class FileLock:
    """Lock record in a file with true compare-and-swap semantics.

    A version counter is stored inside the record; ``cas`` serializes the
    re-read/compare/replace under an ``fcntl.flock`` on a sidecar file, so
    two standbys that both observed an expired lease cannot both "acquire"
    it (the loser sees the bumped version and fails).  flock is released by
    the kernel when the holder dies — a crashed process cannot wedge the
    mutex, and there is no stale-break heuristic to race on.

    CAUTION: flock coherence is per-host on common network filesystems
    (NFS with local_lock, SMB) — contenders on DIFFERENT hosts may each
    take a host-local flock and race the read/compare/replace.  FileLock
    is therefore for same-host multi-process deployments (or a
    flock-coherent shared FS); multi-host HA must use StoreLock, whose
    CAS is serialized by the store itself."""

    def __init__(self, path: str):
        self.path = path
        self._sidecar = f"{path}.mutex"

    def _read(self):
        try:
            with open(self.path) as f:
                record = json.load(f)
            return int(record.get("version", 0)), record
        except (OSError, ValueError):
            return 0, None

    def get(self):
        return self._read()

    def cas(self, record: dict, expected_version: int) -> bool:
        try:
            fd = os.open(self._sidecar, os.O_CREAT | os.O_RDWR)
        except OSError:
            return False
        try:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                return False  # another contender is mid-CAS
            current_version, _ = self._read()
            if current_version != expected_version:
                return False
            record = dict(record, version=expected_version + 1)
            tmp = f"{self.path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(record, f)
            os.replace(tmp, self.path)
            return True
        except OSError:
            return False
        finally:
            os.close(fd)  # releases the flock


class StoreLock:
    """Lease object in the cluster store (Cluster or RemoteCluster —
    both expose get_lease/cas_lease; over the edge the CAS rides a
    version-guarded PUT that 409s on conflict)."""

    def __init__(self, cluster, namespace: str, name: str = LOCK_NAME):
        self.cluster = cluster
        self.namespace = namespace
        self.name = name

    def get(self):
        return self.cluster.get_lease(self.namespace, self.name)

    def cas(self, record: dict, expected_version: int) -> bool:
        try:
            self.cluster.cas_lease(self.namespace, self.name, record,
                                   expected_version)
            return True
        except (ValueError, KeyError):
            return False


def cas_release(lock, identity: str,
                lease_duration: float = DEFAULT_LEASE_DURATION) -> bool:
    """CAS-clear a lease THIS identity holds so the next contender can
    acquire immediately instead of waiting out the expiry.  Returns
    False (never raises) when the lease is not ours, the CAS loses, or
    the store is unreachable — release is best-effort by design: an
    unreleased lease simply expires on schedule.  Shared by the global
    elector's embedders and the per-shard federation
    (tenancy/leases.ShardLeaseManager, doc/TENANCY.md)."""
    try:
        version, record = lock.get()
    except Exception:  # lint: allow-swallow(unreachable store: the lease will expire on schedule, which is the release fallback)
        return False
    if (record or {}).get("holderIdentity") != identity:
        return False
    released = {"holderIdentity": "", "renewTime": 0.0,
                "leaseDurationSeconds": lease_duration,
                "releasedBy": identity, "releasedAt": time.time()}
    try:
        return bool(lock.cas(released, version))
    except Exception:  # lint: allow-swallow(CAS conflict means someone already replaced the record; expiry remains the fallback)
        return False


@dataclass
class LeaderElectionConfig:
    lock_path: str = ""
    identity: str = ""
    lease_duration: float = DEFAULT_LEASE_DURATION
    renew_deadline: float = DEFAULT_RENEW_DEADLINE
    retry_period: float = DEFAULT_RETRY_PERIOD

    def __post_init__(self):
        if not self.identity:
            # hostname + uuid, like client-go's default id: pid alone
            # collides for two electors in one process, and the second
            # would mistake the first's lease for its own and self-renew.
            import uuid
            self.identity = (f"{socket.gethostname()}-{os.getpid()}-"
                             f"{uuid.uuid4().hex[:8]}")


class LeaderElector:
    """Acquire-and-renew loop (client-go leaderelection semantics) over a
    pluggable lock."""

    def __init__(self, config: LeaderElectionConfig,
                 on_started_leading: Callable[[], None],
                 on_stopped_leading: Callable[[], None],
                 lock=None):
        self.config = config
        self.lock = lock if lock is not None else FileLock(config.lock_path)
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._stop = threading.Event()
        self.is_leader = False
        self.last_renew = 0.0

    def has_live_lease(self) -> bool:
        """True while this elector holds a lease it has renewed within
        renew_deadline.  Unlike ``is_leader`` (flipped by the elector
        *thread*, which may not have run yet after a long process pause),
        this is wall-clock-based: a zombie that slept past its deadline is
        fenced immediately, regardless of thread scheduling."""
        return (self.is_leader
                and time.time() - self.last_renew
                < self.config.renew_deadline)

    def try_acquire_or_renew(self) -> bool:
        try:
            version, record = self.lock.get()
        except Exception:  # lint: allow-swallow(store unreachable: cannot prove the lease, so report not-acquired and retry next tick)
            return False
        now = time.time()
        if (record is not None
                and record.get("holderIdentity") != self.config.identity):
            expires = record.get("renewTime", 0) + record.get(
                "leaseDurationSeconds", self.config.lease_duration)
            if now < expires:
                return False  # someone else holds a live lease
        new_record = {"holderIdentity": self.config.identity,
                      "renewTime": now,
                      "leaseDurationSeconds": self.config.lease_duration}
        try:
            return self.lock.cas(new_record, version)
        except Exception:  # lint: allow-swallow(CAS conflict or unreachable store both mean "did not acquire"; the elector loop retries)
            return False

    # -- loop ---------------------------------------------------------------

    def run(self) -> None:
        """Block until leadership is acquired, run the callback, then renew
        until the lease is lost (then on_stopped_leading halts the loop,
        like the reference's fatal exit path, server.go:135-137)."""
        while not self._stop.is_set():
            if self.try_acquire_or_renew():
                break
            self._stop.wait(self.config.retry_period)
        if self._stop.is_set():
            return
        self.last_renew = time.time()
        self.is_leader = True
        # client-go runs OnStartedLeading in its own goroutine
        # (leaderelection.go): a slow leader startup (cache sync at scale)
        # must not delay renewals, or the wall-clock fence would refuse the
        # new leader's first writes and one transient store hiccup could
        # abdicate it despite the continuous-failure deadline.
        threading.Thread(target=self.on_started_leading, daemon=True).start()
        # client-go renewal semantics: retry every retry_period; abdicate
        # only after renew_deadline of CONTINUOUS failure — one transient
        # store hiccup must not fail over a healthy leader.
        while not self._stop.is_set():
            self._stop.wait(self.config.retry_period)
            if self._stop.is_set():
                break
            if self.try_acquire_or_renew():
                self.last_renew = time.time()
            elif time.time() - self.last_renew > self.config.renew_deadline:
                self.is_leader = False
                self.on_stopped_leading()
                return

    def stop(self) -> None:
        self._stop.set()
