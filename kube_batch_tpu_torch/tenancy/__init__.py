"""Queue-shard tenancy engine (doc/TENANCY.md).

Counterpart of kube_batch_tpu/tenancy/.  The host logic is the
reference's, line for line; what the port adds is the device half of the
pipeline: every session over a ``ShardView`` runs its device work on that
view's own CUDA stream (``ShardView.stream``, given by the engine), so
shard K+1's ship and dispatch never queue behind shard K's kernel.

Tenancy as a SCALING axis instead of an accounting row (ROADMAP item 2):
queues are deterministically assigned to shards (``ShardMap``), cache
churn is attributed to the owning shard (``ShardChurn``), and the
scheduler loop runs one shard-scoped micro-session per dirty shard
(``TenancyEngine`` + ``ShardView``) instead of one global cycle — so a
churn storm in tenant A's queues cannot serialize tenant B's
time-to-bind behind it.  ``ShardPipeline`` overlaps those micro-sessions
through the async device-dispatch window (host phases of shard K+1 run
while shard K's solve executes; retire halves stay in shard order —
"Concurrent micro-sessions").  ``ShardLeaseManager`` takes the same axis
horizontal: N active-active replicas each claim queue-shards via
per-shard CAS leases in the shared store (the per-shard form of the
ConfigMap-lock LeaderElector already ported in cli/leader_election.py),
with steal-on-expiry failover, load-weighted claim targets
(``ShardLoad``), and the truth store's 409 re-bind rejection as the
cross-replica double-bind backstop.

Kill switches: ``KUBE_BATCH_TPU_TENANCY`` unset/``0`` keeps the single
global engine — the bit-parity control arm the tenancy tests pin —
and ``KUBE_BATCH_TPU_CONCURRENT_SHARDS=0`` keeps the strictly
sequential shard walk (the concurrency parity control).
"""

from .debug import shard_table
from .engine import TenancyEngine, engine_from_env
from .leases import ShardLeaseManager
from .pipeline import (CONCURRENT_ENV, INFLIGHT_ENV, ShardPipeline,
                       concurrent_shards_enabled, shard_inflight_depth)
from .shards import (SHARD_MAP_ENV, TENANCY_ENV, ShardChurn, ShardLoad,
                     ShardMap, tenancy_shards)
from .view import ShardView

__all__ = [
    "CONCURRENT_ENV", "INFLIGHT_ENV", "SHARD_MAP_ENV", "TENANCY_ENV",
    "ShardChurn", "ShardLeaseManager", "ShardLoad", "ShardMap",
    "ShardPipeline", "ShardView", "TenancyEngine",
    "concurrent_shards_enabled", "engine_from_env", "shard_inflight_depth",
    "shard_table", "tenancy_shards",
]
