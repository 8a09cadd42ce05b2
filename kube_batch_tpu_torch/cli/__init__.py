"""Process runtime (L6), as far as the port has it: leader election.

Counterpart of kube_batch_tpu/cli/.  Only ``leader_election`` is ported
(the shard leases of tenancy/leases.py build on its ``StoreLock``); the
flags, the server runtime and the metrics endpoint come with the wire
slice (ROADMAP queue 1 item 9).
"""

from .leader_election import (FileLock, LeaderElectionConfig, LeaderElector,
                              StoreLock, cas_release)

__all__ = ["FileLock", "LeaderElectionConfig", "LeaderElector", "StoreLock",
           "cas_release"]
