"""Process runtime (L6): flags, server, metrics endpoint, leader election.

Counterpart of kube_batch_tpu/cli/.  ``main`` boots the daemon on the
card; ``ServerRuntime`` also runs on the CPU when its caller passes
``device="cpu"``.
"""

from .options import ServerOption, parse_options
from .server import ServerRuntime, start_metrics_server, load_cluster_state
from .leader_election import (FileLock, LeaderElectionConfig, LeaderElector,
                              StoreLock, cas_release)

__all__ = ["ServerOption", "parse_options", "ServerRuntime",
           "start_metrics_server", "load_cluster_state",
           "FileLock", "LeaderElectionConfig", "LeaderElector", "StoreLock",
           "cas_release"]
