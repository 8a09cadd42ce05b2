"""The network edge: REST API server + watch-based remote cluster client.

The reference's entire L2 ingest/egress is client-go against a live
Kubernetes API server (cache.go:255-352 informers in, Bind/Evict/status
REST out).  This package is the standalone framework's equivalent network
boundary: ``edge.server.ApiServer`` exposes a Cluster store over HTTP with
list+watch streaming, and ``edge.client.RemoteCluster`` is the client-go
analog — a reflector that mirrors the remote store into local informers
and turns effector verbs into REST calls — so the scheduler process can
run on a different machine than the cluster state.
"""

from .client import RemoteCluster
from .server import ApiServer
from .wire_shard import QUEUE_LABEL, ShardScope, attach_shard_scope

__all__ = ["ApiServer", "RemoteCluster", "QUEUE_LABEL", "ShardScope",
           "attach_shard_scope"]
