"""Action registration (reference actions/factory.go:28-33)."""

import torch

from ..framework import register_action
from . import allocate, backfill, preempt, reclaim


def register_default_actions(device=None,
                             dtype: torch.dtype = torch.float32) -> None:
    """Register allocate, preempt, reclaim, backfill, tpu-allocate and
    topo-allocate in this package's registry.  tpu-allocate solves on
    ``device`` (CUDA unless the caller passes the CPU; raises without
    CUDA) with float keys of ``dtype``; the eviction actions run their
    node scanner, and topo-allocate its box scan, on the same device."""
    register_action(allocate.new())
    register_action(preempt.new(device, dtype))
    register_action(reclaim.new(device, dtype))
    register_action(backfill.new(device, dtype))
    # The allocate action solved on the device (a CUDA kernel).
    from . import tpu_allocate
    register_action(tpu_allocate.new(device, dtype))
    # Topology-aware slice placement (doc/TOPOLOGY.md): the batched box
    # scan on the same device.
    from . import topo_allocate
    register_action(topo_allocate.new(device, dtype))
