"""Action registration (reference actions/factory.go:28-33)."""

import torch

from ..framework import register_action
from . import allocate


def register_default_actions(device=None,
                             dtype: torch.dtype = torch.float32) -> None:
    """Register allocate and tpu-allocate in this package's registry.
    tpu-allocate solves on ``device`` (CUDA unless the caller passes
    the CPU; raises without CUDA) with float keys of ``dtype``."""
    register_action(allocate.new())
    # The allocate action solved on the device (a CUDA kernel).
    from . import tpu_allocate
    register_action(tpu_allocate.new(device, dtype))
    # preempt, reclaim and backfill come with the eviction engine (ROADMAP
    # queue 1 item 2), topo-allocate with topology (item 3).
