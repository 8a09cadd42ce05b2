"""Action registration (reference actions/factory.go:28-33)."""

import torch

from ..framework import register_action
from . import allocate, backfill, preempt, reclaim


def register_default_actions(device=None,
                             dtype: torch.dtype = torch.float32) -> None:
    """Register allocate, preempt, reclaim, backfill and tpu-allocate in
    this package's registry.  tpu-allocate solves on ``device`` (CUDA
    unless the caller passes the CPU; raises without CUDA) with float
    keys of ``dtype``; the eviction actions run their node scanner on
    the same device and dtype."""
    register_action(allocate.new())
    register_action(preempt.new(device, dtype))
    register_action(reclaim.new(device, dtype))
    register_action(backfill.new(device, dtype))
    # The allocate action solved on the device (a CUDA kernel).
    from . import tpu_allocate
    register_action(tpu_allocate.new(device, dtype))
    # topo-allocate comes with topology (ROADMAP queue 1 item 3).
