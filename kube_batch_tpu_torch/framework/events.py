"""Session events (reference framework/event.go:20-31)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from ..api.job_info import TaskInfo


@dataclass
class Event:
    task: TaskInfo


@dataclass
class AllocateBatch:
    """Argument to EventHandler.batch_allocate_func.

    ``tasks`` is always set (placement order).  When the caller has
    vectorized aggregates (the tpu-allocate apply path), ``job_sums`` maps
    job uid -> Resource summed over the batch and ``node_quanta`` maps node
    name -> (cpu, mem) int grid quanta summed over the batch, letting
    plugins skip per-task work; both are None on the generic path."""
    tasks: list
    job_sums: Optional[dict] = None
    node_quanta: Optional[dict] = None


@dataclass
class EventHandler:
    """Allocate/Deallocate callbacks plugins register to keep incremental
    state (DRF shares, proportion allocations) in sync with decisions.

    ``batch_allocate_func`` is an optional bulk form taking an
    AllocateBatch: plugin state updates are linear in the placed tasks, so
    a batch apply (Session.batch_apply) lets plugins aggregate per job/
    queue/node instead of paying one callback per task.  When absent, the
    batch path falls back to per-task allocate_func calls."""
    allocate_func: Optional[Callable[[Event], None]] = None
    deallocate_func: Optional[Callable[[Event], None]] = None
    batch_allocate_func: Optional[Callable[["AllocateBatch"], None]] = None
