"""Chaos engine: deterministic fault injection + graceful degradation.

The reference scheduler's core promise is that the loop survives anything
(scheduler.go Run/runOnce swallows bad cycles; cache.go:357-378 resync and
cleanup repair partial state alongside it).  The TPU-native engine grew
four failure surfaces the reference never had — the device solve
dispatch, the resident-buffer delta ship, the batched eviction scanner,
and the edge watch/bind wire — and this package makes all of them
testable under failure (doc/CHAOS.md):

``plan``    — the seed-deterministic fault plan: named injection sites
              threaded through the real code paths, each a no-op single
              branch when ``KUBE_BATCH_TPU_CHAOS`` is unset.
``breaker`` — the device circuit breaker and the solve deadline.  The
              eviction scanner consults it; nothing feeds it until the
              degradation path comes (ROADMAP queue 1 item 11): a device
              failure raises instead of degrading to the host path.
"""

from . import breaker, plan
from .plan import CHAOS_ENV, Fault, FaultPlan, plan_from_spec

__all__ = ["breaker", "plan", "CHAOS_ENV", "Fault", "FaultPlan",
           "plan_from_spec"]
