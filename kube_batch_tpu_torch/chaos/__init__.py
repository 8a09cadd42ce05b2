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
``breaker`` — the circuit breaker + solve deadline fed by every device
              failure: on the CPU the cycle degrades to the host-path
              oracle, on a CUDA device it raises ``DeviceFailure``;
              repeated failures open the breaker, and a half-open probe
              returns to the device.
"""

from . import breaker, plan
from .breaker import CircuitBreaker, DeviceFailure, device_breaker
from .plan import CHAOS_ENV, Fault, FaultPlan, plan_from_spec

__all__ = ["breaker", "plan", "CHAOS_ENV", "Fault", "FaultPlan",
           "plan_from_spec", "CircuitBreaker", "DeviceFailure",
           "device_breaker"]
