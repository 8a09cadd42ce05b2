"""Circuit breaker: graceful degradation for the device path
(kube_batch_tpu/chaos/breaker.py).

The breaker gives the device path the standard closed/open/half-open
state machine (doc/CHAOS.md "Breaker semantics"):

* CLOSED — healthy; every failure increments a consecutive counter, and
  ``threshold`` consecutive failures trip to OPEN.
* OPEN — the device path is quarantined: ``allow()`` refuses, and the
  eviction scanner leaves the actions on their host walk.  After
  ``cooldown`` seconds the next ``allow()`` turns the breaker HALF_OPEN.
* HALF_OPEN — probe traffic is admitted until the first outcome: a
  ``success()`` closes the breaker, a ``failure()`` re-opens it and
  restarts the cooldown.  (No probe-in-flight latch: the scheduling loop
  is effectively single-threaded per cycle, and "admit until first
  outcome" keeps a probe that never dispatches — e.g. a session with no
  pending tasks — from wedging the state machine.)

The port does not feed the breaker yet: a device failure on the session
solve or the eviction engine raises instead of degrading to the host
walk, and nothing calls ``failure()`` until the degradation comes with
ROADMAP queue 1 item 11.  The eviction scanner already consults
``allow()`` and resolves a half-open probe (models/scanner.py), so an
operator or a test that opens the breaker sends the eviction actions to
their host walk.  The reference's per-session solve deadline
(``solve_deadline_s``, read by tpu-allocate) comes with item 11 too.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from .. import knobs

THRESHOLD_ENV = knobs.BREAKER_THRESHOLD.env
COOLDOWN_ENV = knobs.BREAKER_COOLDOWN_S.env
_DEF_THRESHOLD = knobs.BREAKER_THRESHOLD.default
_DEF_COOLDOWN_S = knobs.BREAKER_COOLDOWN_S.default

CLOSED = "closed"
HALF_OPEN = "half-open"
OPEN = "open"
_STATE_CODE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class CircuitBreaker:

    def __init__(self, name: str, threshold: Optional[int] = None,
                 cooldown: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.threshold = (threshold if threshold is not None
                          else knobs.BREAKER_THRESHOLD.value())
        self.cooldown = (cooldown if cooldown is not None
                         else knobs.BREAKER_COOLDOWN_S.value())
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED     # guarded-by: _lock
        self._failures = 0       # guarded-by: _lock
        self._opened_at = 0.0    # guarded-by: _lock
        self._publish(CLOSED)

    # -- state reads --------------------------------------------------------

    def state(self) -> str:
        with self._lock:
            return self._state

    def closed(self) -> bool:
        with self._lock:
            return self._state == CLOSED

    def allow(self) -> bool:
        """May the caller attempt the protected operation?  CLOSED and
        HALF_OPEN: yes.  OPEN: no, until the cooldown elapses — then the
        breaker turns HALF_OPEN and admits probe traffic."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if (self._state == OPEN
                    and self._clock() - self._opened_at >= self.cooldown):
                self._transition(HALF_OPEN)
            return self._state == HALF_OPEN

    # -- outcomes -----------------------------------------------------------

    def success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != CLOSED:
                self._transition(CLOSED)

    def failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == HALF_OPEN or (
                    self._state == CLOSED
                    and self._failures >= self.threshold):
                self._opened_at = self._clock()
                self._transition(OPEN)
            elif self._state == OPEN:
                # Stragglers failing while open restart the cooldown: the
                # dependency is demonstrably still down.
                self._opened_at = self._clock()

    def reset(self) -> None:
        """Force-close (tests / operator intervention)."""
        with self._lock:
            self._failures = 0
            self._opened_at = 0.0
            if self._state != CLOSED:
                self._transition(CLOSED)

    # -- internals ----------------------------------------------------------

    def _transition(self, to: str) -> None:  # holds-lock: _lock
        self._state = to
        from ..metrics import metrics
        metrics.note_breaker_transition(self.name, to)
        self._publish(to)

    def _publish(self, state: str) -> None:
        from ..metrics import metrics
        metrics.set_breaker_state(self.name, _STATE_CODE[state])
        metrics.set_degraded(f"breaker:{self.name}", state != CLOSED)


# The device-solve breaker shared by the tpu-allocate action and the
# eviction scanner: both consume the same device, so their failures feed
# one state machine and one quarantine decision.
_device_breaker: Optional[CircuitBreaker] = None
_singleton_lock = threading.Lock()


def device_breaker() -> CircuitBreaker:
    global _device_breaker
    if _device_breaker is None:
        with _singleton_lock:
            if _device_breaker is None:
                _device_breaker = CircuitBreaker("device_solve")
    return _device_breaker
