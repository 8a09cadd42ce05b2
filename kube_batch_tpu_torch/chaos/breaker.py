"""Circuit breaker: graceful degradation for the device path
(kube_batch_tpu/chaos/breaker.py).

The breaker gives the device path the standard closed/open/half-open
state machine (doc/CHAOS.md "Breaker semantics"):

* CLOSED — healthy; every failure increments a consecutive counter, and
  ``threshold`` consecutive failures trip to OPEN.
* OPEN — the device path is quarantined: ``allow()`` refuses (see
  ``refuse_open`` below for what the callers do then).  After
  ``cooldown`` seconds the next ``allow()`` turns the breaker HALF_OPEN.
* HALF_OPEN — probe traffic is admitted until the first outcome: a
  ``success()`` closes the breaker, a ``failure()`` re-opens it and
  restarts the cooldown.  (No probe-in-flight latch: the scheduling loop
  is effectively single-threaded per cycle, and "admit until first
  outcome" keeps a probe that never dispatches — e.g. a session with no
  pending tasks — from wedging the state machine.)

Both device halves feed it: tpu-allocate (actions/tpu_allocate.py), the
eviction scanner (models/scanner.py), topo-allocate's box scan and the
fused session dispatch (ops/fused_solver.py) count every device failure
here (``feed_failure``).  What follows the feed depends on the device.
Where the action runs on the CPU, the cycle degrades to the host walk,
which is placement-identical by the parity suite, as in the reference.
On a CUDA device no card work moves to the CPU: the failure raises
``DeviceFailure`` after it is fed, and the session aborts before it has
mutated anything (the Scheduler's loop counts the failed cycle and
backs off).  The fused dispatch is the exception that stays on the card:
its families re-dispatch one by one there.

The per-session *solve deadline* (``KUBE_BATCH_TPU_SOLVE_DEADLINE_MS``)
is detective, not preemptive — a running kernel cannot be cancelled from
the host — so a solve that overruns it still has its (valid) result
applied, but counts as a breaker failure: a repeatedly slow device
opens the breaker exactly like a failing one.

An open breaker refuses the device path: on the CPU the actions take
their host walk, on the card the session raises ``DeviceFailure``
without touching the device.  A sticky CUDA error (an illegal address
kills the context) makes every later CUDA call raise, the half-open
probe included: the breaker then stays open, and every session raises,
until the process restarts.  Nothing here resets the context.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

import torch

from .. import knobs

log = logging.getLogger(__name__)

THRESHOLD_ENV = knobs.BREAKER_THRESHOLD.env
COOLDOWN_ENV = knobs.BREAKER_COOLDOWN_S.env
SOLVE_DEADLINE_ENV = knobs.SOLVE_DEADLINE_MS.env
_DEF_THRESHOLD = knobs.BREAKER_THRESHOLD.default
_DEF_COOLDOWN_S = knobs.BREAKER_COOLDOWN_S.default

CLOSED = "closed"
HALF_OPEN = "half-open"
OPEN = "open"
_STATE_CODE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


def solve_deadline_s() -> float:
    """The per-session solve deadline in seconds; 0.0 = disabled."""
    return max(0.0, knobs.SOLVE_DEADLINE_MS.value() / 1e3)


class DeviceFailure(RuntimeError):
    """A device-half failure on a CUDA device, raised after
    ``feed_failure`` fed it (or while the breaker refuses the card):
    the session aborts instead of moving the card's work to the host."""


def host_path_allowed(device) -> bool:
    """Whether a failed device stage may run the host path in its place:
    only where the action runs on the CPU."""
    return torch.device(device).type == "cpu"


def refuse_open(what: str, device, host_note: str) -> None:
    """The breaker refused the device path.  On the CPU: note
    ``host_note`` and return (the caller runs its host walk).  On a CUDA
    device: note the refusal and raise ``DeviceFailure``."""
    from ..trace import spans as trace
    if host_path_allowed(device):
        trace.note_degraded(host_note)
        return
    trace.note_degraded(f"device breaker open: {what} refused the card")
    raise DeviceFailure(f"the device breaker is open: {what} refused the "
                        f"card until its half-open probe")


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

    def cooldown_left(self) -> float:
        """Seconds until an OPEN breaker admits its half-open probe; 0.0
        when it is not open (a harness waits this out instead of
        resetting the breaker)."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self.cooldown - (self._clock() - self._opened_at))

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


def feed_failure(stage: str, note: str, exc: BaseException, owner=None,
                 breaker: Optional[CircuitBreaker] = None,
                 what: str = "device half", device=None) -> None:
    """The one feed of every device-half failure: count a breaker
    failure, ``kube_batch_device_solve_failures_total{stage}``, the
    session trace's ``degraded`` note and a warning with the error's
    text, then drop ``owner``'s resident ship image (``owner`` is the
    cache or shard view whose shipper the failed stage may have left
    half-written).  Calls nothing on the device: it only drops
    references.  With ``device`` on CUDA it then raises
    ``DeviceFailure`` from ``exc``; otherwise the caller runs its host
    path (on the CPU) or re-dispatches on the card (``device`` None,
    the fused dispatch)."""
    from ..metrics import metrics
    from ..trace import spans as trace
    on_card = device is not None and not host_path_allowed(device)
    (breaker or device_breaker()).failure()
    metrics.note_device_failure(stage)
    text = f"{type(exc).__name__}: {exc}"
    if on_card:
        trace.note_degraded(f"device {stage} failed on the card ({text}); "
                            f"{what} raised")
        log.warning("%s: device %s failed on the card, the session "
                    "raises: %s", what, stage, text)
    else:
        trace.note_degraded(note)
        log.warning("%s degraded after a device %s failure: %s", what,
                    stage, text)
    shipper = getattr(owner, "_ship_cache", None)
    if shipper is not None:
        shipper.invalidate()
    if on_card:
        raise DeviceFailure(f"{what}: device {stage} failed: {text}") \
            from exc
