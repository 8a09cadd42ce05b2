"""Seed-deterministic fault plan: the chaos engine's decision core.

Every hardened code path hosts one or more *named injection sites* (the
catalogue lives in doc/CHAOS.md): the edge watch stream, the bind/evict
egress, the solver dispatch/fetch pair, the batched eviction solve, and
session open.  A site activation asks the installed :class:`FaultPlan`
whether to inject; the plan answers from a keyed hash of
``(seed, site, activation-index)``, so the same seed produces a
byte-identical fault schedule on every run, per site, regardless of how
threads interleave across sites (each site consumes its own decision
stream).

Hot-path contract: when ``KUBE_BATCH_TPU_CHAOS`` is unset, ``PLAN`` is
None and every site is a single ``is None`` branch — no hashing, no
locks, no counters (pinned by tests/test_chaos.py exactly like the trace
kill switch).  Callsites therefore read the module attribute each time::

    plan = chaos.PLAN
    if plan is not None and plan.fire("solve.device_error"):
        raise RuntimeError("chaos: ... (injected)")

Spec grammar (the env value; doc/CHAOS.md "Fault plan grammar")::

    KUBE_BATCH_TPU_CHAOS = "seed=<int>[,rate=<0..1>]
                            [,sites=<pat>|<pat>...]
                            [,rates=<pat>:<0..1>|<pat>:<0..1>...]
                            [,budget=<int>]"

``sites``/``rates`` patterns are fnmatch globs matched against the full
site name and its base (the part before a ``:`` qualifier, e.g.
``watch.disconnect`` for ``watch.disconnect:pods``); ``rates`` overrides
the default rate per site (first matching pattern wins — without it, a
uniform rate lets upstream cycle-killing sites like ``session.snapshot``
starve the downstream solve sites of activations); ``budget`` bounds the
total number of injected faults, after which the schedule is drained
(the soak harness's convergence phase).  A malformed spec raises at
parse time — a chaos run is always deliberate, and silently running
without faults would make a green soak meaningless.
"""

from __future__ import annotations

import fnmatch
import hashlib
import threading
from typing import Dict, NamedTuple, Optional, Tuple

from .. import knobs

CHAOS_ENV = knobs.CHAOS.env

_DEFAULT_RATE = 0.2


class Fault(NamedTuple):
    """One injected fault: which site fired, at which per-site activation,
    with a deterministic severity draw in [0, 1) (sites that need a
    magnitude — e.g. how long a slow solve sleeps — scale this)."""
    site: str
    seq: int
    magnitude: float


def _draw(seed: int, site: str, seq: int) -> Tuple[float, float]:
    """(fire, magnitude) uniforms for one activation — a keyed blake2b of
    the (site, seq) coordinate, so the stream is deterministic across
    runs, platforms, and thread interleavings."""
    digest = hashlib.blake2b(
        f"{site}:{seq}".encode(),
        key=str(seed).encode()[:64], digest_size=16).digest()
    return (int.from_bytes(digest[:8], "big") / 2 ** 64,
            int.from_bytes(digest[8:], "big") / 2 ** 64)


class FaultPlan:
    """The installed fault schedule.  ``fire`` is the only mutating entry
    point: one call = one site activation = one decision consumed from
    that site's stream."""

    def __init__(self, seed: int = 0, rate: float = _DEFAULT_RATE,
                 sites: Tuple[str, ...] = ("*",),
                 budget: Optional[int] = None,
                 rates: Tuple[Tuple[str, float], ...] = ()):
        for r in (rate, *(r for _, r in rates)):
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"chaos rate must be in [0, 1], got {r}")
        self.seed = int(seed)
        self.rate = float(rate)
        self.sites = tuple(sites) if sites else ("*",)
        self.rates = tuple(rates)
        self.budget = budget
        self._lock = threading.Lock()
        self._seq: Dict[str, int] = {}    # guarded-by: _lock
        self._fired: Dict[str, int] = {}  # guarded-by: _lock
        self._total_fired = 0             # guarded-by: _lock

    def _matches(self, site: str) -> bool:
        base = site.split(":", 1)[0]
        return any(fnmatch.fnmatchcase(site, pat)
                   or fnmatch.fnmatchcase(base, pat)
                   for pat in self.sites)

    def _rate_for(self, site: str) -> float:
        base = site.split(":", 1)[0]
        for pat, rate in self.rates:
            if (fnmatch.fnmatchcase(site, pat)
                    or fnmatch.fnmatchcase(base, pat)):
                return rate
        return self.rate

    def fire(self, site: str) -> Optional[Fault]:
        """One activation of ``site``: the Fault to inject, or None.

        The per-site sequence number advances on every activation —
        including budget-drained ones — so the decision stream a site
        sees is a pure function of (seed, site, activation index)."""
        if not self._matches(site):
            return None
        with self._lock:
            seq = self._seq.get(site, 0)
            self._seq[site] = seq + 1
            if (self.budget is not None
                    and self._total_fired >= self.budget):
                return None
            fire_u, magnitude = _draw(self.seed, site, seq)
            if fire_u >= self._rate_for(site):
                return None
            self._total_fired += 1
            self._fired[site] = self._fired.get(site, 0) + 1
        from ..metrics import metrics
        metrics.note_chaos_injected(site)
        return Fault(site, seq, magnitude)

    def preview(self, site: str, n: int) -> bytes:
        """The first ``n`` decisions of ``site``'s stream as bytes (one
        fire flag + 4 magnitude bytes per activation), WITHOUT consuming
        anything — the determinism oracle: two plans with the same seed
        must preview byte-identically, and a live ``fire`` sequence must
        match its own preview (tests/test_chaos.py)."""
        out = bytearray()
        rate = self._rate_for(site)
        for seq in range(n):
            fire_u, magnitude = _draw(self.seed, site, seq)
            out.append(1 if fire_u < rate else 0)
            out += int(magnitude * 0xFFFFFFFF).to_bytes(4, "big")
        return bytes(out)

    def injected(self) -> Dict[str, int]:
        """{site: faults injected} so far (soak artifact / tests)."""
        with self._lock:
            return dict(self._fired)

    def total_injected(self) -> int:
        with self._lock:
            return self._total_fired

    def drained(self) -> bool:
        """True once the budget is exhausted (no further fault can fire);
        always False for an unbudgeted plan."""
        with self._lock:
            return (self.budget is not None
                    and self._total_fired >= self.budget)


def plan_from_spec(spec: Optional[str]) -> Optional[FaultPlan]:
    """Parse the env grammar into a FaultPlan; None disables (unset,
    empty, "0", "off").  Unknown keys and malformed values raise."""
    if not spec:
        return None
    spec = spec.strip()
    if spec.lower() in ("0", "off", "false"):
        return None
    seed, rate, sites, budget = 0, _DEFAULT_RATE, ("*",), None
    rates: tuple = ()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"chaos spec entry {part!r}: expected key=value "
                "(doc/CHAOS.md grammar)")
        key, value = (s.strip() for s in part.split("=", 1))
        if key == "seed":
            seed = int(value)
        elif key == "rate":
            rate = float(value)
        elif key == "sites":
            sites = tuple(s.strip() for s in value.split("|") if s.strip())
        elif key == "rates":
            pairs = []
            for entry in value.split("|"):
                entry = entry.strip()
                if not entry:
                    continue
                pat, _, r = entry.rpartition(":")
                if not pat:
                    raise ValueError(
                        f"chaos rates entry {entry!r}: expected "
                        "<pattern>:<rate>")
                pairs.append((pat.strip(), float(r)))
            rates = tuple(pairs)
        elif key == "budget":
            budget = int(value)
        else:
            raise ValueError(
                f"unknown chaos spec key {key!r} (grammar: seed=, rate=, "
                "sites=, rates=, budget= — doc/CHAOS.md)")
    return FaultPlan(seed=seed, rate=rate, sites=sites, budget=budget,
                     rates=rates)


# The process-wide plan.  Read via the MODULE attribute at every site
# (``chaos.PLAN``), never from-imported, so install/disable take effect
# immediately.  Parsed once at import: a chaos run sets the env before
# the process starts; in-process harnesses use install()/disable().
PLAN: Optional[FaultPlan] = plan_from_spec(knobs.CHAOS.raw())


def active() -> Optional[FaultPlan]:
    return PLAN


def install(plan: FaultPlan) -> FaultPlan:
    """Install a plan programmatically (soak harness, tests)."""
    global PLAN
    PLAN = plan
    return plan


def disable() -> None:
    global PLAN
    PLAN = None


def reload_from_env() -> Optional[FaultPlan]:
    global PLAN
    PLAN = plan_from_spec(knobs.CHAOS.raw())
    return PLAN
