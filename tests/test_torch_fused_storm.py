"""The port's fused one-dispatch program on eviction storms, against the
JAX package (twins of tests/test_fused.py's storm cases).

Each case runs the reference on the CPU as its own tests run it (x64)
and the port with ``device="cpu"`` and float64 keys, on the reference's
shapes (its STORM_SHAPES, ``make_churn_cache(420, 64, 20, 3)``,
``make_storm_served_cache()``), and compares the session end state, the
victims in order, the binds, and the session-dispatch, fused-leg and
fused-route deltas: exact, integers and strings.  On the CPU the port's
allocate leg runs the session kernel's plain version.  The mesh-leg
twins wait for the multi-device mesh (ROADMAP queue 1 item 5), the
poisoned postevict leg's for the host degradation (item 11).
"""

import pytest

from test_torch_utils import (drive_stamped, environ, fused_deltas,
                              reference_gc_guard, storm_conf_text, twin)

__all__ = ["reference_gc_guard"]

STORM_SHAPES = {0: (600, 100, 30, 4), 1: (420, 64, 20, 3)}


@pytest.fixture(autouse=True)
def _scan_all(monkeypatch):
    monkeypatch.setenv("KUBE_BATCH_TPU_SCAN_MIN_NODES", "0")


def storm_session(p, make, env):
    """One stamped shipped-conf session of ``p`` on ``make(synthetic)``
    under ``env``: (state, victims in order, binds, dispatches, legs,
    fused routes)."""
    with environ(env):
        actions, tiers = p.load(storm_conf_text())
        cache, binder = make(p.mod.models_synthetic)
        state, disp, legs, routes = fused_deltas(
            p, lambda: drive_stamped(p, cache, actions, tiers))
        return (state, list(cache.evictor.evicts), dict(binder.binds),
                disp, legs, routes)


ARMS = {
    "fused": {"KUBE_BATCH_TPU_FUSED": "1"},
    "control": {"KUBE_BATCH_TPU_FUSED": "0"},
    "oracle": {"KUBE_BATCH_TPU_FUSED": "0",
               "KUBE_BATCH_TPU_BATCH_EVICT": "0",
               "KUBE_BATCH_TPU_PIPELINE": "0",
               "KUBE_BATCH_TPU_INCREMENTAL": "0"},
}
BASE = {"KUBE_BATCH_TPU_FUSED_STORM": "1", "KUBE_BATCH_TPU_BATCH_EVICT": "1",
        "KUBE_BATCH_TPU_PIPELINE": "1", "KUBE_BATCH_TPU_INCREMENTAL": "1",
        "KUBE_BATCH_TPU_BATCH_COMMIT": "1"}


@pytest.mark.parametrize("seed", sorted(STORM_SHAPES))
def test_storm_parity_vs_control_and_oracle(seed):
    """Fused == per-family control == all-flags-off sequential oracle on
    the churn storm (state, victims and their order, binds), in both
    packages, with equal dispatch and leg deltas per arm."""
    shape = STORM_SHAPES[seed]

    def body(p):
        return {name: storm_session(
            p, lambda s: s.make_churn_cache(*shape), {**BASE, **env})
            for name, env in ARMS.items()}
    got = twin(body)
    assert got["fused"][1], "storm must evict"
    assert got["fused"][:3] == got["control"][:3] == got["oracle"][:3]
    assert got["fused"][3].get("fused", 0) == 1
    assert "fused" not in got["control"][3]


def test_storm_served_parity_vs_storm_off():
    """The storm bit-parity control (FUSED_STORM=0) on the crafted
    served-storm cycle: the postevict leg SERVES, and victims, their
    order, binds and end state equal the per-family re-dispatch arm."""
    def body(p):
        return {name: storm_session(
            p, lambda s: s.make_storm_served_cache(),
            {**BASE, "KUBE_BATCH_TPU_FUSED": "1",
             "KUBE_BATCH_TPU_FUSED_STORM": storm})
            for name, storm in (("storm", "1"), ("control", "0"))}
    got = twin(body)
    assert got["storm"][4].get("postevict/served", 0) >= 1
    assert got["storm"][1] and got["storm"][2]
    assert got["storm"][:3] == got["control"][:3]


def test_storm_commit_window_parity_vs_sequential_commit():
    """Folding the commit flush into the dispatch window changes no
    effect: the BATCH_COMMIT=0 sequential control sees the same victims,
    order, binds and end state."""
    def body(p):
        return {name: storm_session(
            p, lambda s: s.make_storm_served_cache(),
            {**BASE, "KUBE_BATCH_TPU_FUSED": "1",
             "KUBE_BATCH_TPU_BATCH_COMMIT": batch})
            for name, batch in (("window", "1"), ("sequential", "0"))}
    got = twin(body)
    assert got["window"][1], "storm must evict"
    assert got["window"][:3] == got["sequential"][:3]


def test_storm_invalidation_falls_back_per_family():
    """FUSED_STORM=0: the storm's own evictions land between the fused
    dispatch and tpu-allocate's ship, the alloc leg is invalidated
    (counted) and the action re-dispatches per family."""
    def body(p):
        return storm_session(
            p, lambda s: s.make_churn_cache(420, 64, 20, 3),
            {**BASE, "KUBE_BATCH_TPU_FUSED": "1",
             "KUBE_BATCH_TPU_FUSED_STORM": "0"})
    _state, evicts, _binds, disp, legs, routes = twin(body)
    assert evicts, "storm must evict"
    assert disp.get("fused", 0) >= 1 and disp.get("solve", 0) >= 1
    assert legs.get("evict/served", 0) >= 1
    assert legs.get("solve/invalidated", 0) >= 1
    assert routes == {"fused/evict+solve": 1}


def test_storm_cycle_is_exactly_one_dispatch():
    """A storm cycle whose reclaim iteration the device predicted
    exactly converges to ONE dispatch: victims commit from the evict
    leg, the post-eviction placements serve from the postevict leg."""
    def body(p):
        return storm_session(p, lambda s: s.make_storm_served_cache(),
                             {**BASE, "KUBE_BATCH_TPU_FUSED": "1"})
    _state, evicts, binds, disp, legs, routes = twin(body)
    assert evicts and binds
    assert disp == {"fused": 1}, disp
    assert legs.get("evict/served", 0) == 1
    assert legs.get("postevict/served", 0) == 1
    assert routes == {"fused/evict+postevict+solve": 1}


def test_storm_divergence_invalidates_postevict():
    """The conformance filter drops the first slot-order resident from
    the host walk, so the committed victim order differs from the
    device's predicted prefix: the proof refuses the leg (counted), the
    action re-dispatches per family, the critical pod stays."""
    def body(p):
        return storm_session(
            p, lambda s: s.make_storm_served_cache(critical_first=True),
            {**BASE, "KUBE_BATCH_TPU_FUSED": "1"})
    _state, evicts, _binds, disp, legs, _routes = twin(body)
    assert evicts, "storm must still evict"
    assert "storm/low00000" not in evicts
    assert legs.get("postevict/invalidated", 0) >= 1
    assert disp.get("solve", 0) >= 1


def test_storm_flush_rides_dispatch_window():
    """Reclaim's commit sink defers its bulk egress into tpu-allocate's
    device-wait window: nothing reaches the evictor at reclaim exit,
    all of it before the session's binds."""
    def body(p):
        with environ({**BASE, "KUBE_BATCH_TPU_FUSED": "1"}):
            actions, tiers = p.load(storm_conf_text())
            by_name = {a.name(): a for a in actions}
            cache, binder = p.mod.models_synthetic.make_storm_served_cache()
            fw = p.m.framework
            ssn = fw.open_session(cache, tiers)
            ssn._conf_actions = tuple(a.name() for a in actions)
            try:
                by_name["reclaim"].execute(ssn)
                at_reclaim = (len(getattr(ssn, "_deferred_flush", ())),
                              len(cache.evictor.evicts), len(binder.binds))
                by_name["tpu-allocate"].execute(ssn)
                at_allocate = (len(ssn._deferred_flush),
                               list(cache.evictor.evicts),
                               len(binder.binds))
            finally:
                fw.close_session(ssn)
            return at_reclaim, at_allocate
    at_reclaim, at_allocate = twin(body)
    assert at_reclaim == (1, 0, 0)
    assert at_allocate[0] == 0 and len(at_allocate[1]) == 3
    assert at_allocate[2] > 0


def test_fused_off_restores_per_family_dispatches():
    """KUBE_BATCH_TPU_FUSED=0: no fused dispatch, the per-family
    programs run instead."""
    def body(p):
        return storm_session(p, lambda s: s.make_churn_cache(420, 64, 20, 3),
                             {**BASE, "KUBE_BATCH_TPU_FUSED": "0"})
    _state, _evicts, _binds, disp, legs, routes = twin(body)
    assert disp.get("fused", 0) == 0
    assert disp.get("evict", 0) >= 1 and disp.get("solve", 0) >= 1
    assert not legs and not routes
