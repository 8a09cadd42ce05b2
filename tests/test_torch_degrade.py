"""Degradation of the device half to the host path, the JAX package
against the port, on the CPU.

Twins of the reference's degradation points outside tpu-allocate's own
stages (those are in tests/test_torch_breaker.py): the eviction
scanner's tensorize, its batched dispatch (``evict_solve.device_error``)
and the fused evict leg's readback (``fused.poison``); topo-allocate's
degrade of a failed box scan to the numpy oracle; ``fused_solver._fail``
feeding the breaker; ``tests/test_fused.py::TestOneDispatch::
test_postevict_poison_degrades_without_double_evict``; and
``tests/test_concurrent_shards.py::test_device_error_mid_pipeline_
degrades_one_shard`` and ``::test_stale_fallback_aborts_to_sequential_
rerun``.  Each twin runs the body once per package and both must give
the same end state, victims in order, binds, failure counts by stage and
breaker state; the degraded arm must equal its host control.

On the port alone: the degrade path's own steps — ``discard_solve``,
the shipper's ``invalidate`` and ``flush_deferred`` — each made to
raise: none of them is swallowed, the failing step raises out of the
cycle before anything binds, and the next cycle binds.
"""

import importlib

import pytest

from tests.test_torch_concurrent_shards import _build_cluster
from tests.test_torch_topology import run_topo_arm
from tests.test_torch_utils import (Loop, bind_map, drive_stamped, environ,
                                    loop_twin, storm_conf_text, twin)
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

ROOTS = ("kube_batch_tpu", "kube_batch_tpu_torch")


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    """Both packages' fault plans off and both breakers closed, before
    and after each case; the scanner engages at any size."""
    monkeypatch.setenv("KUBE_BATCH_TPU_SCAN_MIN_NODES", "0")

    def clean():
        for root in ROOTS:
            importlib.import_module(f"{root}.chaos.plan").disable()
            importlib.import_module(
                f"{root}.chaos.breaker").device_breaker().reset()
    clean()
    yield
    clean()


def _fresh_breaker(p, monkeypatch, threshold=99):
    brk = p.mod.chaos_breaker
    br = brk.CircuitBreaker("device_solve", threshold=threshold,
                            cooldown=1.0)
    monkeypatch.setattr(brk, "_device_breaker", br)
    return br


def _failures(p):
    return dict(p.mod.metrics_metrics.device_solve_failures.values())


def _delta(p, before):
    now = _failures(p)
    return {k[0]: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def _storm_session(p, env, sites=(), make=None):
    """One stamped shipped-conf session on a small eviction storm under
    ``env``, with the fault plan ``sites`` at rate 1: (end state,
    victims in order, binds, failure counts by stage, degraded notes)."""
    cp = p.mod.chaos_plan
    spans = p.mod.trace_spans
    with environ(env):
        actions, tiers = p.load(storm_conf_text())
        cache, binder = (make or (lambda s: s.make_churn_cache(
            420, 64, 20, 3)))(p.mod.models_synthetic)
        before = _failures(p)
        plan = (cp.install(cp.FaultPlan(seed=7, rate=1.0, sites=sites))
                if sites else None)
        spans.begin_session()
        try:
            state = drive_stamped(p, cache, actions, tiers)
            notes = list(spans.current_trace().meta.get("degraded", []))
        finally:
            spans.end_session()
            cp.disable()
        injected = (sum(plan.injected().values()) if plan is not None
                    else 0)
        return (state, list(cache.evictor.evicts), dict(binder.binds),
                _delta(p, before), [n.split(" (")[0] for n in notes],
                injected)


@pytest.mark.parametrize("site,stage,env", [
    ("session.tensorize", "tensorize", {}),
    ("evict_solve.device_error", "evict_solve",
     {"KUBE_BATCH_TPU_FUSED": "0"}),
    ("fused.poison", "fused", {"KUBE_BATCH_TPU_FUSED": "1"}),
], ids=["scanner-tensorize", "batched-dispatch", "fused-readback"])
def test_scanner_degradation_points(monkeypatch, site, stage, env):
    """Each of the scanner's three degradation points leaves the
    eviction actions on their host walk or per-profile host scoring:
    the victims in order and the binds equal the all-host
    ``BATCH_EVICT=0`` arm, and the failure is counted under its stage."""
    def body(p):
        _fresh_breaker(p, monkeypatch)
        control = _storm_session(p, {"KUBE_BATCH_TPU_BATCH_EVICT": "0",
                                     "KUBE_BATCH_TPU_FUSED": "0"})
        faulty = _storm_session(p, env, sites=(site,))
        return control, faulty

    control, faulty = twin(body)
    assert control[1], "the storm must evict"
    assert faulty[:3] == control[:3]
    assert faulty[5] >= 1
    assert faulty[3].get(stage, 0) >= 1
    assert set(faulty[3]) <= {stage, "tensorize"}


def test_topo_box_scan_degrades_to_the_oracle(monkeypatch):
    """A failed device box scan: topo-allocate degrades to the numpy
    oracle in both packages, with the ``TOPO_BATCH=0`` arm's binds,
    victims, events and statuses; the swallowed scan is counted in both,
    and the port also counts it under stage ``topo`` (the port feeds its
    breaker where the reference only swallows)."""
    def body(p):
        m = importlib.import_module(
            f"{'kube_batch_tpu_torch' if p.pkg == 'torch' else 'kube_batch_tpu'}"
            ".ops.topo_solver")
        mm = p.mod.metrics_metrics
        _fresh_breaker(p, monkeypatch)
        env = {"KUBE_BATCH_TPU_FUSED": "0"}
        oracle = run_topo_arm(p, True, False, env=env)

        def fail(*_a, **_k):
            raise RuntimeError("device scan failed")

        monkeypatch.setattr(m, "box_scan", fail)
        swallowed = mm.swallowed_exceptions.value("topo_box_scan")
        before = _failures(p)
        got = run_topo_arm(p, True, True, env=env)
        monkeypatch.undo()
        monkeypatch.setenv("KUBE_BATCH_TPU_SCAN_MIN_NODES", "0")
        oracle.pop("dispatches")
        got.pop("dispatches")
        return (got == oracle, bool(oracle["binds"]),
                mm.swallowed_exceptions.value("topo_box_scan") - swallowed,
                _delta(p, before).get("topo", 0))

    out = {}

    def both(p):
        out[p.pkg] = body(p)
        return out[p.pkg][:3]

    same, bound, swallowed = twin(both)
    assert same and bound and swallowed >= 1
    assert out["jax"][3] == 0 and out["torch"][3] == swallowed


def test_fused_fail_feeds_the_breaker(monkeypatch):
    """``fused.device_error`` with a threshold-1 breaker: ``_fail`` opens
    it in both packages; the scanner's per-family re-dispatch (the
    half-open probe's evidence) closes it again, tpu-allocate solves on
    the device, and the binds equal the ``FUSED=0`` control."""
    def body(p):
        br = _fresh_breaker(p, monkeypatch, threshold=1)
        states = []
        real = br.failure
        br.failure = lambda: (real(), states.append(br.state()))[0]
        quiet = (lambda s: s.make_synthetic_cache(300, 32, 12, 2))
        control = _storm_session(p, {"KUBE_BATCH_TPU_FUSED": "0"},
                                 make=quiet)
        faulty = _storm_session(p, {"KUBE_BATCH_TPU_FUSED": "1"},
                                sites=("fused.device_error",), make=quiet)
        return control[:3], faulty[:3], faulty[3], states, br.state()

    control, faulty, delta, states, state = twin(body)
    assert control[2] and faulty == control
    assert delta == {"fused": 1}
    assert states == ["open"] and state == "closed"


def test_postevict_poison_degrades_without_double_evict(monkeypatch):
    """Chaos site fused.postevict_poison: a malformed served leg dies in
    tpu-allocate's _validate_result before any apply, the cycle degrades
    to the host path, its binds equal the oracle's, and the victims are
    evicted exactly once."""
    def body(p):
        _fresh_breaker(p, monkeypatch)
        cp = p.mod.chaos_plan
        actions, tiers = p.load(storm_conf_text())
        with environ({"KUBE_BATCH_TPU_FUSED": "1",
                      "KUBE_BATCH_TPU_FUSED_STORM": "0"}):
            cache, binder = p.mod.models_synthetic.make_storm_served_cache()
            oracle = (drive_stamped(p, cache, actions, tiers),
                      list(cache.evictor.evicts), dict(binder.binds))
        before = _failures(p)
        with environ({"KUBE_BATCH_TPU_FUSED": "1",
                      "KUBE_BATCH_TPU_FUSED_STORM": "1"}):
            plan = cp.install(cp.FaultPlan(
                seed=5, rate=1.0, sites=("fused.postevict_poison",)))
            try:
                cache, binder = \
                    p.mod.models_synthetic.make_storm_served_cache()
                poisoned = (drive_stamped(p, cache, actions, tiers),
                            list(cache.evictor.evicts), dict(binder.binds))
            finally:
                cp.disable()
        return (oracle, poisoned,
                plan.injected().get("fused.postevict_poison", 0),
                _delta(p, before))

    oracle, poisoned, injected, delta = twin(body)
    assert injected >= 1
    assert poisoned == oracle
    assert len(poisoned[1]) == len(set(poisoned[1]))
    assert delta == {"solve": 1}


# ----------------------------------------------------------------------
# the shard pipeline


def test_device_error_mid_pipeline_degrades_one_shard(monkeypatch):
    """solve.device_error injected while shards overlap: the hit shard
    degrades to the host oracle (feeding the breaker), every other
    shard's session stays healthy, and the cycle survives."""
    def body(lp):
        brk = importlib.import_module(
            f"{'kube_batch_tpu_torch' if lp.pkg == 'torch' else 'kube_batch_tpu'}"
            ".chaos.breaker")
        brk.device_breaker().reset()
        monkeypatch.setenv("KUBE_BATCH_TPU_TENANCY", "4")
        monkeypatch.setenv("KUBE_BATCH_TPU_SHARD_MAP", "|".join(
            f"q{t}:{t}" for t in range(4)))
        monkeypatch.setenv("KUBE_BATCH_TPU_CONCURRENT_SHARDS", "1")
        cluster = _build_cluster(lp, tenants=4, seed=3)
        cache = lp.cache.new_scheduler_cache(cluster)
        scheduler = lp.scheduler(cache, schedule_period=3600)
        before = dict(lp.metrics.device_solve_failures.values())
        plan = lp.chaos_plan.install(lp.chaos_plan.FaultPlan(
            seed=11, rate=0.25, sites=("solve.device_error",)))
        try:
            ok = [scheduler.cycle() for _ in range(3)]
        finally:
            lp.chaos_plan.disable()
        binds = bind_map(cluster)
        tenants = [any(f"/base-{t}-" in k for k in binds)
                   for t in range(4)]
        failed = {k[0]: v - before.get(k, 0) for k, v in
                  lp.metrics.device_solve_failures.values().items()
                  if v != before.get(k, 0)}
        state = brk.device_breaker().state()
        brk.device_breaker().reset()
        return (ok, tenants, binds, lp.solver.solver_inflight(),
                plan.injected().get("solve.device_error", 0), failed,
                dict(scheduler.tenancy._failures), state)

    ok, tenants, _binds, inflight, injected, failed, backoff, _ = \
        loop_twin(body)
    assert ok == [True] * 3 and tenants == [True] * 4
    assert inflight == 0 and backoff == {}
    # A hit begin half whose shard then conflicts is rerun fresh, so its
    # degrade continuation never runs: at most one failure per injection.
    assert injected >= 1 and set(failed) <= {"solve"}
    assert failed.get("solve", 0) <= injected


def test_stale_fallback_aborts_to_sequential_rerun(monkeypatch):
    """A successor whose fetch fails AFTER a predecessor committed must
    NOT run the host fallback over its stale snapshot: the pipeline
    aborts it (StaleSessionAbort) and reruns the shard fresh — binds and
    events stay identical to the sequential control under the same
    seeded poison."""
    def body(lp):
        cp = lp.chaos_plan

        def fire_flags(s, n=2):
            pv = cp.FaultPlan(seed=s, rate=0.5, sites=("solve.poison",)
                              ).preview("solve.poison", n)
            return [bool(pv[i * 5]) for i in range(n)]

        seed = next(s for s in range(200)
                    if fire_flags(s) == [False, True])

        def arm(concurrent):
            monkeypatch.setenv("KUBE_BATCH_TPU_TENANCY", "2")
            monkeypatch.setenv("KUBE_BATCH_TPU_SHARD_MAP", "q0:0|q1:1")
            monkeypatch.setenv("KUBE_BATCH_TPU_CONCURRENT_SHARDS",
                               "1" if concurrent else "0")
            cluster = _build_cluster(lp, tenants=2, seed=7)
            cache = lp.cache.new_scheduler_cache(cluster)
            scheduler = lp.scheduler(cache, schedule_period=3600)
            cp.install(cp.FaultPlan(seed=seed, rate=0.5, budget=1,
                                    sites=("solve.poison",)))
            try:
                assert scheduler.cycle()
            finally:
                cp.disable()
            return bind_map(cluster), list(cache.events)

        sb, se = arm(False)
        before = lp.metrics.shard_pipeline_counts().get(
            "conflict_rerun", 0)
        cb, ce = arm(True)
        reruns = lp.metrics.shard_pipeline_counts().get(
            "conflict_rerun", 0) - before
        return sb, se, cb, ce, reruns, lp.solver.solver_inflight(), seed

    sb, se, cb, ce, reruns, inflight, _ = loop_twin(body)
    assert sb, "control arm bound nothing — workload broken"
    assert (cb, ce) == (sb, se)
    assert reruns >= 1 and inflight == 0


# ----------------------------------------------------------------------
# a failing step of the degrade path (the port alone)


@pytest.mark.parametrize("helper", ["discard_solve", "invalidate",
                                    "flush_deferred"])
def test_degrade_path_survives_raising_helpers(monkeypatch, helper):
    """A step of the degrade path that raises — here each clean-up
    helper, once — is not swallowed: the device failure is counted, the
    helper's error raises out of the cycle before the host path binds
    anything (a flush that failed must not leave binds on capacity whose
    victims were never evicted), the in-flight ledger ends at 0, and the
    next cycle binds what a fault-free session binds."""
    from tests.test_torch_e2e import CONF_TPU, Harness
    import kube_batch_tpu_torch.models.shipping as shipping
    import kube_batch_tpu_torch.models.tensor_snapshot as ts
    import kube_batch_tpu_torch.ops.fused_solver as fused_solver
    import kube_batch_tpu_torch.ops.solver as solver
    lp = Loop("torch")

    def harness():
        # A first session leaves a resident image for invalidate to
        # drop; then two gangs arrive for the session under test.
        h = Harness(lp, conf=CONF_TPU)
        h.add_nodes(3, cpu="4")
        h.create_job("w", 1, 1)
        h.cycle()
        h.cluster.delete_pod("test", "w-0")
        h.create_job("a", 3, 3)
        h.create_job("b", 2, 2, queue="q2")
        return h

    clean = harness()
    clean.cycle()
    h = harness()
    raised = []

    def raise_once(real, then_real=False):
        def fn(*a, **k):
            if raised:
                return real(*a, **k)
            raised.append(helper)
            if then_real:
                real(*a, **k)   # the ledger still retires the handle
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        return fn

    if helper == "discard_solve":
        # The dispatch landed, then the begin half failed after it.
        monkeypatch.setattr(solver, "discard_solve",
                            raise_once(solver.discard_solve, True))
        failed = []

        def scaffold(*a, **k):
            if not failed:
                failed.append(1)
                raise RuntimeError("injected host-overlap failure")
            return real_scaffold(*a, **k)

        real_scaffold = ts.prepare_apply_scaffold
        monkeypatch.setattr(ts, "prepare_apply_scaffold", scaffold)
    else:
        target = (shipping.DeviceResidentShipper if helper == "invalidate"
                  else fused_solver)
        monkeypatch.setattr(target, helper,
                            raise_once(getattr(target, helper)))
        lp.chaos_plan.install(lp.chaos_plan.FaultPlan(
            seed=1, rate=1.0, sites=("solve.device_error",)))
    failures = lp.metrics.device_solve_failures.value("solve")
    try:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            h.cycle()
    finally:
        lp.chaos_plan.disable()
    assert raised == [helper]
    # discard_solve raises inside the begin half, before the feed.
    assert lp.metrics.device_solve_failures.value("solve") == failures + (
        helper != "discard_solve")
    assert h.bound() == {}
    assert lp.solver.solver_inflight() == 0
    h.cycle()
    assert h.bound() == clean.bound() and len(h.bound()) == 5
