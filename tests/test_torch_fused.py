"""The port's fused one-dispatch program against the JAX package: quiet
and topology sessions, a failed fused dispatch, the begin-half read
fences and the lazy node-task view (twins of tests/test_fused.py; the
storm twins are in tests/test_torch_fused_storm.py, the storm leg's
tensor helpers in tests/test_torch_fused_helpers.py).

Each case runs the reference on the CPU as its own tests run it (x64)
and the port with ``device="cpu"`` and float64 keys, on the reference's
shapes, comparing end state, victims in order, binds and the
session-dispatch, fused-leg and fused-route deltas exactly.
"""

import numpy as np
import pytest

from test_torch_utils import (drive_stamped, environ, fused_deltas,
                              reference_gc_guard, storm_conf_text, twin)

__all__ = ["reference_gc_guard"]

TOPO_CONF = """
actions: "topo-allocate, tpu-allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: topology
"""


@pytest.fixture(autouse=True)
def _scan_all(monkeypatch):
    monkeypatch.setenv("KUBE_BATCH_TPU_SCAN_MIN_NODES", "0")


def session(p, make, env, conf=None):
    """One stamped session of ``p`` (the shipped four-action conf, or
    ``conf``) on ``make(synthetic)`` under ``env``: (state, victims in
    order, binds, dispatches, legs, fused routes)."""
    with environ(env):
        actions, tiers = p.load(conf or storm_conf_text())
        cache, binder = make(p.mod.models_synthetic)
        state, disp, legs, routes = fused_deltas(
            p, lambda: drive_stamped(p, cache, actions, tiers))
        return (state, list(cache.evictor.evicts), dict(binder.binds),
                disp, legs, routes)


def quiet(s):
    return s.make_synthetic_cache(300, 32, 12, 2)


# -- sessions ---------------------------------------------------------------

def test_solve_dispatch_is_counted():
    """The port's dispatch_solve counts a ``solve`` session dispatch as
    the reference's does (kube_batch_tpu/ops/solver.py:606): a FUSED=0
    shipped-conf session counts one evict and one solve dispatch in both
    packages."""
    got = twin(lambda p: session(p, quiet, {"KUBE_BATCH_TPU_FUSED": "0"}))
    assert got[2], "the session must bind"
    assert got[3] == {"evict": 1, "solve": 1}, got[3]


def test_quiet_conf_family_parity_and_served_leg():
    """Quiet family: identical binds, no evictions, and the fused
    dispatch's alloc leg SERVES tpu-allocate; the FUSED=0 control binds
    the same."""
    def body(p):
        return {name: session(p, quiet, {"KUBE_BATCH_TPU_FUSED": fused})
                for name, fused in (("fused", "1"), ("control", "0"))}
    got = twin(body)
    assert got["fused"][2] and not got["fused"][1]
    assert got["fused"][:3] == got["control"][:3]
    assert got["fused"][3].get("fused", 0) >= 1
    assert got["fused"][4].get("solve/served", 0) >= 1


@pytest.mark.parametrize("storm", ["1", "0"])
def test_quiet_session_is_exactly_one_dispatch(storm):
    """A no-eviction session under the four-action conf makes EXACTLY
    one solve-family dispatch, the fused program, in both FUSED_STORM
    arms (the storm leg predicts a quiet session and serves as the
    plain solve)."""
    got = twin(lambda p: session(p, quiet, {
        "KUBE_BATCH_TPU_FUSED": "1", "KUBE_BATCH_TPU_FUSED_STORM": storm}))
    assert got[2], "quiet session must bind"
    assert got[3] == {"fused": 1}, got[3]
    assert got[4] == {"solve/served": 1}, got[4]
    legs = "evict+postevict+solve" if storm == "1" else "evict+solve"
    assert got[5] == {f"fused/{legs}": 1}


def test_topology_three_family_dispatch_parity():
    """Topology-led conf on the fragmentation torus: ONE fused dispatch
    carries evict+solve+topo, its topo leg serves, and the decisions
    equal the FUSED=0 control."""
    def body(p):
        env = {"KUBE_BATCH_TPU_TOPO_BATCH": "1",
               "KUBE_BATCH_TPU_TOPO_DEFRAG": "1"}
        return {name: session(p, lambda s: s.make_topo_cache(),
                              {**env, "KUBE_BATCH_TPU_FUSED": fused},
                              conf=TOPO_CONF)
                for name, fused in (("fused", "1"), ("control", "0"))}
    got = twin(body)
    assert got["fused"][5].get("fused/evict+solve+topo", 0) >= 1
    assert got["fused"][4].get("topo/served", 0) >= 1
    assert got["fused"][:3] == got["control"][:3]


def test_device_error_redispatches_per_family(monkeypatch):
    """Chaos site fused.device_error: the fused dispatch fails, every
    staged leg counts ``failed``, the families re-dispatch per family
    with the FUSED=0 arm's binds, and both packages feed the breaker
    once (stage ``fused``), which the re-dispatched solve's success then
    resets."""
    def body(p):
        brk = p.mod.chaos_breaker
        fresh = brk.CircuitBreaker("device_solve", threshold=99,
                                   cooldown=1.0)
        monkeypatch.setattr(brk, "_device_breaker", fresh)
        fed = []
        real_failure = fresh.failure
        fresh.failure = lambda: (fed.append(1), real_failure())[1]
        control = session(p, quiet, {"KUBE_BATCH_TPU_FUSED": "0"})
        plan_mod = p.mod.chaos_plan
        mm = p.mod.metrics_metrics
        before = mm.device_solve_failures.value("fused")
        plan = plan_mod.install(plan_mod.FaultPlan(
            seed=3, rate=1.0, sites=("fused.device_error",)))
        try:
            failed = session(p, quiet, {"KUBE_BATCH_TPU_FUSED": "1"})
        finally:
            plan_mod.disable()
        return (control, failed,
                plan.injected().get("fused.device_error", 0),
                fresh.state(), fresh._failures, len(fed),
                mm.device_solve_failures.value("fused") - before)
    control, failed, injected, state, failures, fed, counted = twin(body)
    assert injected == 1
    assert failed[:3] == control[:3] and failed[2]
    assert failed[3] == {"evict": 1, "solve": 1}
    assert failed[4] == {"evict/failed": 1, "postevict/failed": 1,
                         "solve/failed": 1}
    assert state == "closed"
    assert (fed, counted, failures) == (1, 1, 0)


# -- begin-half read fences (tenancy/footprint.py) --------------------------

def _pipelined_session(p, cache, tiers):
    ssn = p.m.framework.open_session(cache, tiers)
    ssn._pipeline_active = True
    return ssn


def _publish(p, ssn, names):
    import importlib
    root = "kube_batch_tpu_torch" if p.pkg == "torch" else "kube_batch_tpu"
    fp = importlib.import_module(root + ".tenancy.footprint")
    if p.pkg == "torch":
        fp.publish_begin_footprint(ssn, names, "cpu", p.dtype)
    else:
        fp.publish_begin_footprint(ssn, names)


def _fence(ssn):
    fence = ssn._pipeline_fence
    if fence is None:
        return None, ssn._pipeline_reads_all
    names, mask = fence
    return (list(names), None if mask is None
            else np.asarray(mask).tolist()), ssn._pipeline_reads_all


def test_evict_led_conf_publishes_bounded_fence():
    def body(p):
        cache, _ = p.mod.models_synthetic.make_churn_cache(420, 64, 20, 3)
        _actions, tiers = p.load(storm_conf_text())
        ssn = _pipelined_session(p, cache, tiers)
        try:
            _publish(p, ssn, ("reclaim", "tpu-allocate", "backfill",
                              "preempt"))
            return _fence(ssn), len(cache.nodes)
        finally:
            p.m.framework.close_session(ssn)
    ((names, mask), reads_all), n_nodes = twin(body)
    assert not reads_all and len(names) == len(mask)
    assert 0 < sum(mask) <= n_nodes


def test_topo_led_conf_publishes_bounded_fence():
    def body(p):
        with environ({"KUBE_BATCH_TPU_TOPO_BATCH": "1",
                      "KUBE_BATCH_TPU_TOPO_DEFRAG": "1"}):
            cache, _ = p.mod.models_synthetic.make_topo_cache()
            _actions, tiers = p.load(TOPO_CONF)
            ssn = _pipelined_session(p, cache, tiers)
            try:
                _publish(p, ssn, ("topo-allocate", "tpu-allocate",
                                  "backfill"))
                return _fence(ssn)
            finally:
                p.m.framework.close_session(ssn)
    fence, reads_all = twin(body)
    if fence is not None:
        names, mask = fence
        assert len(names) == len(mask) and sum(mask) > 0
    else:
        assert reads_all


def test_unknown_lead_degrades_to_reads_all():
    def body(p):
        cache, _ = p.mod.models_synthetic.make_synthetic_cache(60, 8, 4, 2)
        _actions, tiers = p.load(storm_conf_text())
        ssn = _pipelined_session(p, cache, tiers)
        try:
            _publish(p, ssn, ("some-new-action",))
            return _fence(ssn)
        finally:
            p.m.framework.close_session(ssn)
    assert twin(body) == (None, True)


def test_existing_fence_wins():
    """tpu-allocate's own begin-half publication is not overwritten."""
    def body(p):
        cache, _ = p.mod.models_synthetic.make_synthetic_cache(60, 8, 4, 2)
        _actions, tiers = p.load(storm_conf_text())
        ssn = _pipelined_session(p, cache, tiers)
        try:
            sentinel = (("n0",), None)
            ssn._pipeline_fence = sentinel
            _publish(p, ssn, ("reclaim", "tpu-allocate"))
            return ssn._pipeline_fence is sentinel
        finally:
            p.m.framework.close_session(ssn)
    assert twin(body) is True


# -- the lazy node-task view (api/node_info.LazyTaskDict) -------------------

def _node_info(p):
    import importlib
    root = "kube_batch_tpu_torch" if p.pkg == "torch" else "kube_batch_tpu"
    return importlib.import_module(root + ".api.node_info")


def _occupied_node(p):
    cache, _ = p.mod.models_synthetic.make_churn_cache(120, 8, 6, 2)
    for node in cache.nodes.values():
        if node.tasks:
            return node
    raise AssertionError("storm cache has no occupied node")


def _fp(d):
    return [(k, t.uid, t.status.name, t.node_name, t.resreq.milli_cpu,
             t.resreq.memory) for k, t in d.items()]


def test_snapshot_clone_order_and_value_parity():
    def body(p):
        node = _occupied_node(p)
        with environ({"KUBE_BATCH_TPU_LAZY_TASKS": "1"}):
            lazy = node.snapshot_clone()
        with environ({"KUBE_BATCH_TPU_LAZY_TASKS": "0"}):
            eager = node.snapshot_clone()
        lazy_cls = _node_info(p).LazyTaskDict
        keys_before = list(lazy.tasks)
        return (type(lazy.tasks) is lazy_cls, type(eager.tasks) is dict,
                keys_before == list(eager.tasks), _fp(lazy.tasks),
                _fp(eager.tasks), list(lazy.tasks) == list(eager.tasks))
    got = twin(body)
    assert got[:3] == (True, True, True) and got[5]
    assert got[3] == got[4]


def test_key_ops_stay_lazy_value_ops_materialize():
    def body(p):
        with environ({"KUBE_BATCH_TPU_LAZY_TASKS": "1"}):
            node = _occupied_node(p)
            tmap = node.snapshot_clone().tasks
            key = next(iter(tmap))
            fresh = bool(tmap._lazy)
            _ = key in tmap
            _ = len(tmap)
            _ = list(tmap)
            after_keys = bool(tmap._lazy)
            live = dict.__getitem__(tmap, key)
            got = tmap[key]
            return (fresh, after_keys, bool(tmap._lazy), got is not live,
                    got.uid == live.uid)
    assert twin(body) == (True, True, False, True, True)


def test_insert_time_status_capture():
    """A later status flip on the LIVE task does not leak into the
    deferred clone: the captured status is the insert-time one."""
    def body(p):
        with environ({"KUBE_BATCH_TPU_LAZY_TASKS": "1"}):
            node = _occupied_node(p)
            snap = node.snapshot_clone()
            key = next(iter(snap.tasks))
            live = dict.__getitem__(snap.tasks, key)
            captured = snap.tasks._lazy[key]
            original = live.status
            releasing = type(original).Releasing
            try:
                live.status = releasing
                clone = snap.tasks[key]
            finally:
                live.status = original
            return (clone.status is captured, clone.status is original,
                    original.name)
    got = twin(body)
    assert got[:2] == (True, True)


def test_pods_reads_without_materializing():
    def body(p):
        with environ({"KUBE_BATCH_TPU_LAZY_TASKS": "1"}):
            snap = _occupied_node(p).snapshot_clone()
            pods = snap.pods()
            return len(pods) == len(snap.tasks), bool(snap.tasks._lazy)
    assert twin(body) == (True, True)


def test_lazy_insert_matches_eager_clone():
    def body(p):
        ni = _node_info(p)
        node = _occupied_node(p)
        key = next(iter(node.tasks))
        task = node.tasks[key]
        lazy, eager = ni.LazyTaskDict(), {}
        ni.lazy_insert(lazy, key, task)
        ni.lazy_insert(eager, key, task)
        return (dict.__getitem__(lazy, key) is task,
                lazy._lazy[key] is task.status, eager[key] is not task,
                lazy[key].uid == eager[key].uid, lazy[key] is not task)
    assert twin(body) == (True,) * 5
