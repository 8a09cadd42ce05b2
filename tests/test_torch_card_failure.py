"""What a device failure does on the card, rehearsed on the CPU.

On a CUDA device no card work moves to the host: every device failure
is fed to the breaker (``chaos/breaker.feed_failure``: breaker failure,
``kube_batch_device_solve_failures_total{stage}``, a ``degraded`` note,
a warning, the resident image dropped) and then raises ``DeviceFailure``
before the session has mutated anything; an open breaker refuses the
card the same way.  The host path runs in place of a failed stage only
where the action runs on the CPU (the twins in tests/test_torch_breaker.py
and tests/test_torch_degrade.py hold that path to the reference).  Here
``chaos.breaker.host_path_allowed`` is made to answer as it does for a
CUDA device, so the CPU runs the card's rule: at each of tpu-allocate's
stages in both ``PIPELINE`` arms, at the breaker gate, at the eviction
scanner's three points, at topo-allocate's box scan and in the shard
pipeline.  The fused dispatch's failure stays on the device: its
families re-dispatch one by one.
"""

import importlib

import pytest
import torch

from tests.test_torch_breaker import _breaker, _stage_fault
from tests.test_torch_concurrent_shards import _build_cluster
from tests.test_torch_e2e import CONF_TPU, Harness
from tests.test_torch_topology import run_topo_arm
from tests.test_torch_utils import (Loop, Pkg, bind_map, drive_stamped,
                                    environ, storm_conf_text)

import kube_batch_tpu_torch.chaos.breaker as brk
from kube_batch_tpu_torch.chaos import plan as chaos_plan
from kube_batch_tpu_torch.chaos.breaker import DeviceFailure
from kube_batch_tpu_torch.metrics import metrics


@pytest.fixture(autouse=True)
def _card_rule(monkeypatch):
    """The card's rule on the CPU; the port's plan off and its breaker
    closed before and after each case."""
    monkeypatch.setenv("KUBE_BATCH_TPU_SCAN_MIN_NODES", "0")
    chaos_plan.disable()
    brk.device_breaker().reset()
    monkeypatch.setattr(brk, "host_path_allowed", lambda device: False)
    yield
    chaos_plan.disable()
    brk.device_breaker().reset()


def _failures():
    return dict(metrics.device_solve_failures.values())


def _delta(before):
    return {k[0]: v - before.get(k, 0) for k, v in _failures().items()
            if v != before.get(k, 0)}


def _notes():
    from kube_batch_tpu_torch.trace import flight_recorder
    tr = flight_recorder.latest()
    return list(tr.meta.get("degraded", [])) if tr is not None else []


def test_host_path_allowed_only_on_the_cpu(monkeypatch):
    monkeypatch.undo()
    assert brk.host_path_allowed("cpu")
    assert brk.host_path_allowed(torch.device("cpu"))
    assert not brk.host_path_allowed("cuda")
    assert not brk.host_path_allowed(torch.device("cuda", 0))


def _harness(lp):
    h = Harness(lp, conf=CONF_TPU)
    h.add_nodes(3, cpu="4")
    h.create_job("a", 3, 3)
    h.create_job("b", 2, 2, queue="q2")
    h.create_job("hog", 1, 1, cpu="64")
    return h


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["pipeline0", "pipelined"])
@pytest.mark.parametrize("stage,label", [
    ("tensorize", "tensorize"), ("ship", "solve"), ("dispatch", "solve"),
    ("fetch", "solve"), ("validation", "solve")])
def test_tpu_allocate_raises_at_stage(monkeypatch, stage, label,
                                      pipelined):
    """A failing stage raises ``DeviceFailure`` out of the session with
    nothing bound, after one breaker feed, one count under its stage
    and one note; the resident image is dropped, and the next session
    ships ``full`` and binds what a fault-free session binds."""
    lp = Loop("torch")
    lp.pkg_pipelined = pipelined
    monkeypatch.setenv("KUBE_BATCH_TPU_PIPELINE", "1" if pipelined else "0")
    clean = _harness(lp)
    clean.cycle()
    want = clean.bound()
    assert want
    br = _breaker(lp, monkeypatch, 99, [0.0])
    fed = []
    real_failure = br.failure
    br.failure = lambda: (fed.append(1), real_failure())[1]
    h = _harness(lp)
    shipper = lp.shipping.resident_shipper(h.cache, device="cpu")
    before = _failures()
    _stage_fault(lp, monkeypatch, stage)
    with pytest.raises(DeviceFailure, match=f"device {label} failed") as err:
        h.cycle()
    assert err.value.__cause__ is not None
    assert h.bound() == {}
    assert len(fed) == 1 and _delta(before) == {label: 1.0}
    assert [n for n in _notes() if "failed on the card" in n] != []
    assert shipper._state is None
    chaos_plan.disable()
    monkeypatch.undo()
    monkeypatch.setenv("KUBE_BATCH_TPU_PIPELINE", "1" if pipelined else "0")
    h.cycle()
    assert h.bound() == want and shipper.last_mode == "full"


def test_open_breaker_refuses_the_card_until_the_probe(monkeypatch):
    """Threshold 1: the first failure opens the breaker; the next
    session raises without a dispatch attempt; after the cooldown, with
    the device healed, the half-open probe binds and closes it."""
    lp = Loop("torch")
    clk = [0.0]
    br = _breaker(lp, monkeypatch, 1, clk)
    plan = chaos_plan.install(chaos_plan.FaultPlan(
        seed=1, rate=1.0, sites=("solve.device_error",)))
    h = _harness(lp)
    with pytest.raises(DeviceFailure, match="device solve failed"):
        h.cycle()
    assert br.state() == "open"
    injected = plan.injected().get("solve.device_error", 0)
    with pytest.raises(DeviceFailure, match="breaker is open"):
        h.cycle()
    assert plan.injected().get("solve.device_error", 0) == injected
    assert any("refused the card" in n for n in _notes())
    assert h.bound() == {}
    chaos_plan.disable()
    clk[0] = 31.0
    h.cycle()
    assert br.state() == "closed" and len(h.bound()) == 5


@pytest.mark.parametrize("site,stage,env", [
    ("session.tensorize", "tensorize", {}),
    ("evict_solve.device_error", "evict_solve",
     {"KUBE_BATCH_TPU_FUSED": "0"}),
    ("fused.poison", "fused", {"KUBE_BATCH_TPU_FUSED": "1"}),
], ids=["scanner-tensorize", "batched-dispatch", "fused-readback"])
def test_scanner_raises_on_the_card(site, stage, env):
    """Each of the eviction scanner's three failure points raises out of
    the first eviction action, before anything is evicted or bound."""
    p = Pkg("torch")
    spans = p.mod.trace_spans
    with environ(env):
        actions, tiers = p.load(storm_conf_text())
        cache, binder = p.mod.models_synthetic.make_churn_cache(
            420, 64, 20, 3)
        before = _failures()
        chaos_plan.install(chaos_plan.FaultPlan(seed=7, rate=1.0,
                                                sites=(site,)))
        spans.begin_session()
        try:
            with pytest.raises(DeviceFailure, match=f"device {stage} "):
                drive_stamped(p, cache, actions, tiers)
            notes = list(spans.current_trace().meta.get("degraded", []))
        finally:
            spans.end_session()
            chaos_plan.disable()
    assert _delta(before) == {stage: 1.0}
    assert any("failed on the card" in n for n in notes)
    assert list(cache.evictor.evicts) == [] and dict(binder.binds) == {}


def test_topo_box_scan_raises_on_the_card(monkeypatch):
    """A failed device box scan raises out of topo-allocate's first
    cycle under stage ``topo``; nothing is evicted or bound."""
    ts = importlib.import_module("kube_batch_tpu_torch.ops.topo_solver")

    def fail(*_a, **_k):
        raise RuntimeError("device scan failed")

    monkeypatch.setattr(ts, "box_scan", fail)
    swallowed = metrics.swallowed_exceptions.value("topo_box_scan")
    before = _failures()
    with pytest.raises(DeviceFailure, match="device topo failed"):
        run_topo_arm(Pkg("torch"), True, True,
                     env={"KUBE_BATCH_TPU_FUSED": "0"})
    assert _delta(before) == {"topo": 1.0}
    assert metrics.swallowed_exceptions.value("topo_box_scan") == swallowed


def test_fused_dispatch_failure_stays_on_the_device():
    """``fused.device_error`` under the card's rule: ``_fail`` feeds the
    breaker and each family re-dispatches on the device; nothing raises
    and the binds equal the ``FUSED=0`` control."""
    p = Pkg("torch")

    def session(env, sites=()):
        with environ(env):
            actions, tiers = p.load(storm_conf_text())
            cache, binder = p.mod.models_synthetic.make_synthetic_cache(
                300, 32, 12, 2)
            if sites:
                chaos_plan.install(chaos_plan.FaultPlan(
                    seed=7, rate=1.0, sites=sites))
            try:
                state = drive_stamped(p, cache, actions, tiers)
            finally:
                chaos_plan.disable()
            return state, dict(binder.binds)

    control = session({"KUBE_BATCH_TPU_FUSED": "0"})
    before = _failures()
    faulty = session({"KUBE_BATCH_TPU_FUSED": "1"},
                     sites=("fused.device_error",))
    assert control[1] and faulty == control
    assert _delta(before) == {"fused": 1.0}


def test_shard_failure_on_the_card_backs_off_that_shard(monkeypatch):
    """The concurrent shard pipeline with shard 0's first dispatch
    failing: shard 0's retire half raises and it backs off, the other
    shards bind in the same cycle on their own, nothing stays in
    flight; once retried it binds too."""
    lp = Loop("torch")
    monkeypatch.setenv("KUBE_BATCH_TPU_TENANCY", "4")
    monkeypatch.setenv("KUBE_BATCH_TPU_SHARD_MAP", "|".join(
        f"q{t}:{t}" for t in range(4)))
    monkeypatch.setenv("KUBE_BATCH_TPU_CONCURRENT_SHARDS", "1")
    cluster = _build_cluster(lp, tenants=4, seed=3)
    cache = lp.cache.new_scheduler_cache(cluster)
    scheduler = lp.scheduler(cache, schedule_period=3600)
    before = _failures()
    chaos_plan.install(chaos_plan.FaultPlan(
        seed=1, rate=1.0, budget=1, sites=("solve.device_error",)))
    try:
        assert scheduler.cycle()
    finally:
        chaos_plan.disable()
    binds = bind_map(cluster)
    bound = [any(f"/base-{t}-" in k for k in binds) for t in range(4)]
    assert bound == [False, True, True, True]
    assert set(scheduler.tenancy._failures) == {0}
    assert _delta(before) == {"solve": 1.0}
    assert lp.solver.solver_inflight() == 0
    brk.device_breaker().reset()
    scheduler.tenancy._next_ok.clear()
    assert scheduler.cycle()
    binds = bind_map(cluster)
    assert all(any(f"/base-{t}-" in k for k in binds) for t in range(4))
    assert scheduler.tenancy._failures == {}
