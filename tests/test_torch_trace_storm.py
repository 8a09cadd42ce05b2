"""The port's trace of the eviction layers (trace/spans.py): a storm
session of the shipped four-action conf emits ``reclaim.walk``,
``preempt.walk``, ``statement.commit`` / ``statement.discard`` and
``evict.device`` with their args, and ``/metrics`` counts statements and
pipelines beside the evictions, as the evictor recorded them; a session
of the default conf emits none of them."""

import gc

import pytest

from kube_batch_tpu_torch.metrics import metrics
from kube_batch_tpu_torch.models.synthetic import (make_churn_cache,
                                                   make_synthetic_cache)
from kube_batch_tpu_torch.ops import cuda_solver
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.trace import flight_recorder
from kube_batch_tpu_torch.trace import spans as trace
from tests.test_torch_utils import storm_conf_text

NEW = ("reclaim.walk", "preempt.walk", "statement.commit",
       "statement.discard", "evict.device")


class FakeTiming:
    """EvictTiming's stand-in on the CPU: no CUDA events, the same span."""

    made = 0

    def __init__(self):
        FakeTiming.made += 1

    def launched(self):
        pass

    def record(self):
        now = trace.time.perf_counter()
        trace.record_span("evict.device", now, now + 1e-3, track="device",
                          device_ms=1.0, aligned=True)


@pytest.fixture
def fake_timing(monkeypatch):
    FakeTiming.made = 0
    monkeypatch.setattr(cuda_solver.EvictTiming, "around",
                        classmethod(lambda cls, device: FakeTiming()))
    yield FakeTiming


def _counters():
    return (metrics.evictions_by_action(), metrics.statement_counts(),
            metrics.pipelined_by_action())


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _session(cache, conf=None):
    sched = Scheduler(cache, scheduler_conf=conf, device="cpu")
    try:
        before = _counters()
        sched.run_once()
        after = _counters()
    finally:
        sched.stop()
        gc.unfreeze()
    tr = flight_recorder.latest()
    spans = [sp for sp in tr.spans if sp.track != trace.CARRIED_TRACK]
    return spans, [_delta(a, b) for a, b in zip(after, before)]


def _named(spans, name):
    return [sp for sp in spans if sp.name == name]


@pytest.mark.parametrize("fused", ["1", "0"])
def test_a_storm_session_traces_its_eviction_layers(monkeypatch,
                                                     fake_timing, fused):
    monkeypatch.setenv("KUBE_BATCH_TPU_FUSED", fused)
    cache, _binder = make_churn_cache(600, 100, 30, 4)
    spans, (evictions, statements, pipelined) = _session(
        cache, storm_conf_text())
    recorded = list(cache.evictor.evicts)

    (reclaim,) = _named(spans, "reclaim.walk")
    (preempt,) = _named(spans, "preempt.walk")
    for sp in (reclaim, preempt):
        assert set(sp.args) == {"tried", "victims", "pipelines"}
        assert sp.args["tried"] >= sp.args["pipelines"] > 0
    # The walks' victims are the evictions the evictor saw, by action.
    assert evictions == {"reclaim": reclaim.args["victims"],
                         "preempt": preempt.args["victims"]}
    assert sum(evictions.values()) == len(recorded)
    # Every statement preempt closed: one span and one count each, the
    # committed ones carrying the walk's victims and pipelines.
    commits = _named(spans, "statement.commit")
    discards = _named(spans, "statement.discard")
    assert commits and discards
    for sp in commits + discards:
        assert set(sp.args) == {"evicts", "pipelines"}
        assert sp.track == "action.preempt"
    assert statements == {"preempt/commit": len(commits),
                          "preempt/discard": len(discards)}
    assert sum(sp.args["evicts"] for sp in commits) == \
        preempt.args["victims"]
    assert pipelined == {"reclaim": reclaim.args["pipelines"],
                         "preempt": sum(sp.args["pipelines"]
                                        for sp in commits)}
    # The batched eviction solve's device span, once per dispatch.
    (device,) = _named(spans, "evict.device")
    assert fake_timing.made == 1
    assert device.track == "device"
    assert device.args == {"device_ms": 1.0, "aligned": True}
    exposed = metrics.registry.expose()
    assert 'kube_batch_statements_total{action="preempt",outcome="commit"}' \
        in exposed
    assert 'kube_batch_pipelined_total{action="reclaim"}' in exposed


def test_a_default_conf_session_traces_none_of_them(fake_timing):
    cache, _binder = make_synthetic_cache(600, 100, 30, 4)
    spans, (evictions, statements, pipelined) = _session(cache)
    assert len(_named(spans, "apply")) == 1
    assert not [sp for sp in spans if sp.name in NEW]
    assert fake_timing.made == 0
    assert evictions == statements == pipelined == {}


def test_off_the_card_no_device_timing_is_made():
    assert cuda_solver.EvictTiming.around("cpu") is None
