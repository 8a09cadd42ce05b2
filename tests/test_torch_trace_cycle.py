"""The port's trace of a whole scheduling cycle, on the CPU: the cache
handlers' runs and the collector's passes carried between sessions
(trace/spans.py ``handoff``, ``HandlerRuns``, the gc hook a Scheduler
holds), apply's child spans, K1's device span on the host clock
(ops/cuda_solver.py ``K1Timing``, riding the solve's handle to its
fetch), and the kill switch that turns all of it off.

The handler cases drive the cache's clock through a stand-in for the
``time`` module, so that where one run ends and the next begins does not
depend on how busy the test machine is.
"""

import gc
import time
import types
from collections import deque

import pytest
import torch

from kube_batch_tpu_torch.api import (Container, ObjectMeta, Pod, PodSpec,
                                      PodStatus)
from kube_batch_tpu_torch.apis.scheduling import v1alpha1
from kube_batch_tpu_torch.cache import SchedulerCache
from kube_batch_tpu_torch.cache import cache as cache_mod
from kube_batch_tpu_torch.models.synthetic import make_synthetic_cache
from kube_batch_tpu_torch.ops import cuda_solver, solver
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.trace import export, flight_recorder, spans

TRACE_ENV = "KUBE_BATCH_TPU_TRACE"


def _drop_gc_hook():
    """Release every holder of the collector hook, and so the hook."""
    for key in list(spans._gc_holders):
        spans.release_gc_hook(key)
    assert spans._GC_HOOK not in gc.callbacks


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(TRACE_ENV, raising=False)
    while spans.current_trace() is not None:
        spans.end_session()
    _drop_gc_hook()
    spans.handoff.clear()
    yield
    while spans.current_trace() is not None:
        spans.end_session()
    _drop_gc_hook()
    spans.handoff.clear()


class _Clock:
    """``perf_counter`` that moves ``step`` seconds a read, from ten
    seconds before now; ``jump`` opens a gap."""

    def __init__(self, step=1e-5):
        self.t = time.perf_counter() - 10.0
        self.step = step
        self.reads = 0

    def perf_counter(self):
        self.reads += 1
        self.t += self.step
        return self.t

    def jump(self, seconds):
        self.t += seconds


def _use_clock(monkeypatch, clock):
    monkeypatch.setattr(cache_mod, "time", types.SimpleNamespace(
        perf_counter=clock.perf_counter, time=time.time, sleep=time.sleep))


def _group(name, ns="t"):
    return v1alpha1.PodGroup(
        metadata=ObjectMeta(name=name, namespace=ns, uid=f"{ns}-{name}"),
        spec=v1alpha1.PodGroupSpec(min_member=1, queue="default"))


def _pod(name, group, ns="t"):
    return Pod(
        metadata=ObjectMeta(
            name=name, namespace=ns, uid=f"{ns}-{name}",
            annotations={v1alpha1.GroupNameAnnotationKey: group},
            creation_timestamp=1.0),
        spec=PodSpec(containers=[Container(
            requests={"cpu": "100m", "memory": "64Mi"})]),
        status=PodStatus(phase="Pending"))


def _carried(tr):
    return [sp for sp in tr.spans if sp.track == spans.CARRIED_TRACK]


def test_handler_runs_merge_and_ride_into_the_next_session(monkeypatch):
    clock = _Clock()
    _use_clock(monkeypatch, clock)
    cache = SchedulerCache()
    groups = [_group(f"g{i}") for i in range(3)]
    pods = [_pod(f"p{i}", f"g{i % 3}") for i in range(30)]
    for pg in groups:
        cache.add_pod_group(pg)
    for pod in pods:
        cache.add_pod(pod)
    clock.jump(0.005)                 # a gap: the next calls start a run
    for pod in pods[:10]:
        cache.delete_pod(pod)
    clock.jump(0.005)
    cache.update_pod_group(groups[0], groups[0])
    assert len(spans.handoff) == 3

    sid = spans.begin_session()
    spans.end_session()
    tr = flight_recorder.get(sid)
    got = [(sp.name, sp.args["calls"], sp.args["handlers"], sp.depth)
           for sp in _carried(tr)]
    assert got == [
        ("cache.ingest", 33, ["add_pod", "add_pod_group"], 0),
        ("cache.delete", 10, ["delete_pod"], 0),
        ("cache.ingest", 1, ["update_pod_group"], 0)]
    assert all(sp.ts < 0 and sp.dur > 0 for sp in _carried(tr))
    # One run spans its first call's start to its last call's end: two
    # clock reads a call, 10 us apart.
    first = _carried(tr)[0]
    assert first.dur == pytest.approx((2 * 33 - 1) * 10.0, rel=1e-3)
    # Drained: the next session carries nothing, and the next call
    # opens a new run.
    assert len(spans.handoff) == 0
    cache.delete_pod(pods[10])
    assert len(spans.handoff) == 1


def test_a_collection_inside_the_gap_keeps_the_run_whole(monkeypatch):
    """A pass of the collector between two calls, full or young, does
    not end the run; an idle gap as long does."""
    clock = _Clock()
    _use_clock(monkeypatch, clock)
    monkeypatch.setattr(spans._GC_HOOK, "recent", deque(maxlen=64))
    cache = SchedulerCache()
    cache.add_pod_group(_group("g"))
    for generation in (2, 1):
        # A pass of 5 ms between two calls, as the hook sees it.
        spans._GC_HOOK.recent.append((clock.t, clock.t + 0.005))
        if generation == 2:
            spans.handoff.carry(spans._Carried(
                "gc.full", clock.t, clock.t + 0.005, 1, {"collected": 0}))
        clock.jump(0.005)
        cache.add_pod(_pod(f"p{generation}", "g"))
    clock.jump(0.005)                   # idle
    cache.add_pod(_pod("p0", "g"))
    names = [c.name for c in spans.handoff._spans]
    assert names == ["cache.ingest", "gc.full", "cache.ingest"]
    assert spans.handoff._spans[0].record_args()["calls"] == 3


def test_a_cache_without_sessions_carries_at_most_the_bound(monkeypatch):
    """100,000 handler calls, each its own run, and no session to drain
    them: the handoff holds CARRY_MAX spans, the overflow merged into
    the last and counted there."""
    clock = _Clock()
    _use_clock(monkeypatch, clock)
    cache = SchedulerCache()
    queue = v1alpha1.Queue(metadata=ObjectMeta(name="q"),
                           spec=v1alpha1.QueueSpec(weight=1))
    for i in range(50_000):
        cache.add_queue(queue)
        clock.jump(0.002)
        cache.delete_queue(queue)
        clock.jump(0.002)
    held = spans.handoff._spans
    assert len(held) == spans.CARRY_MAX == 256
    assert sum(1 + c.merged for c in held) == 100_000
    assert held[-1].merged == 100_000 - 256
    assert held[-1].record_args()["merged"] == 100_000 - 256


def test_the_kill_switch_reads_no_clock_installs_no_hook_creates_no_event(
        monkeypatch):
    reads = []
    real = time.perf_counter

    def counting():
        reads.append(1)
        return real()

    def feed(cache):
        cache.add_pod_group(_group("g"))
        for i in range(5):
            cache.add_pod(_pod(f"p{i}", "g"))
        cache.delete_pod(_pod("p0", "g"))
        cache.delete_pod_group(_group("g"))

    made = []

    class Event:
        def __init__(self, **kw):
            made.append(kw)

        def record(self, stream):
            pass

    stream = types.SimpleNamespace(query=lambda: True, cuda_stream=7)
    monkeypatch.setattr(torch.cuda, "Event", Event)

    for flag, expect in (("0", False), ("1", True)):
        monkeypatch.setenv(TRACE_ENV, flag)
        _drop_gc_hook()
        spans.handoff.clear()
        cache = SchedulerCache()
        monkeypatch.setattr(time, "perf_counter", counting)
        del reads[:]
        feed(cache)
        handler_reads = len(reads)
        monkeypatch.setattr(time, "perf_counter", real)
        scheduler = Scheduler(cache, device="cpu")
        hooked = spans._GC_HOOK in gc.callbacks
        del made[:]
        timing = cuda_solver.K1Timing.begin(stream)
        if timing is not None:
            timing.launched(stream)
        if not expect:
            assert handler_reads == 0
            assert not hooked and not spans._gc_holders
            assert timing is None and made == []
            assert len(spans.handoff) == 0
        else:
            # Two reads a call, and what the switch turns off is there.
            assert handler_reads == 2 * 8
            assert hooked and spans._gc_holders == {id(scheduler)}
            assert len(made) == 3 and all(kw == {"enable_timing": True}
                                          for kw in made)
            # An ingest run and a delete run (more if the machine paused
            # for a millisecond between two calls).
            assert len(spans.handoff) >= 2


class _Holder:
    """Stands for a Scheduler holding the collector hook."""


def test_the_hook_carries_a_forced_collection_as_one_full_span():
    holders = [_Holder(), _Holder()]
    for holder in holders:
        spans.hold_gc_hook(holder)      # once per process
    assert gc.callbacks.count(spans._GC_HOOK) == 1
    before = spans.gc_pause_seconds()[2]
    gc.collect()
    full = [c for c in spans.handoff._spans if c.name == "gc.full"]
    assert len(full) == 1 and full[0].end > full[0].start
    assert isinstance(full[0].args["collected"], int)
    assert spans.gc_pause_seconds()[2] > before
    sid = spans.begin_session()
    spans.end_session()
    tr = flight_recorder.get(sid)
    (sp,) = [sp for sp in _carried(tr) if sp.name == "gc.full"]
    assert sp.depth == 1 and sp.ts < 0 and "collected" in sp.args


def test_the_hook_lives_while_a_scheduler_holds_it():
    """Each Scheduler holds the hook; it goes when the last holder is
    stopped or collected, so no test or process keeps it by accident."""
    first = Scheduler(SchedulerCache(), device="cpu")
    second = Scheduler(SchedulerCache(), device="cpu")
    assert gc.callbacks.count(spans._GC_HOOK) == 1
    first.stop()
    assert spans._GC_HOOK in gc.callbacks
    del second
    gc.collect()
    assert spans._GC_HOOK not in gc.callbacks
    assert not spans._gc_holders
    # A young pass counts in the pauses, and carries no span.
    spans.hold_gc_hook(first)
    before = spans.gc_pause_seconds()
    gc.collect(0)
    assert spans.gc_pause_seconds()[0] > before[0]
    assert all(c.name != "gc.full" for c in spans.handoff._spans)


def test_apply_children_nest_under_apply_in_a_burst_session():
    cache, _binder = make_synthetic_cache(600, 120, 24, 4)
    Scheduler(cache, device="cpu").run_once()
    tr = flight_recorder.latest()
    (apply,) = [sp for sp in tr.spans if sp.name == "apply"]
    children = [sp for sp in tr.spans if sp.depth == apply.depth + 1
                and apply.ts <= sp.ts
                and sp.ts + sp.dur <= apply.ts + apply.dur + 1.0]
    names = [sp.name for sp in children]
    assert names == ["apply.aggregates", "apply.walk", "apply.settle",
                     "cache.lineage", "cache.bind", "cache.assume",
                     "cache.lineage"]
    assert all(sp.track == apply.track for sp in children)
    # One of each per batch, never one per pod.
    assert sum(sp.name.startswith(("apply.", "cache."))
               for sp in tr.spans if sp.track != spans.CARRIED_TRACK) == 7
    # The cluster's ingest rode into the session ahead of it.
    ingest = [sp for sp in _carried(tr) if sp.name == "cache.ingest"]
    assert ingest and sum(sp.args["calls"] for sp in ingest) >= 600


def test_phase_summaries_leave_the_carried_track_out():
    cache = SchedulerCache()
    cache.add_pod_group(_group("g"))
    sid = spans.begin_session()
    with spans.span("open_session"):
        pass
    spans.end_session()
    tr = flight_recorder.get(sid)
    assert set(export.summarize_phases(tr)) == {"open_session"}
    assert sum(export.summarize_phases(tr).values()) <= tr.duration_ms
    assert set(export.summarize_carried(tr)) == {"cache.ingest"}
    summary = next(s for s in flight_recorder.summaries()
                   if s["session"] == sid)
    assert set(summary["phases_ms"]) == {"open_session"}
    assert set(summary["between_sessions_ms"]) == {"cache.ingest"}


class _FakeEvent:
    def __init__(self, at_ms):
        self.at_ms = at_ms
        self.waited = 0

    def synchronize(self):
        self.waited += 1

    def elapsed_time(self, other):
        return other.at_ms - self.at_ms


def _timing(host, pair_ms, start_ms, end_ms, aligned=True):
    t = cuda_solver.K1Timing()
    t.host, t.aligned = host, aligned
    t.pair, t.start, t.end = (_FakeEvent(pair_ms), _FakeEvent(start_ms),
                              _FakeEvent(end_ms))
    return t


def _pending(timing):
    """A dispatched solve's handle, as pending_of builds it for a K1
    launch (its TimedResult's timing carried over)."""
    z = torch.zeros(4, dtype=torch.int32)
    result = cuda_solver.TimedResult(z, z, z, torch.tensor(0))
    result.timing = timing
    solver._note_dispatch(+1)
    return solver.PendingSolve(torch.zeros((4, 4), dtype=torch.int32),
                               None, None, result.timing)


def _k1_spans(sid):
    return [sp for sp in flight_recorder.get(sid).spans
            if sp.name == "k1.device"]


def test_k1_device_span_lands_on_the_host_clock():
    host = time.perf_counter()
    first = _timing(host, 0.0, 2.0, 152.0)
    late = _timing(host, 0.0, 160.0, 170.0, aligned=False)
    sid = spans.begin_session()
    solver.fetch_solve(_pending(first))
    z = torch.zeros(4, dtype=torch.int32)
    result = cuda_solver.TimedResult(z, z, z, torch.tensor(0))
    result.timing = late
    solver.fetch_result(result)            # the sequential route
    spans.end_session()
    tr = flight_recorder.get(sid)
    got = _k1_spans(sid)
    assert [(sp.args["device_ms"], sp.args["aligned"]) for sp in got] == [
        (150.0, True), (10.0, False)]
    assert first.end.waited == 1
    one = got[0]
    assert one.track == "device" and one.depth == 1   # inside solver.fetch
    assert (tr.t0 + one.ts * 1e-6) == pytest.approx(host + 0.002, abs=1e-6)
    assert one.dur == pytest.approx(150_000.0)


def test_a_discarded_solve_leaves_no_span_in_a_later_session():
    """The timing rides the handle: a discarded solve (and a warmup
    launch nobody fetches) takes it along, and the next session's fetch
    records its own launch alone."""
    host = time.perf_counter()
    solver.discard_solve(_pending(_timing(host, 0.0, 1.0, 151.0)))
    first = spans.begin_session()
    spans.end_session()
    second = spans.begin_session()
    solver.fetch_solve(_pending(_timing(host, 0.0, 200.0, 210.0)))
    spans.end_session()
    assert _k1_spans(first) == []
    assert [sp.args["device_ms"] for sp in _k1_spans(second)] == [10.0]
