"""The session flight recorder and the device half's spans, the JAX
package against the port, on the CPU.

Twins of ``tests/test_trace.py``: span mechanics, the kill switch (no
spans and no recorder lock on the hot path), the recorder ring, the
Chrome export of a live cycle, the device-wait span against its
histogram, the ship span's mode and bytes, why-pending, summaries,
percentiles, the solver tally and log correlation; and the
``solver.dispatch`` / ``solver.fetch`` spans of the device half.  Each
case runs once per package (loop_twin) and both must return the same.
``test_debug_endpoints_http`` is twinned in
tests/test_torch_debug_http.py.
"""

import importlib
import json
import logging
import threading

import pytest

from tests.test_torch_utils import loop_twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

ROOTS = ("kube_batch_tpu", "kube_batch_tpu_torch")


def _mod(lp, name):
    root = "kube_batch_tpu_torch" if lp.pkg == "torch" else "kube_batch_tpu"
    return importlib.import_module(f"{root}.{name}")


def _parts(lp):
    trace = _mod(lp, "trace")
    return trace.spans, trace.flight_recorder, trace.export


def _drain(spans, rec):
    while spans.current_trace() is not None:
        spans.end_session()
    rec.clear()


@pytest.fixture(autouse=True)
def _trace_env(monkeypatch):
    """Tracing on, empty rings, no leaked session state in either
    package."""
    monkeypatch.delenv("KUBE_BATCH_TPU_TRACE", raising=False)
    mods = [(importlib.import_module(f"{r}.trace").spans,
             importlib.import_module(f"{r}.trace").flight_recorder)
            for r in ROOTS]
    for spans, rec in mods:
        _drain(spans, rec)
    yield
    for spans, rec in mods:
        _drain(spans, rec)


def _small_cluster(lp, n_tasks=200, n_nodes=32, n_jobs=10, n_queues=2):
    return lp.synthetic.make_synthetic_cache(n_tasks, n_nodes, n_jobs,
                                             n_queues)


# ----------------------------------------------------------------------
# span mechanics


def _own(tr):
    """The session's own spans: the port carries the work done before
    the session (cache handler runs, full collections, trace/spans.py
    ``handoff``) into it on a track of its own, which the reference does
    not have."""
    return [sp for sp in tr.spans if sp.track != "between sessions"]


def test_span_nesting_depth_track_and_containment():
    def body(lp):
        spans, rec, _ = _parts(lp)
        sid = spans.begin_session(kind="test")
        with spans.span("phase_a"):
            with spans.span("inner", detail=1):
                pass
        with spans.span("phase_b"):
            spans.instant("marker", note="x")
        spans.end_session()
        tr = rec.get(sid)
        by_name = {sp.name: sp for sp in _own(tr)}
        a, i = by_name["phase_a"], by_name["inner"]
        assert i.ts >= a.ts and i.ts + i.dur <= a.ts + a.dur + 1.0
        assert tr.duration_ms >= 0.0
        return (sorted(by_name), a.depth, a.track, i.depth, i.track,
                i.args, by_name["marker"].dur)

    assert loop_twin(body) == (["inner", "marker", "phase_a", "phase_b"],
                               0, "phase_a", 1, "phase_a", {"detail": 1},
                               0.0)


def test_annotate_and_counters_land_on_open_span():
    def body(lp):
        spans, rec, _ = _parts(lp)
        sid = spans.begin_session()
        with spans.span("s") as sp:
            spans.annotate(mode="full")
            spans.counter("bytes", 123)
            assert sp.args["mode"] == "full"
        spans.end_session()
        tr = rec.get(sid)
        (span,) = [s for s in tr.spans if s.name == "s"]
        return span.args, [(n, v) for n, _ts, v in tr.counters]

    assert loop_twin(body) == ({"mode": "full"}, [("bytes", 123)])


def test_note_verdict_and_tally_recorded_and_capped():
    def body(lp):
        spans, rec, _ = _parts(lp)
        sid = spans.begin_session()
        spans.note_verdict("j1", "NotEnoughTasks", "0/5 ready")
        spans.note_tally("j1", unplaced=3, reason="NoFeasibleNode")
        spans.end_session()
        why = rec.why("j1")
        assert why["session"] == sid
        return why["reason"], why["solver"]["unplaced"], rec.why("nope")

    assert loop_twin(body) == ("NotEnoughTasks", 3, None)


def test_repeated_verdicts_dedupe_across_ring():
    def body(lp):
        spans, rec, _ = _parts(lp)
        for _ in range(3):
            spans.begin_session()
            spans.note_verdict("ns/stuck", "NotEnoughTasks", "1/50 ready")
            spans.note_tally("ns/stuck", unplaced=49,
                             reason="NoFeasibleNode")
            spans.end_session()
        traces = rec.traces()
        shared = [traces[0].verdicts["ns/stuck"]
                  is traces[1].verdicts["ns/stuck"],
                  traces[1].verdicts["ns/stuck"]
                  is traces[2].verdicts["ns/stuck"],
                  traces[0].tallies["ns/stuck"]
                  is traces[2].tallies["ns/stuck"]]
        spans.begin_session()
        spans.note_verdict("ns/stuck", "NotEnoughTasks", "2/50 ready")
        spans.end_session()
        newest = rec.latest()
        return (len(traces), shared,
                newest.verdicts["ns/stuck"]
                is traces[2].verdicts["ns/stuck"],
                rec.why("ns/stuck")["message"])

    assert loop_twin(body) == (3, [True] * 3, False, "2/50 ready")


def test_nested_begin_session_keeps_outer_alive():
    def body(lp):
        spans, rec, _ = _parts(lp)
        sid = spans.begin_session()
        seen = [spans.begin_session() is None]
        spans.end_session()
        seen.append(spans.current_session_id() == sid)
        spans.end_session()
        seen += [spans.current_session_id() is None,
                 rec.get(sid) is not None]
        return seen

    assert loop_twin(body) == [True] * 4


# ----------------------------------------------------------------------
# kill switch


class _CountingLock:
    def __init__(self, inner):
        self.inner = inner
        self.acquisitions = 0

    def __enter__(self):
        self.acquisitions += 1
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


def test_kill_switch_zero_spans_zero_recorder_locks(monkeypatch):
    def body(lp):
        spans, rec, _ = _parts(lp)
        monkeypatch.setenv("KUBE_BATCH_TPU_TRACE", "0")
        counting = _CountingLock(threading.Lock())
        monkeypatch.setattr(rec, "_lock", counting)
        assert spans.begin_session() is None
        assert spans.span("x") is spans._NOOP
        with spans.span("x"):
            spans.annotate(a=1)
            spans.counter("c", 1)
            spans.note_verdict("j", "r", "m")
            spans.note_tally("j", unplaced=1)
            spans.note_ship("full", 10)
        spans.end_session()
        cache, _ = _small_cluster(lp)
        lp.scheduler(cache).run_once()
        acquisitions = counting.acquisitions
        traces = rec.traces()
        monkeypatch.undo()
        return acquisitions, traces

    assert loop_twin(body) == (0, [])


# ----------------------------------------------------------------------
# recorder ring


def test_ring_eviction_keeps_last_n():
    def body(lp):
        rec_mod = _mod(lp, "trace.recorder")
        rec = rec_mod.FlightRecorder(capacity=4)
        for i in range(10):
            rec.record(_mod(lp, "trace.spans").SessionTrace(i + 1, {}))
        return ([t.sid for t in rec.traces()], rec.get(1),
                rec.get(10).sid)

    assert loop_twin(body) == ([7, 8, 9, 10], None, 10)


def test_recorder_under_concurrent_sessions(monkeypatch):
    def body(lp):
        spans, _, _ = _parts(lp)
        recorder_mod = _mod(lp, "trace.recorder")
        rec = recorder_mod.FlightRecorder(capacity=16)
        monkeypatch.setattr(recorder_mod, "recorder", rec)
        n_threads, per_thread = 4, 20
        seen = []
        seen_lock = threading.Lock()

        def worker():
            for _ in range(per_thread):
                sid = spans.begin_session()
                with spans.span("work"):
                    pass
                spans.end_session()
                with seen_lock:
                    seen.append(sid)

        threads = [threading.Thread(target=worker)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        ring = rec.traces()
        monkeypatch.undo()
        assert all(rec.get(t.sid) is t for t in ring)
        return (len(seen), len(set(seen)), len(ring),
                len({t.sid for t in ring}), {len(_own(t)) for t in ring})

    assert loop_twin(body) == (80, 80, 16, 16, {1})


# ----------------------------------------------------------------------
# live sessions: export schema, device-wait agreement, ship annotation,
# the device half's spans

_CYCLES = {}


def traced_cycle(lp):
    """One traced scheduler cycle of ``lp``'s package on a small
    synthetic cluster with a deliberately unschedulable gang job (built
    once per package and shared by the read-only cases)."""
    if lp.pkg in _CYCLES:
        return _CYCLES[lp.pkg]
    spans, rec, _ = _parts(lp)
    _drain(spans, rec)
    o, v1 = lp.objects, lp.v1alpha1
    cache, _ = _small_cluster(lp)
    cache.add_pod_group(v1.PodGroup(
        metadata=o.ObjectMeta(name="stuck-gang", namespace="t"),
        spec=v1.PodGroupSpec(min_member=10_000, queue="q0")))
    sched = lp.scheduler(cache)
    h0, w0, _ = lp.metrics.overlap_split_totals()
    sched.run_once()
    h1, w1, _ = lp.metrics.overlap_split_totals()
    trace = rec.latest()
    assert trace is not None
    _CYCLES[lp.pkg] = {"trace": trace, "device_wait_metric_ms": w1 - w0,
                       "host_overlap_metric_ms": h1 - h0}
    return _CYCLES[lp.pkg]


# The port's spans inside apply and the bind egress, and K1's device time
# on the card, which the reference does not record.
PORT_SPANS = {"apply.aggregates", "apply.walk", "apply.settle", "cache.bind",
              "cache.assume", "cache.lineage", "k1.device"}


def test_chrome_export_schema():
    def body(lp):
        _, _, export = _parts(lp)
        doc = json.loads(json.dumps(
            export.to_chrome_trace(traced_cycle(lp)["trace"])))
        events = doc["traceEvents"]
        named = set()
        # The port carries the spans taken before the session (the cache
        # handlers' runs, full collections) on a track of their own, at
        # negative timestamps; the reference has no such track.
        carried = {ev["tid"] for ev in events if ev["ph"] == "M"
                   and ev["name"] == "thread_name"
                   and ev["args"]["name"] == "between sessions"}
        for ev in events:
            assert set(ev) >= {"name", "ph", "pid", "tid"}
            assert ev["ph"] in ("M", "X", "C")
            if ev["ph"] == "M" and ev["name"] == "thread_name":
                named.add(ev["tid"])
            elif ev["ph"] == "X":
                assert ev["ts"] >= 0 or ev["tid"] in carried
                assert ev["dur"] >= 0
        used = {ev["tid"] for ev in events if ev["ph"] in ("X", "C")}
        assert used - {0} <= named
        # The session's own event is named by its process-wide id.
        return sorted({ev["name"] for ev in events if ev["ph"] == "X"
                       and ev["tid"] not in carried
                       and ev["name"] not in PORT_SPANS
                       and not ev["name"].startswith("session ")})

    names = loop_twin(body)
    assert {"open_session", "action.tpu-allocate", "close_session",
            "tensorize", "ship", "dispatch", "host_overlap", "device_wait",
            "apply"} <= set(names)


def test_device_wait_span_agrees_with_histogram():
    def body(lp):
        got = traced_cycle(lp)
        span_ms = _parts(lp)[2].span_totals(got["trace"]).get(
            "device_wait", 0.0)
        metric_ms = got["device_wait_metric_ms"]
        return (span_ms > 0 and metric_ms > 0,
                abs(span_ms - metric_ms) <= max(0.05 * metric_ms, 0.5))

    assert loop_twin(body) == (True, True)


def test_ship_span_carries_mode_and_bytes():
    def body(lp):
        tr = traced_cycle(lp)["trace"]
        (ship,) = [sp for sp in tr.spans if sp.name == "ship"]
        return (ship.args.get("ship_mode"),
                isinstance(ship.args.get("ship_bytes"), int),
                any(name == "ship_bytes" for name, _ts, _v in tr.counters))

    assert loop_twin(body) == ("full", True, True)


def test_solver_dispatch_and_fetch_spans():
    """The device half's own spans: ``solver.dispatch`` nests in the
    action's ``dispatch`` span and carries the route, ``solver.fetch``
    nests in ``device_wait``; one each per session, as in the
    reference.  The route names are each package's own."""
    def body(lp):
        tr = traced_cycle(lp)["trace"]
        by = {}
        for sp in tr.spans:
            by.setdefault(sp.name, []).append(sp)
        (disp,), (fetch,) = by["solver.dispatch"], by["solver.fetch"]
        (outer_d,), (outer_f,) = by["dispatch"], by["device_wait"]
        inside = [outer_d.ts <= disp.ts
                  and disp.ts + disp.dur <= outer_d.ts + outer_d.dur + 1.0,
                  outer_f.ts <= fetch.ts
                  and fetch.ts + fetch.dur <= outer_f.ts + outer_f.dur + 1.0]
        return (inside, disp.depth - outer_d.depth,
                fetch.depth - outer_f.depth, disp.args.get("route"),
                disp.args.get("mesh_devices"))

    routes = {}

    def both(lp):
        out = body(lp)
        routes[lp.pkg] = out[3]
        return out[:3] + out[4:]

    assert loop_twin(both) == ([True, True], 1, 1, 1)
    assert routes == {"jax": "xla", "torch": "torch"}


def test_why_pending_for_unschedulable_gang():
    def body(lp):
        _, rec, _ = _parts(lp)
        tr = traced_cycle(lp)["trace"]
        rec.record(tr)
        why = rec.why("stuck-gang")
        return (why["session"] == tr.sid, bool(why["reason"]),
                "10000" in why["message"] or "min" in why["message"],
                why["job"], rec.why("t/stuck-gang") is not None,
                rec.why("other-ns/stuck-gang"))

    assert loop_twin(body) == (True, True, True, "t/stuck-gang", True,
                               None)


def test_summaries_shape():
    def body(lp):
        _, rec, _ = _parts(lp)
        tr = traced_cycle(lp)["trace"]
        rec.record(tr)
        s = rec.summaries()[0]
        return (s["session"] == tr.sid, s["uid"] == tr.uid,
                s["duration_ms"] > 0,
                "action.tpu-allocate" in s["phases_ms"],
                s["verdicts"] >= 1, s["meta"]["jobs"] >= 1)

    assert loop_twin(body) == (True,) * 6


def test_phase_percentiles():
    def body(lp):
        spans, rec, export = _parts(lp)
        sids = []
        for _ in range(5):
            sid = spans.begin_session()
            with spans.span("phase"):
                pass
            spans.end_session()
            sids.append(sid)
        pct = export.phase_percentiles([rec.get(s) for s in sids],
                                       names=("phase",))
        return pct["phase"]["n"], pct["phase"]["p50"] <= pct["phase"]["p95"]

    assert loop_twin(body) == (5, True)


def test_solver_tally_for_unplaceable_task():
    def body(lp):
        _, rec, _ = _parts(lp)
        o, v1 = lp.objects, lp.v1alpha1
        cache, _ = _small_cluster(lp)
        cache.add_pod_group(v1.PodGroup(
            metadata=o.ObjectMeta(name="hog", namespace="t"),
            spec=v1.PodGroupSpec(min_member=1, queue="q0")))
        cache.add_pod(o.Pod(
            metadata=o.ObjectMeta(
                name="hog-0", namespace="t", uid="hog-0",
                annotations={v1.GroupNameAnnotationKey: "hog"},
                creation_timestamp=1.0),
            spec=o.PodSpec(containers=[o.Container(
                requests={"cpu": "999", "memory": "1Gi"})]),
            status=o.PodStatus(phase="Pending")))
        lp.scheduler(cache).run_once()
        why = rec.why("hog")
        solver = why.get("solver") or why
        return (solver["unplaced"] >= 1,
                solver["static_feasible_nodes"] > 0, solver["reason"])

    assert loop_twin(body) == (True, True, "NoFeasibleNode")


# ----------------------------------------------------------------------
# log correlation


def test_log_records_carry_session_id(caplog):
    def body(lp):
        spans, _, _ = _parts(lp)
        spans.install_log_correlation()
        name = f"{'kube_batch_tpu_torch' if lp.pkg == 'torch' else 'kube_batch_tpu'}.test_trace"
        logger = logging.getLogger(name)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=name):
            logger.info("outside any session")
            sid = spans.begin_session()
            logger.info("inside the session")
            spans.end_session()
            logger.info("after the session")
        msgs = [r.getMessage() for r in caplog.records
                if r.name == name]
        return (msgs[0], msgs[1] == f"[s={sid}] inside the session",
                msgs[2], caplog.records[1].session_id == sid)

    assert loop_twin(body) == ("outside any session", True,
                               "after the session", True)

