import pytest

from portbench import devtrace, roofline, stats
from portbench.cell import reader
from portbench.window import Session, Window


def test_tail_over_every_pod_and_window_mean():
    lat = [float(i) for i in range(1, 101)]
    assert stats.percentile(lat, 95) == pytest.approx(95.05)
    assert stats.percentile([], 95) is None
    assert stats.window_mean([1.0, 2.0, 6.0]) == 3.0
    assert stats.window_mean([]) is None


def test_union_busy_idle_and_gaps():
    iv = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0), (9.0, 12.0)]
    assert stats.union(iv) == [(1.0, 3.0), (5.0, 6.0), (9.0, 12.0)]
    assert stats.clip(iv, 0.0, 10.0)[-1] == (9.0, 10.0)
    assert stats.gaps(iv, 0.0, 10.0) == [(0.0, 1.0), (3.0, 5.0),
                                         (6.0, 9.0)]
    spans = [("ingest", 2.5, 4.5, 0), ("apply", 6.5, 8.0, 1),
             ("run_once", 6.0, 9.0, 0)]
    # The gap 3-5 is ingest, then no host span; 6-9 is run_once around
    # apply.
    assert stats.idle_pieces(iv, 0.0, 10.0, spans) == [
        ("idle", 1.0), ("ingest", 1.5), ("idle", 0.5), ("run_once", 0.5),
        ("apply", 1.5), ("run_once", 1.0)]
    assert stats.top_gaps(iv, 0.0, 10.0, spans, k=3) == [
        ["ingest", 1.5], ["apply", 1.5], ["idle", 1.0]]
    assert stats.open_at(7.0, spans) == "apply"
    assert stats.open_at(0.5, spans) == "idle"


def test_span_seconds_counts_nested_once():
    spans = [("a", 0.0, 2.0, 0), ("a", 0.5, 1.0, 1), ("a", 3.0, 4.0, 0),
             ("b", 0.0, 9.0, 0)]
    assert stats.span_seconds(spans, "a") == pytest.approx(3.0)


def test_chrome_trace_aligned_to_the_host_clock():
    doc = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "spin_kernel", "ts": 1000.0,
         "dur": 1.0},
        {"ph": "X", "cat": "kernel", "name": "solve_session<float>",
         "ts": 3000.0, "dur": 500.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 4000.0, "dur": 10.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 2000.0, "dur": 5.0},
        {"ph": "i", "cat": "kernel", "name": "x", "ts": 1.0}]}
    events = devtrace.read_chrome_trace(doc)
    assert [e[0] for e in events] == ["spin_kernel", "solve_session<float>",
                                      "Memcpy DtoH"]
    tr = devtrace.align(events, mark_host=10.0)
    assert tr.aligned
    assert [n for n, _s, _e in tr.events] == ["solve_session<float>",
                                              "Memcpy DtoH"]
    (_n, s, e), (_m, s2, _e2) = tr.events
    assert s == pytest.approx(10.002) and e == pytest.approx(10.0025)
    assert s2 == pytest.approx(10.003)
    assert devtrace.busy_seconds(tr) == pytest.approx(510e-6)
    assert not devtrace.align(events[1:], mark_host=10.0).aligned


def _window(device=None):
    spans = [("open_session", 0.0, 0.3, 0), ("tensorize", 0.4, 0.6, 1),
             ("ship", 0.6, 0.61, 1), ("solver.dispatch", 0.61, 0.62, 1),
             ("solver.fetch", 0.62, 0.78, 1), ("apply", 0.8, 2.8, 1),
             ("close_session", 2.8, 2.85, 0)]
    s1 = Session(due=0.0, ingest_s=2.0, start=2.0, end=5.0, nodes=10_000,
                 pods=50_000, jobs=2_000, queues=4, placements=50_000,
                 spans=spans)
    s2 = Session(due=6.0, ingest_s=3.0, start=9.0, end=13.0, nodes=10_000,
                 pods=50_000, jobs=2_000, queues=4, placements=50_000,
                 spans=[(n, a + 9, b + 9, d) for n, a, b, d in spans])
    return Window(start=0.0, end=20.0, sessions=[s1, s2],
                  latencies=[3.0] * 95 + [4.0] * 5, attempted=100, failed=0,
                  gc_s=1.5, device=device,
                  device_name="NVIDIA H100 80GB HBM3")


def test_readers_on_a_window():
    trace = devtrace.DeviceTrace(events=[
        ("void solve_session<float, false>(SolveArgs)", 3.0, 3.2),
        ("void solve_session<float, false>(SolveArgs)", 10.0, 10.2),
        ("Memcpy HtoD", 10.2, 10.3)], aligned=True)
    w = _window(trace)
    assert reader("e2e", "session_ms")(w) == pytest.approx(3500.0)
    assert reader("e2e", "bind_p95_ms")(w) == pytest.approx(3050.0)
    assert reader("layers", "ingest_ms")(w) == pytest.approx(2500.0)
    assert reader("layers", "gc_ms")(w) == pytest.approx(750.0)
    assert reader("layers", "open_ms")(w) == pytest.approx(300.0)
    assert reader("layers", "tensorize_ms")(w) == pytest.approx(200.0)
    assert reader("layers", "dispatch_fetch_ms")(w) == pytest.approx(180.0)
    assert reader("layers", "apply_ms")(w) == pytest.approx(2000.0)
    assert reader("layers", "close_ms")(w) == pytest.approx(50.0)
    assert reader("layers", "k1_ms")(w) == pytest.approx(200.0)
    assert reader("layers", "device_idle_share")(w) == pytest.approx(97.5)
    least = roofline.least_seconds("NVIDIA H100 80GB HBM3", 50_000,
                                   10_000, 50_000, 2_000, 4)
    assert reader("layers", "k1_roofline")(w) == pytest.approx(
        100 * 2 * least / 0.4)


def test_readers_find_nothing_without_their_source():
    w = _window(None)
    for name in ("k1_ms", "k1_roofline", "device_idle_share"):
        assert reader("layers", name)(w) is None
    w.device_name = "a card without published peaks"
    w.device = devtrace.DeviceTrace(events=[("solve_session", 1.0, 2.0)] * 2)
    assert reader("layers", "k1_roofline")(w) is None
    w.sessions = []
    assert reader("e2e", "session_ms")(w) is None
    assert reader("layers", "open_ms")(w) is None
    assert reader("layers", "gc_ms")(w) is None
