"""The readers of the spans the port records inside a cycle (the
handler runs and full collections carried into a session, the bind
egress's assume, K1's device span), on a synthetic window, and their
silence where the program records none of them."""

import pytest

from portbench.cell import reader
from portbench.window import Session, Window


def _session(offset, spans):
    return Session(due=offset, ingest_s=2.0, start=offset + 2.0,
                   end=offset + 5.0, nodes=10_000, pods=50_000, jobs=2_000,
                   queues=4, placements=50_000,
                   spans=[(n, a + offset, b + offset, d)
                          for n, a, b, d in spans])


def _window(*sessions):
    return Window(start=0.0, end=30.0, sessions=list(sessions),
                  latencies=[1.0], attempted=1, failed=0)


# Before each session: the previous wave's delete, then the ingest in two
# runs with a full collection inside the first; then the session's own.
CYCLE = [("cache.delete", -1.5, -1.0, 0),
         ("cache.ingest", -0.9, -0.3, 0), ("gc.full", -0.8, -0.6, 1),
         ("cache.ingest", -0.25, -0.05, 0),
         ("open_session", 0.0, 0.3, 0), ("apply", 0.8, 2.8, 1),
         ("cache.assume", 1.0, 2.5, 2), ("k1.device", 0.6, 0.757, 3)]


def test_cache_ingest_ms_is_the_runs_less_their_full_passes():
    w = _window(_session(0.0, CYCLE),
                _session(10.0, CYCLE + [("cache.ingest", -0.2, -0.1, 0)]))
    # (0.6 - 0.2 + 0.2) s; the overlapping run counts once.
    assert reader("layers", "cache_ingest_ms")(w) == pytest.approx(600.0)


def test_gc_full_ms_is_the_carried_passes_per_session():
    quiet = [sp for sp in CYCLE if sp[0] != "gc.full"]
    w = _window(_session(0.0, CYCLE), _session(10.0, quiet))
    assert reader("layers", "gc_full_ms")(w) == pytest.approx(100.0)


def test_assume_ms_is_the_assume_span_per_session():
    w = _window(_session(0.0, CYCLE), _session(10.0, CYCLE))
    assert reader("layers", "assume_ms")(w) == pytest.approx(1500.0)


def test_k1_event_ms_is_the_device_span_per_session():
    w = _window(_session(0.0, CYCLE),
                _session(10.0, [sp for sp in CYCLE if sp[0] != "k1.device"]))
    assert reader("layers", "k1_event_ms")(w) == pytest.approx(157.0)


def test_the_readers_find_nothing_where_the_program_records_nothing():
    plain = [("open_session", 0.0, 0.3, 0), ("apply", 0.8, 2.8, 1)]
    w = _window(_session(0.0, plain), _session(10.0, plain))
    for name in ("cache_ingest_ms", "gc_full_ms", "assume_ms",
                 "k1_event_ms"):
        assert reader("layers", name)(w) is None
    assert reader("layers", "gc_full_ms")(_window()) is None
