"""assume_ms: the port's ``cache.assume`` span per session, mean over the
window's sessions: the per-pod mirror of each bind into the cache
(``SchedulerCache._assume_bound`` in ``bind_batch``), inside apply."""

from ._spans import mean_span_ms


def read(window):
    return mean_span_ms(window, ("cache.assume",))
