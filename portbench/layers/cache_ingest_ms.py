"""cache_ingest_ms: the cache's informer handlers' own time per session,
from the port's spans: the union of the ``cache.ingest`` runs carried
into the session (trace/spans.py HandlerRuns: adds and updates, timed
under the cache's mutex) less the ``gc.full`` passes inside them, mean
over the sessions that carry a run."""

from ..stats import clip, union, window_mean


def read(window):
    per = []
    for s in window.sessions:
        runs = union((a, b) for n, a, b, _d in s.spans if n == "cache.ingest")
        if not runs:
            continue
        full = union((a, b) for n, a, b, _d in s.spans if n == "gc.full")
        inside = sum(e - a for lo, hi in runs for a, e in clip(full, lo, hi))
        per.append(sum(b - a for a, b in runs) - inside)
    mean = window_mean(per)
    return None if mean is None else mean * 1e3
