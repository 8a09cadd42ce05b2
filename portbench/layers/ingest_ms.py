"""ingest_ms: the informer's handler calls for one wave, mean per wave
(the benchmark's clock around the cache's add handlers)."""

from ..stats import window_mean


def read(window):
    mean = window_mean([s.ingest_s for s in window.sessions])
    return None if mean is None else mean * 1e3
