"""gc_full_ms: the collector's full passes per session, from the port's
spans: the ``gc.full`` spans carried into each session, which cover the
passes since the previous one (trace/spans.py, the hook the Scheduler
installs), mean over the sessions that carry spans from before them."""

from ..stats import span_seconds, window_mean
from ._carried import carrying


def read(window):
    mean = window_mean([span_seconds(s.spans, "gc.full")
                        for s in carrying(window)])
    return None if mean is None else mean * 1e3
