"""Shared by the span readers: the port's flight-recorder spans of each
session (trace/spans.py), summed by name."""

from ..stats import span_seconds, window_mean


def mean_span_ms(window, names):
    """Mean over sessions of the seconds in spans named ``names``, in ms;
    None when no session recorded any of them."""
    per = [sum(span_seconds(s.spans, n) for n in names)
           for s in window.sessions
           if any(sp[0] in names for sp in s.spans)]
    mean = window_mean(per)
    return None if mean is None else mean * 1e3
