"""release_ms: the deletion of a session's victims, their completion,
from the port's spans: the ``cache.delete`` runs carried into each
session that follows another of its cycle (same due time), mean over
those sessions; the first session of a cycle carries the cycle's
restore instead and is left out.  None where no session follows
another, or where the program carries no spans."""

from ..stats import span_seconds, window_mean


def read(window):
    per = []
    for before, s in zip(window.sessions, window.sessions[1:]):
        if s.due == before.due and any(sp[0] == "cache.delete"
                                       for sp in s.spans):
            per.append(span_seconds(s.spans, "cache.delete"))
    mean = window_mean(per)
    return None if mean is None else mean * 1e3
