"""Shared by the readers of the spans the port carries into a session
from before it (kube_batch_tpu_torch/trace/spans.py ``handoff``): the
cache handlers' runs and the collector's full passes."""

CARRIED = ("cache.ingest", "cache.delete", "gc.full")


def carrying(window):
    """The window's sessions that carry spans from before them; empty
    where the program records none."""
    return [s for s in window.sessions
            if any(sp[0] in CARRIED for sp in s.spans)]
