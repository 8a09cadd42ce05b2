"""reclaim_ms: the port's ``action.reclaim`` span per session, mean over
the window's sessions that ran reclaim; the layer is reclaim
(actions/reclaim.py: its walk, the scanner's build and batched solve at
its first walking task, its commit flush)."""

from ._spans import mean_span_ms


def read(window):
    return mean_span_ms(window, ("action.reclaim",))
