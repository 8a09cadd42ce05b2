"""preempt_ms: the port's ``action.preempt`` span per session, mean over
the window's sessions that ran preempt; the layer is preempt
(actions/preempt.py: the scanner's attach, the walk, its statements and
its commit flush)."""

from ._spans import mean_span_ms


def read(window):
    return mean_span_ms(window, ("action.preempt",))
