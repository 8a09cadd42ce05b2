"""k1_event_ms: K1's device time per session, from the port's own
``k1.device`` spans (ops/cuda_solver.py K1Timing: CUDA events around
each launch of ``solve_session``, read at the fetch), mean over the
sessions that record one; no profiler needed."""

from ._spans import mean_span_ms


def read(window):
    return mean_span_ms(window, ("k1.device",))
