"""evict_solve_ms: the batched eviction solve per session, from the
port's spans: ``evict.batch_solve`` (the scanner's one dispatch for
every preemptor profile, or the fused program's, with what it stages)
plus ``evict.recompute`` (the scanner's rows re-derived at an action's
attach), mean over the sessions that record either."""

from ._spans import mean_span_ms


def read(window):
    return mean_span_ms(window, ("evict.batch_solve", "evict.recompute"))
