"""dispatch_fetch_ms: the port's ``ship``, ``solver.dispatch`` and
``solver.fetch`` spans per session, summed, mean over the window's
sessions; the layer is ship + solver (models/shipping, ops/solver)."""

from ._spans import mean_span_ms


def read(window):
    return mean_span_ms(window, ("ship", "solver.dispatch", "solver.fetch"))
