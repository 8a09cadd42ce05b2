"""apply_ms: the port's ``apply`` span per session, mean over the window's
sessions; the layer is apply (Session.batch_apply_solved, native/, the
bind egress)."""

from ._spans import mean_span_ms


def read(window):
    return mean_span_ms(window, ("apply",))
