"""close_ms: the port's ``close_session`` span per session, mean over the
window's sessions; the layer is session close
(framework/session.close_session: the gang status write-back)."""

from ._spans import mean_span_ms


def read(window):
    return mean_span_ms(window, ("close_session",))
