"""open_ms: the port's ``open_session`` span per session, mean over the
window's sessions; the layer is session open
(framework/session.open_session: the snapshot and the plugins' opens)."""

from ._spans import mean_span_ms


def read(window):
    return mean_span_ms(window, ("open_session",))
