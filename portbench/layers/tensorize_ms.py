"""tensorize_ms: the port's ``tensorize`` span per session, mean over the
window's sessions; the layer is tensorize (models/tensor_snapshot,
models/incremental)."""

from ._spans import mean_span_ms


def read(window):
    return mean_span_ms(window, ("tensorize",))
