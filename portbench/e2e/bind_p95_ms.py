"""bind_p95_ms: the 95th percentile, over every pod submitted in the
window, of its bind stamp minus its wave's due time (host clock); a pod
still unbound when the window closes counts with the time to the close."""

from ..stats import percentile


def read(window):
    p95 = percentile(window.latencies, 95)
    return None if p95 is None else p95 * 1e3
