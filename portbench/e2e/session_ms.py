"""session_ms: the summed wall of every run_once() session in the window,
over their count (host clock)."""

from ..stats import window_mean


def read(window):
    mean = window_mean([s.wall_s for s in window.sessions])
    return None if mean is None else mean * 1e3
