"""k1_ms: device time per launch of the session-solve kernel
(csrc/solve_session.cu, kernel ``solve_session``), from the window's
device trace."""

KERNEL = "solve_session"


def launches(window):
    """(start, end) of every K1 launch in the window's device trace."""
    if window.device is None:
        return []
    return [(s, e) for name, s, e in window.device.events if KERNEL in name]


def read(window):
    runs = launches(window)
    if not runs:
        return None
    return sum(e - s for s, e in runs) / len(runs) * 1e3
