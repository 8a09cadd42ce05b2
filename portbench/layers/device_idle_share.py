"""device_idle_share: the share of the window, in %, in which no operation
ran on the device: 1 - the union of device activity over the window's
wall, from the window's device trace."""

from ..devtrace import busy_seconds


def read(window):
    if window.device is None:
        return None
    return 100.0 * (1.0 - busy_seconds(window.device)
                    / (window.end - window.start))
