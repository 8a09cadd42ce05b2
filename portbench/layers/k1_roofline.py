"""k1_roofline: K1's share of its roofline, in %: the least time the card
could take for the window's solves (roofline.py, from the sessions' real
sizes and placements) over the device time K1 took for them.  Nothing
when the trace has no K1 launch, a launch count that differs from the
sessions', or a card without published peaks."""

from .. import roofline
from . import k1_ms


def read(window):
    runs = k1_ms.launches(window)
    if not runs or len(runs) != len(window.sessions):
        return None
    least = 0.0
    for s in window.sessions:
        one = roofline.least_seconds(window.device_name, s.placements,
                                     s.nodes, s.pods, s.jobs, s.queues)
        if one is None:
            return None
        least += one
    return 100.0 * least / sum(e - s for s, e in runs)
