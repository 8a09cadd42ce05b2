"""gc_ms: the seconds of the collector's passes in the window, per wave
(the benchmark's clock, through ``gc.callbacks``).  The session pauses
the collector, so its passes fall in the ingest of a wave and in the
completion of the one before."""


def read(window):
    if not window.sessions:
        return None
    return 1e3 * window.gc_s / len(window.sessions)
