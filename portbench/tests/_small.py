"""Small sizes of the cells for the CPU tests."""

from portbench import cell

WORKLOAD = "kubemark50k.backlog"


def small(nodes=120, pods=600, warmup=1, checked=2):
    """The cell's files at ``nodes`` and ``pods`` a wave; the check judges
    the window's first ``checked`` waves, so a short window runs those."""
    _bench, _entry, config, traffic = cell.load(WORKLOAD)
    config["nodes"] = nodes
    traffic["wave_pods"] = pods
    traffic["warmup_waves"] = warmup
    traffic["prebuilt_waves"] = checked
    traffic["checked_waves"] = checked
    traffic["checked_among"] = checked
    return config, traffic
