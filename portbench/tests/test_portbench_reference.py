"""The plain reference against the port's own session on the CPU, and the
control that has to fail the comparison."""

import numpy as np
import pytest

from portbench import check, control, generator, informer
from portbench.reference import allocate
from portbench.tests._small import WORKLOAD, small


def _port_session(config, traffic, seed, index):
    from kube_batch_tpu_torch.scheduler import Scheduler
    cluster = generator.make_cluster(config, seed)
    cache = informer.new_cache()
    informer.feed_cluster(cache, cluster)
    sched = Scheduler(cache, scheduler_conf=config["scheduler_conf"],
                      device="cpu")
    wave = generator.make_wave(traffic, len(cluster.queue_names), seed,
                               index)
    informer.ingest(cache, *informer.wave_objects(wave, cluster, traffic))
    sched.run_once()
    binds, _stamps = cache.binder.take()
    return cluster, wave, check.Observed(
        binds=binds, node_state=informer.node_state(cache, cluster),
        statuses=cache.status_updater.take())


@pytest.mark.parametrize("seed,nodes,pods", [(3, 64, 400), (2 ** 34 + 1, 96,
                                                            800)])
def test_reference_equals_the_port_on_the_cpu(seed, nodes, pods):
    config, traffic = small(nodes=nodes, pods=pods)
    cluster, wave, observed = _port_session(config, traffic, seed, 0)
    decision = allocate.solve(cluster, wave)
    numbers = check.compare(cluster, wave, decision, observed)
    assert numbers == {"bind_mismatches": 0, "node_mismatches": 0,
                       "group_mismatches": 0, "gang_violations": 0}
    assert len(observed.binds) == pods


def test_reference_on_a_tight_cluster():
    """Nodes that hold few pods: the cap and the fit decide, not spread."""
    config, traffic = small(nodes=30, pods=400)
    config["node_allocatable"] = {"cpu": "16", "memory": "64Gi", "pods": 14}
    cluster, wave, observed = _port_session(config, traffic, 11, 0)
    decision = allocate.solve(cluster, wave)
    assert check.compare(cluster, wave, decision, observed)[
        "bind_mismatches"] == 0


def test_reference_refuses_what_it_does_not_model():
    config, traffic = small(nodes=2, pods=100)
    cluster = generator.make_cluster(config, 1)
    wave = generator.make_wave(traffic, 4, 1, 0)
    with pytest.raises(allocate.OutOfScope):
        allocate.solve(cluster, wave)


def test_water_fill_meets_requests_below_the_split():
    total = np.asarray([100.0, 100.0])
    deserved = allocate.water_fill(total, np.asarray([1.0, 3.0]),
                                   np.asarray([[10.0, 10.0], [90.0, 20.0]]))
    assert deserved[0].tolist() == [10.0, 10.0]
    # Queue 1 is never below its split on every dimension, so it is never
    # met: it takes all that remains, memory past its request included.
    assert deserved[1].tolist() == pytest.approx([90.0, 90.0])


def test_bfloat16_shares_round():
    x = np.asarray([1.0, 1.00390625, 1.005, 3.14159], np.float32)
    assert allocate.round_bf16(x).tolist() == [1.0, 1.0, 1.0078125, 3.140625]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_comes_out_not_correct(seed):
    config, traffic = small(nodes=200, pods=1000)
    out = control.control(WORKLOAD, seed, config, traffic)
    assert out["correct"] is False
    assert out["checks"]["bind_mismatches"]["value"] > 0
