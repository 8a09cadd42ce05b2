import numpy as np
import pytest

from portbench import generator
from portbench.tests._small import small


def test_quantities():
    assert generator.milli_cpu("250m") == 250
    assert generator.milli_cpu("2") == 2000
    assert generator.milli_cpu(16) == 16000
    assert generator.memory_bytes("512Mi") == 512 << 20
    assert generator.memory_bytes("64Gi") == 64 << 30
    for bad in ("1Gi", "x"):
        with pytest.raises(ValueError):
            generator.milli_cpu(bad)
    with pytest.raises(ValueError):
        generator.memory_bytes("512")


def _arrays(wave):
    return (wave.pod_req, wave.pod_group, wave.pod_ts, wave.group_queue,
            wave.group_min, wave.group_ts)


def test_same_seed_same_cluster_and_waves():
    config, traffic = small()
    for seed in (0, 2 ** 33 + 7):
        a, b = (generator.make_cluster(config, seed) for _ in range(2))
        assert a.node_names == b.node_names
        assert np.array_equal(a.queue_weights, b.queue_weights)
        for index in (0, 3):
            wa, wb = (generator.make_wave(traffic, 4, seed, index)
                      for _ in range(2))
            assert wa.pod_names == wb.pod_names
            for x, y in zip(_arrays(wa), _arrays(wb)):
                assert np.array_equal(x, y)


def test_other_seed_other_order_same_work():
    config, traffic = small(pods=1600)
    ca, cb = generator.make_cluster(config, 1), generator.make_cluster(
        config, 2)
    assert sorted(ca.queue_weights) == sorted(cb.queue_weights)
    wa = generator.make_wave(traffic, 4, 1, 0)
    wb = generator.make_wave(traffic, 4, 2, 0)
    assert not np.array_equal(wa.pod_req, wb.pod_req)
    # The same multiset of requests, groups and minimums: the same work.
    key = lambda w: sorted(map(tuple, w.pod_req.tolist()))  # noqa: E731
    assert key(wa) == key(wb)
    assert np.array_equal(wa.group_min, wb.group_min)
    assert np.array_equal(wa.group_queue, wb.group_queue)
    # Waves of one run differ from each other.
    assert not np.array_equal(wa.pod_req,
                              generator.make_wave(traffic, 4, 1, 1).pod_req)


def test_wave_shape():
    _config, traffic = small(pods=1000)
    wave = generator.make_wave(traffic, 4, 5, 0)
    assert wave.pods == 1000
    assert len(wave.group_names) == 40
    assert np.all(np.bincount(wave.pod_group) == 25)
    assert np.all(wave.group_min == 20)
    assert np.array_equal(np.bincount(wave.group_queue), [10, 10, 10, 10])
    pairs = np.unique(wave.pod_req, axis=0, return_counts=True)[1]
    assert len(pairs) == 16 and pairs.max() - pairs.min() <= 1
