import pytest

from portbench import roofline


def test_operations_and_bytes_by_hand():
    assert roofline.OPS_PER_PAIR == 35
    # 3 placements over 4 nodes: every placement scans every node.
    assert roofline.k1_ops(3, 4) == 3 * 4 * 35
    # 4 nodes x 6 words, 5 pods x (3 in + 3 out), 2 jobs x 3, 1 queue x 4.
    assert roofline.k1_bytes(4, 5, 2, 1) == 4 * (24 + 30 + 6 + 4)


def test_least_time_takes_the_larger_bound():
    card = "NVIDIA H100 80GB HBM3"
    # The north star: bound by operations.
    ops = 50_000 * 10_000 * 35
    assert roofline.least_seconds(card, 50_000, 10_000, 50_000, 2_000, 4) \
        == pytest.approx(ops / 67e12)
    # No placement: bound by the bytes moved.
    nbytes = roofline.k1_bytes(10_000, 50_000, 2_000, 4)
    assert roofline.least_seconds(card, 0, 10_000, 50_000, 2_000, 4) \
        == pytest.approx(nbytes / 3.35e12)
    assert roofline.least_seconds("other", 1, 1, 1, 1, 1) is None
