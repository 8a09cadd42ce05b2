"""The port's replica-federation soak (kube_batch_tpu_torch/tools/
replica_soak.py) on the CPU, at a small shape: two replicas over two
queue-shards, seeded churn under lease faults, a mid-run kill with crash
semantics.  Every invariant of the reference's soak must hold (no
accepted double bind, the orphaned shard stolen within the lease
duration and its slack, every queue's demand bound, the adoption served
by the key ledger with no new miss, bind egress stamped by replica), in
process and with the last replica over the port's HTTP edge.  The
skewed-load claim-target pin rides the in-process case, as it rides
every run of the tool.
"""

import gc

import pytest
import torch

from kube_batch_tpu_torch.chaos import plan as chaos_plan
from kube_batch_tpu_torch.tools import replica_soak as rs

SMALL = dict(replicas=2, shards=2, nodes=8, churn_rounds=6,
             lease_duration=1.5)


@pytest.fixture(autouse=True)
def _clean():
    chaos_plan.disable()
    yield
    chaos_plan.disable()
    gc.unfreeze()


@pytest.mark.parametrize("edge", [False, True])
def test_small_soak_holds_every_invariant(edge):
    art = rs.run_soak(device="cpu", edge=edge, **SMALL)
    assert art["ok"], art["problems"]
    assert art["orphaned_shards"] and art["reclaim_s"] is not None
    cc = art["compile_cache"]
    assert cc["misses_after"] == cc["misses_before_kill"]
    assert cc["hits_after"] > cc["hits_before_kill"]
    assert art["shard_binds"] and art["launches"] == 0  # the CPU
    assert art["bound_by_queue"] == art["expected_by_queue"]
    if edge:
        assert art["edge_stale_entries"] == 0
    else:
        skew = rs.run_skewed_load_check(device="cpu")
        assert skew["ok"], skew["problems"]


def test_cli_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    assert rs.main(["--no-skewed-check"]) == 1
    assert "CUDA" in capsys.readouterr().err
