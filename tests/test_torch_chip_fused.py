"""chip_smoke.py's fused phases, rehearsed on the CPU.

On the card each phase holds every launch of the session kernel against
its plain version (``chip_smoke.LaunchLedger``: inputs cloned at the
launch, held after the phase, byte-equal inputs compared byte for byte).
Here the phases run at a small size with ``device="cpu"``, where the
route is the plain version itself and the ledger wraps it: the tests
hold the phases to what they claim — every solve captured and held, the
arms equal, the ladders they print — so that a change to the phases
cannot leave a launch unchecked or an arm uncompared on the card.
"""

import gc
import json
import sys
from pathlib import Path

import pytest
import torch

from kube_batch_tpu_torch.ops import cuda_solver

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


def _lines(capsys):
    """The phase lines printed so far, as dicts by phase name."""
    by_name = {}
    for raw in capsys.readouterr().out.splitlines():
        if raw.startswith("{"):
            line = json.loads(raw)
            by_name.setdefault(line.get("phase"), []).append(line)
    return by_name


@pytest.fixture(autouse=True)
def _fresh_ledger(monkeypatch):
    monkeypatch.setenv("KUBE_BATCH_TPU_SCAN_MIN_NODES", "0")
    chip_smoke.LaunchLedger.HELD.clear()
    yield
    chip_smoke.LaunchLedger.HELD.clear()
    gc.unfreeze()


def test_fused_quiet_phase_one_dispatch_per_session(capsys):
    launches = chip_smoke.fused_quiet_phase(
        cuda_solver, "cpu", shape=(600, 60, 24, 4), sessions=2,
        device="cpu")
    lines = _lines(capsys)
    runs = lines["fused-quiet-session"]
    assert [r["fused"] for r in runs] == [True, False, False, True]
    for r in runs:
        want = ({"fused": 1}, {"solve/served": 1}) if r["fused"] else (
            {"evict": 1, "solve": 1}, {})
        assert (r["dispatches"], r["legs"]) == want
        assert r["binds"] == 600
    (line,) = lines["fused-quiet"]
    # Four solves of one backlog: one held against the plain version,
    # three byte for byte.
    assert launches == 4
    assert line["held"] == {"plain": 1, "byte_equal": 3}
    assert line["identical_arms"] is True


def test_fused_storm_phase_arms_equal(capsys):
    launches = chip_smoke.fused_storm_phase(
        cuda_solver, "cpu", shape=(1200, 120, 40, 4), device="cpu",
        cycles=3)
    lines = _lines(capsys)
    (line,) = lines["fused-storm"]
    assert line["evictions"] > 0 and line["identical_arms"] is True
    first = line["legs_by_cycle"][0]
    assert first["evict/served"] == 1
    assert first.get("postevict/invalidated", 0) \
        + first.get("solve/invalidated", 0) == 1
    assert [d.get("fused", 0) for d in
            line["dispatches_by_cycle"]["fused"]] == [1, 1, 1]
    assert line["held"]["plain"] + line["held"]["byte_equal"] == launches
    # The fused arm re-dispatches once a cycle beside its leg; the
    # control and the oracle solve once a cycle.
    assert launches == 3 * 2 + 3 + 3


def test_fused_served_phase_serves_at_both_shapes(capsys):
    launches = chip_smoke.fused_served_phase(cuda_solver, "cpu",
                                             device="cpu", n_nodes=64)
    lines = _lines(capsys)
    served = lines["fused-served"]
    assert [s["n_nodes"] for s in served] == [64, 256]
    assert all(s["committed_victims"] == 8 for s in served)
    runs = lines["fused-served-run"]
    on = [r for r in runs if r["storm"]]
    assert all(r["dispatches"] == {"fused": 1} for r in on)
    assert all(r["legs"] == {"evict/served": 1, "postevict/served": 1}
               for r in on)
    # Per shape: the served leg, and the FUSED_STORM=0 arm's invalidated
    # leg and its re-dispatch.
    assert launches == 2 * 3
    assert sum(r["held"]["plain"] + r["held"]["byte_equal"]
               for r in runs) == launches


def test_fused_topo_phase_three_family_dispatch(capsys):
    launches = chip_smoke.fused_topo_phase(
        cuda_solver, "cpu", device="cpu", dims=(4, 4, 2),
        slice_shape="2x2x2")
    (line,) = _lines(capsys)["fused-topo"]
    assert line["routes"] == [{"fused/evict+solve+topo": 1}] * 2
    assert line["legs"] == [{"solve/unused": 1, "topo/served": 1}] * 2
    assert line["topo_leg_vs_cpu_max_abs_err"] == 0
    assert line["evictions"] == 4 and line["binds"] == 8
    assert launches == 2
    assert line["held"] == {"plain": 2, "byte_equal": 0}


def test_fused_steady_phase_arms_equal(capsys):
    launches = chip_smoke.fused_steady_phase(
        cuda_solver, "cpu", shape=(1500, 150, 60, 4), rounds=3,
        device="cpu")
    lines = _lines(capsys)
    (line,) = lines["fused-steady"]
    assert line["identical_arms"] is True
    assert line["legs_by_round"][0] == {"solve/served": 1}
    assert line["gathered_rounds"]
    assert line["held"]["plain"] + line["held"]["byte_equal"] == launches
    rounds = lines["fused-steady-round"]
    assert len(rounds) == 2 * 4
    assert all(r["dispatches"].get("fused") == 1 for r in rounds
               if r["fused"])
