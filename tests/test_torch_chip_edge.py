"""chip_smoke.py's edge phases and its deferred holds, rehearsed on the
CPU.

On the card ``daemon-edge`` boots the daemon with ``--master`` against
the port's API server (``python -m kube_batch_tpu_torch.edge.server``)
preloaded with the north-star cluster-state file and holds the server's
store against the daemon phase's in-process cycle; ``edge-federation``
boots two replicas with ``--replica-federation`` over one server at the
drill shape.  Here both run end to end at small shapes with
``device="cpu"`` (the launcher's rehearsal device), and the deferred
holds run the plain version in worker processes and raise on a
difference.
"""

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from kube_batch_tpu_torch.ops import cuda_solver

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

SHAPE = (300, 40, 12, 2)
FEDERATION_SHAPE = (400, 40, 16, 4)


def _lines(capsys, name):
    return [json.loads(raw) for raw in capsys.readouterr().out.splitlines()
            if raw.startswith("{") and json.loads(raw).get("phase") == name]


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "DAEMON_DIR", str(tmp_path / "daemon"))
    monkeypatch.setattr(cuda_solver, "BUILD_DIR", tmp_path / "kernels")
    chip_smoke.KEPT.clear()
    chip_smoke.LaunchLedger.HELD.clear()
    yield
    chip_smoke.KEPT.clear()
    chip_smoke.LaunchLedger.HELD.clear()
    gc.unfreeze()


def test_daemon_edge_holds_the_servers_store_against_the_cycle(capsys):
    """Every pod in the API server's store on the in-process cycle's
    node, binds by queue and pod-group phases equal, the mirror equal
    to the store, every bind sent once and visible on the watch."""
    with pytest.raises(AssertionError, match="run the daemon phase first"):
        chip_smoke.daemon_edge_phase(cuda_solver, "cpu", shape=SHAPE,
                                     device="cpu")
    state = str(Path(chip_smoke.DAEMON_DIR) / "cluster-state.json")
    chip_smoke.write_cluster_state(state, SHAPE)
    chip_smoke.KEPT["daemon_cycle"] = chip_smoke.in_process_cycle(state)
    assert chip_smoke.daemon_edge_phase(cuda_solver, "cpu", shape=SHAPE,
                                        device="cpu") == 0
    (line,) = _lines(capsys, "daemon-edge")
    assert line["placements_held"] == SHAPE[0]
    assert line["pod_group_phases_equal"] == SHAPE[2]
    assert sum(line["binds_by_queue"].values()) == SHAPE[0]
    assert line["bind_egress"]["pods"] == SHAPE[0]
    assert line["mirrored"]["pods"] == SHAPE[0]
    assert line["list_bytes"]["pods"] > 0
    assert line["guards"] == dict(device_failures=0, deadline_overruns=0,
                                  tensorize_limits=0)


# The rehearsal's shard lease.  The card's run keeps FEDERATION_LEASE_S
# (3 s); a CPU host loaded by the test run's other workers can stall a
# replica's renewal thread past a 3 s lease's renew deadline, and the
# shed-and-reclaim rescopes its mirror mid-phase.
REHEARSAL_LEASE_S = 15.0


def test_edge_federation_splits_the_shards_and_scopes_the_mirrors(capsys):
    assert chip_smoke.edge_federation_phase(
        cuda_solver, "cpu", shape=FEDERATION_SHAPE, device="cpu",
        lease_s=REHEARSAL_LEASE_S) == 0
    (line,) = _lines(capsys, "edge-federation")
    assert line["lease_s"] == REHEARSAL_LEASE_S
    # Each replica claimed its two shards once and never lost one.
    for name, held in (("a", ("0", "1")), ("b", ("2", "3"))):
        assert line["lease_transitions"][name] == {
            f'shard="{s}",kind="claim"': 1.0 for s in held}
    assert line["shards_owned"] == {"a": [0, 1], "b": [2, 3]}
    assert set(line["binds_by_queue"]["a"]) == {"q0", "q1"}
    assert set(line["binds_by_queue"]["b"]) == {"q2", "q3"}
    assert sum(sum(q.values()) for q in line["binds_by_queue"].values()) \
        == FEDERATION_SHAPE[0]
    # Every bound pod plus its own two stuck pods; half the pod groups.
    for name in ("a", "b"):
        assert line["mirrored"][name]["pods"] == FEDERATION_SHAPE[0] + 2
        assert line["mirrored"][name]["podgroups"] == (
            FEDERATION_SHAPE[2] + 4) // 2


# A process that winds down like the daemon's interpreter: on its first
# SIGTERM the default handler is back (finalization restores it) while it
# exits, so a second SIGTERM in that window kills it with -15.
_SLOW_EXIT = """
import signal, sys, time
def first(sig, frame):
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    time.sleep(1.0)
    sys.exit(0)
signal.signal(signal.SIGTERM, first)
print("ready", flush=True)
time.sleep(60)
"""


def test_daemon_stop_after_terminate_signals_once(tmp_path):
    """edge-federation signals both replicas at once (``terminate``),
    then waits for each (``stop``): each gets one SIGTERM and exits 0.
    Signalling again in ``stop`` killed a replica that was still winding
    down on a loaded host (exit -15), and its log was closed before the
    error message read it."""
    d = chip_smoke.Daemon.__new__(chip_smoke.Daemon)
    d.name = "slow-exit"
    d.log_path = str(tmp_path / "slow-exit.log")
    d.log = open(d.log_path, "w")
    d.signalled = False
    d.proc = subprocess.Popen([sys.executable, "-c", _SLOW_EXIT],
                              stdout=d.log, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 30
    while "ready" not in Path(d.log_path).read_text():
        assert time.monotonic() < deadline and d.proc.poll() is None
        time.sleep(0.05)
    d.terminate()
    assert d.stop(30) >= 0
    assert d.proc.returncode == 0
    assert "ready" in d.tail()


def test_first_difference_names_the_pod_its_job_and_order_key():
    truth = dict(group_of={"ns/p1": "ns/pg1"},
                 groups={"ns/pg1": {"metadata": {"creation_timestamp": 7.0,
                                                 "uid": "u1"},
                                    "spec": {"priority_class_name": "hi"}}})
    msg = chip_smoke.first_difference({"ns/p0": "n1", "ns/p1": "n2"},
                                      {"ns/p0": "n1", "ns/p1": "n3"}, truth)
    assert "ns/p1" in msg and "ns/pg1" in msg and "('hi', 7.0, 'u1')" in msg
    assert chip_smoke.first_difference({"a": "n"}, {"a": "n"}, truth) == ""


def test_deferred_holds_check_in_workers_and_raise_on_a_difference(capsys):
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
    inp, cfg = make_synthetic_inputs(300, 40, 20, 3, seed=2,
                                     dtype=torch.float64, device="cpu")
    res, _ = cuda_solver.solve_allocate_plain(inp, cfg)
    got = tuple(t.numpy() for t in (res.assignment, res.kind, res.order))
    bad = (got[0].copy(), got[1], got[2])
    bad[0][int(np.argmax(got[1] > 0))] += 1
    defer_cells = chip_smoke.DeferredHolds.DEFER_CELLS
    chip_smoke.DeferredHolds.start(workers=1)
    try:
        chip_smoke.DeferredHolds.DEFER_CELLS = 1
        out = chip_smoke.LaunchLedger.hold_one(cuda_solver, inp, cfg, got,
                                               "a good launch")
        assert out["deferred"] and out["max_abs_err"] is None
        assert chip_smoke.DeferredHolds.drain(300) == 1
        (line,) = _lines(capsys, "deferred-holds")
        assert line["max_abs_err"] == 0
        assert line["holds"][0]["placed"] == int((got[1] > 0).sum())

        chip_smoke.DeferredHolds.start(workers=1)
        chip_smoke.solve_vs_plain(cuda_solver, inp, cfg, bad,
                                  where="a bad launch")
        with pytest.raises(AssertionError, match="a bad launch"):
            chip_smoke.DeferredHolds.drain(300)
    finally:
        chip_smoke.DeferredHolds.DEFER_CELLS = defer_cells
        if chip_smoke.DeferredHolds.pool is not None:
            chip_smoke.DeferredHolds.pool.terminate()
            chip_smoke.DeferredHolds.pool = None
