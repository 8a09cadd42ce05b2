"""chip_smoke.py's failure-path drills and its no-fallback guard,
rehearsed on the CPU.

On the card every phase before the drills runs inside
``chip_smoke.guarded``, which fails the script when the phase moved the
device-failure or deadline counters or left the breaker open; each
``degrade-*`` drill injects its own fault and checks exactly the
failures it caused, under the card's rule: a device failure raises
``DeviceFailure`` after the breaker is fed and never runs the host path.
Here the guard and the drills run at a small size with ``device="cpu"``
(the route is the plain version itself) and
``chaos.breaker.host_path_allowed`` answering as it does for a CUDA
device, so a change to them cannot leave a fallback unseen or a drill
unchecked on the card.
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


def _lines(capsys, name):
    return [json.loads(raw) for raw in capsys.readouterr().out.splitlines()
            if raw.startswith("{") and json.loads(raw).get("phase") == name]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    from kube_batch_tpu_torch.chaos import breaker, plan
    monkeypatch.setenv("KUBE_BATCH_TPU_SCAN_MIN_NODES", "0")
    monkeypatch.setattr(breaker, "host_path_allowed", lambda device: False)
    chip_smoke.LaunchLedger.HELD.clear()
    plan.disable()
    breaker.device_breaker().reset()
    yield
    chip_smoke.LaunchLedger.HELD.clear()
    chip_smoke.KEPT.clear()
    plan.disable()
    breaker.device_breaker().reset()
    gc.unfreeze()


def test_guarded_fails_a_phase_that_fell_back(capsys):
    """A phase that degrades — here one device failure fed as the
    degrade path feeds it — fails the guard; a clean phase prints its
    no-fallback line."""
    from kube_batch_tpu_torch.chaos.breaker import feed_failure
    assert chip_smoke.guarded(lambda: 7, where="clean") == 7
    (line,) = _lines(capsys, "no-fallback")
    assert (line["where"], line["device_failures"]) == ("clean", 0)

    def degrading():
        feed_failure("solve", "device solve failed; host allocate fallback",
                     RuntimeError("boom"))

    with pytest.raises(AssertionError, match="fell back"):
        chip_smoke.guarded(degrading, where="degrading")


def test_degrade_solve_drill(capsys):
    launches = chip_smoke.degrade_solve_phase(
        cuda_solver, "cpu", shape=(300, 40, 12, 2), device="cpu")
    (line,) = _lines(capsys, "degrade-solve")
    assert launches == line["launches"] == 4
    assert line["failures_by_stage"] == {"solve": 2}
    assert (line["breaker_after_two"], line["breaker_after_probe"]) == (
        "open", "closed")
    assert line["dispatch_attempts_while_open"] == 0
    assert line["next_ship_mode"] == "full"
    assert set(line["degraded_notes"]) == {"failed-1", "failed-2",
                                           "open", "poison"}
    assert line["binds_while_failing"] == 0
    assert "breaker is open" in line["raised"]["open"]


def test_degrade_shard_drill(capsys):
    chip_smoke.degrade_shard_phase(
        cuda_solver, "cpu", device="cpu",
        shape=dict(n_tasks=2_000, n_nodes=200, n_queues=4))
    seed, first = _lines(capsys, "degrade-shard")
    assert seed["injected"] >= 1 and seed["tenants_bound"] == [
        "0", "1", "2", "3"]
    assert seed["failures_by_stage"].get("solve", 0) <= seed["injected"]
    assert first["failed_shards"] == [0]
    assert first["tenants_bound"] == ["0", "1", "2", "3"]
    assert first["failures_by_stage"] == {"solve": 1}
    assert first["inflight"] == 0


def test_degrade_evict_and_topo_drills(capsys):
    shape = (600, 100, 30, 4)
    seq = chip_smoke.evict_cycle(cuda_solver, shape, False, device="cpu")
    chip_smoke.KEPT["evict"] = dict(
        footprint=(seq["evicts"], seq["binds"]),
        action_ms={False: {k: [v] for k, v in seq["action_ms"].items()}})
    chip_smoke.degrade_evict_phase(cuda_solver, "cpu", shape=shape,
                                   device="cpu")
    (line,) = _lines(capsys, "degrade-evict")
    assert line["raised"].startswith("reclaim") and line["evictions"] == 0
    assert line["failures_by_stage"] == {"evict_solve": 1}
    chip_smoke.KEPT["topo"] = chip_smoke.topo_arm(
        cuda_solver, "cpu", True, False, dims=(4, 4, 2), slice_shape="2x2x2")
    chip_smoke.degrade_topo_phase(cuda_solver, "cpu", device="cpu",
                                  dims=(4, 4, 2), slice_shape="2x2x2")
    (line,) = _lines(capsys, "degrade-topo")
    assert line["failures_by_stage"] == {"topo": 1}
    assert len(line["degraded_notes"]) == 1 and line["slice_box"]
    assert line["then_equal_to_oracle"] and line["evictions"] == 4


def test_degrade_deadline_and_fused_drills(capsys):
    """The deadline drill on a session cell's cache and the fused drill
    on fused-quiet's: each reads what the earlier phase kept."""
    from kube_batch_tpu_torch.actions.tpu_allocate import TpuAllocateAction
    from kube_batch_tpu_torch.api import pod_key
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_cache
    shape = (600, 60, 24, 4)
    with chip_smoke.incremental_arm(False):
        tiers = chip_smoke._register("cpu")
        cache, binder = make_synthetic_cache(*shape)
        pods = {pod_key(t.pod): t.pod for job in cache.jobs.values()
                for t in job.tasks.values()}
        action = TpuAllocateAction(device="cpu", dtype=torch.float32)
        run = chip_smoke.drill_session(cache, binder, pods, tiers, action)
    # A K1 time whose half is far below the plain version's solve here.
    chip_smoke.KEPT["session"] = dict(
        cache=cache, binder=binder, pods=pods, action=action, tiers=tiers,
        binds=[run["binds"]], runs=[None, ({}, 1.0, 0, 0.002)])
    chip_smoke.degrade_deadline_phase(cuda_solver, "cpu", device="cpu")
    (line,) = _lines(capsys, "degrade-deadline")
    assert line["deadline_counted"] == [1, 1, 0]
    assert line["breaker_after_each"] == [[1, "closed"], [2, "closed"],
                                          [0, "closed"]]
    chip_smoke.fused_quiet_phase(cuda_solver, "cpu", shape=shape,
                                 sessions=2, device="cpu")
    capsys.readouterr()
    chip_smoke.degrade_fused_phase(cuda_solver, "cpu", device="cpu")
    (line,) = _lines(capsys, "degrade-fused")
    assert line["dispatches"] == {"evict": 1, "solve": 1}
    assert line["breaker_calls"] == ["failure", "success"]
    assert line["binds_equal_control"]
