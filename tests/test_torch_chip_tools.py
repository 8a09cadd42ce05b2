"""chip_smoke.py's harness phases, rehearsed on the CPU.

On the card ``scenarios`` runs scenario_gen's sweep with the replay round
trip and holds the batched arm against the CPU's, ``chaos-soak`` runs the
chaos soak at the reference's smoke shape, over the edge and at 2,000
nodes, and ``replica-soak`` the replica soak; every session-kernel launch
is held against the plain version.  Here ``scenarios`` runs whole with
``device="cpu"``, and ``chaos-soak`` runs under the card's rule
(``host_path_allowed`` answering as for a CUDA device) with its 2,000-node
pair cut to the 8-node smoke: the seeds are swept in order until every
required site fired, every arm converges or diverges only by the path its
faults took, the breaker trips and is waited out, and no failed device
stage runs the host path.
"""

import gc
import json
import sys
from pathlib import Path

import pytest
import torch

import kube_batch_tpu_torch.chaos.breaker as brk
from kube_batch_tpu_torch.chaos import plan as chaos_plan
from kube_batch_tpu_torch.ops import cuda_solver
from kube_batch_tpu_torch.tools import scenario_gen as sg

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


def _lines(capsys, name):
    return [json.loads(raw) for raw in capsys.readouterr().out.splitlines()
            if raw.startswith("{") and json.loads(raw).get("phase") == name]


@pytest.fixture(autouse=True)
def _fresh():
    chaos_plan.disable()
    brk.device_breaker().reset()
    chip_smoke.LaunchLedger.HELD.clear()
    yield
    chaos_plan.disable()
    brk.device_breaker().reset()
    chip_smoke.LaunchLedger.HELD.clear()
    gc.unfreeze()


def test_scenarios_phase(capsys):
    held = chip_smoke.guarded(chip_smoke.scenarios_phase, cuda_solver,
                              "cpu", device="cpu")
    out = capsys.readouterr().out.splitlines()
    lines = [json.loads(raw) for raw in out if raw.startswith("{")]
    rows = [d for d in lines if d["phase"] == "scenario"]
    assert tuple(r["kind"] for r in rows) == sg.KINDS
    assert all(not r["errors"] and r["breaker_trips"] == 0 for r in rows)
    replay = next(d for d in lines if d["phase"] == "scenario-replay")
    assert replay["errors"] == [] and replay["recorded_binds"] > 0
    vs_cpu = next(d for d in lines if d["phase"] == "scenarios-vs-cpu")
    assert vs_cpu["identical"] and len(vs_cpu["runs"]) == 2
    summary = next(d for d in lines if d["phase"] == "scenarios")
    assert summary["max_abs_err"] == 0
    assert held == sum(summary["held"].values()) > 0


def test_chaos_soak_phase_under_the_card_rule(monkeypatch, capsys):
    monkeypatch.setattr(brk, "host_path_allowed", lambda device: False)
    monkeypatch.setattr(chip_smoke, "CHAOS_LARGE",
                        dict(seed=1, nodes=8, budget=60))
    held = chip_smoke.chaos_soak_phase(cuda_solver, "cpu", device="cpu")
    lines = [json.loads(raw) for raw in capsys.readouterr().out.splitlines()
             if raw.startswith("{")]
    runs = {d["run"]: d for d in lines if d["phase"] == "chaos-soak-run"}
    seeds = [d for d in lines if d["phase"] == "chaos-soak-seed"]
    for name in ("fake", "edge"):
        # Seeds 1, 2, ... in order, until every required site fired.
        swept = [d["seed"] for d in seeds if d["run"] == name]
        assert swept == list(range(1, len(swept) + 1))
        assert runs[name]["faults"] == []
    assert runs["fake"]["seeds"] > 2  # commit.flush_error needs more
    for d in seeds:
        assert d["loop_deaths"] == d["double_binds"] == 0
        assert d["path_problems"] == ([] if d["diverged"] else None)
    (summary,) = [d for d in lines if d["phase"] == "chaos-soak"]
    assert summary["launches"] == held > 0
    assert summary["arms"] == len(seeds) > summary["converged"] > 0
    assert summary["lost_evictions"] == 0
    assert summary["breaker_trips"] > 0 and summary["breaker_waited_s"] > 0
    assert summary["host_allocate"] == 0
    assert summary["plan"] == "off" and summary["breaker"] == "closed"
