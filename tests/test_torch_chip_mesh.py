"""chip_smoke.py's ``mesh`` phase rehearsed on the CPU.

On the card the phase runs K1's shard mode on 4 shards of one H100 at
50,000 x 16,384, tpu-allocate sessions and a fused session on the forced
mesh, and holds every launch against single-device K1 or the plain
version.  Here the same phase runs end to end at small shapes with
``device="cpu"``: the plain versions stand in for both kernels, and
SHARD_NODES is lowered so that the small shape crosses the gate
unforced, as the full width does on the card.
"""

import gc
import json
import sys
from pathlib import Path

import pytest
import torch

from kube_batch_tpu_torch.ops import cuda_solver
from kube_batch_tpu_torch.ops import solver

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    chip_smoke.KEPT.clear()
    monkeypatch.delenv(solver.FORCE_SHARD_ENV, raising=False)
    yield
    chip_smoke.KEPT.clear()
    solver._SHARD_KNOBS = None
    gc.unfreeze()


def test_mesh_phase_holds_every_route(monkeypatch, capsys):
    monkeypatch.setenv(solver.SHARD_NODES_ENV, "128")
    launches = chip_smoke.mesh_phase(
        cuda_solver, "cpu", device="cpu", shape=(400, 128, 16, 4),
        small=(200, 32, 10, 2), session=(120, 32, 8, 2),
        fused=(300, 32, 12, 2), topo_dims=(4, 4, 2), candidate_tasks=4)
    assert launches == 0  # no kernel on the CPU: the plain versions ran
    (line,) = [json.loads(raw) for raw in capsys.readouterr().out.splitlines()
               if raw.startswith("{")
               and json.loads(raw).get("phase") == "mesh"]
    assert line["shards"] == chip_smoke.MESH_SHARDS
    assert line["devices"] == ["cpu"] * chip_smoke.MESH_SHARDS
    assert line["max_abs_err"] == 0 and line["small_max_abs_err"] == 0
    modes = [m[0] for m in line["ship_modes"]]
    assert modes[0] == "full" and modes[2] == "clean" and modes[3] == "delta"
    assert line["fused_evictions"] > 0
    assert line["candidate_rows"] > 0
    assert chip_smoke.KEPT["mesh"]["max_abs_err"] == 0
