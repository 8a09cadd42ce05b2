"""chip_smoke.py's tenancy and loop phases, rehearsed on the CPU.

On the card these phases hold every launch of the session kernel against
its plain version (each record captured when tpu-allocate's finish runs,
then solved again by ``solve_allocate_plain``).  Here they run at a small
size with ``device="cpu"``, where tpu-allocate solves through the plain
version itself: the tests hold the phases to what they claim — every
dispatch after the warm pass captured and held, the arms equal, the one
big shard's gang bound, the loop's cycles held — so that a change to
the capture cannot leave a launch unchecked on the card.
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

SMALL = dict(n_tasks=800, n_nodes=80, n_queues=4)


def _lines(capsys):
    """The phase lines printed so far, as dicts by phase name."""
    by_name = {}
    for raw in capsys.readouterr().out.splitlines():
        if raw.startswith("{"):
            line = json.loads(raw)
            by_name.setdefault(line.get("phase"), []).append(line)
    return by_name


@pytest.fixture(autouse=True)
def _unfrozen():
    yield
    gc.unfreeze()


def test_tenancy_phase_holds_every_dispatch(capsys):
    chip_smoke.tenancy_phase(cuda_solver, "cpu", device="cpu", shape=SMALL,
                             rounds=4)
    lines = _lines(capsys)
    arms = lines["tenancy-arm"]
    assert [arm["concurrent"] for arm in arms] == [False, True]
    for arm in arms:
        # 4 rounds x 4 shards, each shard session one dispatch of a
        # 10-pod gang (800 tasks at churn_frac 0.05 over 4 tenants).
        assert arm["vs_plain"]["held"] == 16
        assert arm["vs_plain"]["max_abs_err"] == 0
        assert arm["vs_plain"]["placed"] == [10] * 16
        assert arm["begins"] == (16 if arm["concurrent"] else 0)
    (total,) = lines["tenancy"]
    assert total["held_against_plain"] == 32
    assert total["binds_per_round"] == [40] * 4


def test_tenancy_backlog_phase_binds_the_big_shard(capsys):
    chip_smoke.tenancy_backlog_phase(cuda_solver, "cpu", device="cpu",
                                     shape=SMALL, backlogs=(40, 160))
    lines = _lines(capsys)["tenancy-backlog"]
    assert [line["backlog"] for line in lines] == [40, 160]
    for line in lines:
        assert line["binds"] == line["backlog"] + 12
        assert line["vs_plain"]["held"] == 4
        assert line["vs_plain"]["placed"] == [line["backlog"], 4, 4, 4]
        assert line["begins"] == 4
        assert [t[0] for t in line["begin_timings"]] == [0, 1, 2, 3]
        assert line["shard0_device_tail_ms"] is None


def test_scheduler_loop_phase_holds_each_cycle(capsys):
    chip_smoke.scheduler_loop_phase(cuda_solver, "cpu", device="cpu",
                                    shape=(300, 60, 12, 4))
    (line,) = _lines(capsys)["scheduler-loop"]
    assert line["first_cycle_binds"] == 300
    assert line["binds"] == 301
    # The first cycle's full solve and the churned pod's.
    assert line["vs_plain"]["held"] == 2
    assert line["vs_plain"]["placed"] == [300, 1]
    assert line["vs_plain"]["max_abs_err"] == 0
