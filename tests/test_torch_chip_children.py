"""chip_smoke.py's child processes, rehearsed on the CPU.

On the card the main path's plain version runs in a process of its own
beside the edge phases (``north_star_plain``) and the harness phases in
another (``python3 chip_smoke.py tools``) beside the phases from warmup
to topo-vs-cpu.  Here: the plain child's saved result is the plain
version's on byte-equal inputs and is refused for other inputs; a child
relays its lines and fails the script when it exits non-zero or runs
over; a ``tools`` child's launches and holds join the run's counts.
"""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

from kube_batch_tpu_torch.models.shipping import resident_shipper
from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
from kube_batch_tpu_torch.ops import cuda_solver

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

SHAPE = (300, 40, 12, 2)


class _Owner:
    pass


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "DAEMON_DIR", str(tmp_path / "daemon"))
    yield
    chip_smoke.Child.stop_live()


def test_north_star_plain_is_the_plain_version_on_the_same_ship(tmp_path,
                                                                 capsys):
    out = str(tmp_path / "plain.pt")
    chip_smoke.north_star_plain(out, shape=SHAPE, device="cpu")
    (line,) = [json.loads(raw) for raw in capsys.readouterr().out.splitlines()
               if raw.startswith('{"phase": "north-star-plain"')]
    assert line["device"] == "cpu" and line["plain_ms"] > 0

    inp, cfg = make_synthetic_inputs(*SHAPE, seed=0, dtype=torch.float32,
                                     device="cpu")
    shipped = resident_shipper(_Owner(), "cpu").ship(inp, cfg)
    pout, plain_ms = chip_smoke.load_north_star_plain(out, shipped, cfg)
    assert plain_ms == line["plain_ms"]
    want = cuda_solver.solve_allocate_plain(shipped, cfg)
    assert chip_smoke.compare(want, pout) == 0
    assert int(pout[0].step) == int(want[0].step)
    assert int((pout[0].kind > 0).sum()) > 0

    other = shipped._replace(node_idle=shipped.node_idle.clone())
    other.node_idle[0, 0] -= 1
    with pytest.raises(AssertionError, match="inputs differ"):
        chip_smoke.load_north_star_plain(out, other, cfg)


def test_child_relays_its_lines_and_fails_when_it_fails(tmp_path, capsys):
    ok = tmp_path / "ok.py"
    ok.write_text("import json\nprint('hello')\n"
                  "print(json.dumps({'phase': 'x', 'n': 3}))\n")
    child = chip_smoke.Child("ok", [], program=str(ok))
    child.proc.wait(60)
    time.sleep(0.5)
    phases = child.join(60)
    out = capsys.readouterr().out
    assert "hello" in out and phases == [{"phase": "x", "n": 3}]
    (line,) = [json.loads(raw) for raw in out.splitlines()
               if raw.startswith('{"phase": "child"')]
    # It had exited before the join: nothing was waited for.
    assert line["child"] == "ok" and line["waited_s"] == 0.0
    assert 0 < line["wall_s"] <= line["joined_s"] - 0.4

    bad = tmp_path / "bad.py"
    bad.write_text("import sys\nprint('boom', file=sys.stderr)\nsys.exit(4)\n")
    with pytest.raises(AssertionError, match=r"exited with 4:\nboom"):
        chip_smoke.Child("bad", [], program=str(bad)).join(60)

    # The script itself exits 1 without a card, in any mode.
    with pytest.raises(AssertionError, match="exited with 1"):
        chip_smoke.Child("tools", ["tools"]).join(120)


def test_child_that_runs_over_is_stopped(tmp_path):
    slow = tmp_path / "slow.py"
    slow.write_text("import time\ntime.sleep(600)\n")
    child = chip_smoke.Child("slow", [], program=str(slow))
    with pytest.raises(AssertionError, match="still running after 1 s"):
        child.join(1)
    assert child.proc.returncode is not None
    assert child not in chip_smoke.Child.LIVE

    left = chip_smoke.Child("left", [], program=str(slow))
    chip_smoke.Child.stop_live()
    assert left.proc.returncode is not None and not chip_smoke.Child.LIVE


def test_tools_child_counts_join_the_runs_holds(monkeypatch):
    monkeypatch.setattr(chip_smoke.LaunchLedger, "counts",
                        {"plain": 2, "byte_equal": 5})
    phases = [{"phase": "scenarios"},
              {"phase": "tools-only", "launches": 17,
               "held": {"plain": 10, "byte_equal": 7}}]
    assert chip_smoke.tools_child_counts(phases) == 17
    assert chip_smoke.LaunchLedger.counts == {"plain": 12, "byte_equal": 12}
