"""Whole runs on the CPU at small sizes: the result line, the checks, the
faults that have to make ``correct`` false, and the process guards."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import cell, informer
from portbench.run import FORBIDDEN, forbidden_loaded
from portbench.tests._small import WORKLOAD, small

ROOT = Path(__file__).resolve().parents[2]


def _run(seconds=0.01, **kw):
    config, traffic = small(**kw)
    return cell.run(WORKLOAD, 2 ** 33 + 5, seconds, False, device="cpu",
                    t0=time.perf_counter(), config=config, traffic=traffic)


def test_the_result_line():
    result, window = _run()
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True
    # The window runs through the two waves drawn for the check.
    assert result["attempted"] == 1200 and result["failed"] == 0
    assert set(result["metrics"]) == {"session_ms", "bind_p95_ms",
                                      "setup_s"}
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"] in ("ms", "s")
    assert all(c == {"value": 0, "limit": 0}
               for c in result["checks"].values())
    assert len(window.sessions) == 2 and window.checked == [1, 2]
    json.dumps(result)
    assert cell.summary(window)[0].startswith("session 0:")


def test_no_wave_in_the_window_is_not_correct(monkeypatch):
    config, traffic = small()
    monkeypatch.setattr("portbench.patterns.burst.Burst.window",
                        lambda self, s: _empty_window())
    result, _w = cell.run(WORKLOAD, 1, 1.0, False, device="cpu",
                          t0=time.perf_counter(), config=config,
                          traffic=traffic)
    assert result["correct"] is False


def _empty_window():
    from portbench.window import Window
    return Window(start=0.0, end=1.0, sessions=[], latencies=[],
                  attempted=0, failed=0)


def _unchanged(monkeypatch):
    """A session that returns the state unchanged."""
    monkeypatch.setattr(
        "kube_batch_tpu_torch.scheduler.Scheduler.run_once",
        lambda self: None)


def _half_left_out(monkeypatch):
    """Half of the batch left out: every other bind never happens."""
    real = informer.StampBinder.bind_many
    monkeypatch.setattr(informer.StampBinder, "bind_many",
                        lambda self, pairs: real(self, list(pairs)[::2]))


def _answer_altered(monkeypatch):
    """One answer altered where it is produced: a bind to another node."""
    real = informer.StampBinder.bind_many

    def bind_many(self, pairs):
        pairs = list(pairs)
        if pairs:
            pod, node = pairs[0]
            pairs[0] = (pod, "n000" if node != "n000" else "n001")
        return real(self, pairs)
    monkeypatch.setattr(informer.StampBinder, "bind_many", bind_many)


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _answer_altered])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, _window = _run(warmup=0)
    assert result["correct"] is False
    assert result["checks"]["bind_mismatches"]["value"] > 0


def test_forbidden_names_compare_whole_top_level_names():
    assert FORBIDDEN == ("jax", "jaxlib", "flax", "kube_batch_tpu")
    mods = {"kube_batch_tpu_torch": 1, "kube_batch_tpu_torch.ops": 1,
            "jaxtyping": 1, "numpy": 1}
    assert forbidden_loaded(mods) == []
    mods.update({"jax._src.core": 1, "kube_batch_tpu.ops": 1})
    assert forbidden_loaded(mods) == ["jax", "kube_batch_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time\n"
        "from portbench import cell\n"
        "from portbench.run import forbidden_loaded\n"
        "from portbench.tests._small import WORKLOAD, small\n"
        "c, t = small()\n"
        "r, _ = cell.run(WORKLOAD, 7, 0.01, False, device='cpu', "
        "t0=time.perf_counter(), config=c, traffic=t)\n"
        "assert r['correct'], r\n"
        "print(forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_a_card(monkeypatch, capsys):
    import torch

    from portbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", WORKLOAD, "--seed", "1", "--seconds",
                     "1"]) != 0
    assert capsys.readouterr().out == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", WORKLOAD,
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_the_checked_waves_are_drawn_before_the_window():
    from portbench.patterns.burst import Burst
    config, traffic = small()
    traffic.update(warmup_waves=2, checked_waves=2, checked_among=4)
    draws = {tuple(Burst(config, traffic, seed, "cpu").sample)
             for seed in range(2 ** 33, 2 ** 33 + 40)}
    assert all(len(d) == 2 and 2 <= d[0] < d[1] <= 5 for d in draws)
    assert len(draws) > 1
    assert Burst(config, traffic, 9, "cpu").sample == \
        Burst(config, traffic, 9, "cpu").sample


def test_the_collector_is_timed_in_the_window():
    import gc

    from portbench.patterns.burst import GC_DEPTH, Collector
    collector = Collector()
    gc.callbacks.append(collector)
    try:
        gc.collect()
    finally:
        gc.callbacks.remove(collector)
    assert collector.seconds > 0
    assert [(n, d) for n, _a, _b, d in collector.full] == [("gc", GC_DEPTH)]
