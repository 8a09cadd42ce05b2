"""One cell of BENCHMARK.json, run once.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found here by the name that
BENCHMARK.json gives it:

- ``configs/<config>.json``: the deployment;
- ``traffic/<traffic>.json``: the mix; its ``pattern`` names the module
  ``patterns/<pattern>.py`` that runs it;
- ``e2e/<metric>.py`` and ``layers/<metric>.py``: one reader per
  end-to-end and per-layer metric, ``read(window)`` -> a number or None
  (nothing to read: the metric is left out of the line).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import time
from pathlib import Path

from . import devtrace, stats

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load(workload: str):
    """(BENCHMARK.json, the cell's entry, its config, its traffic)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    return bench, entry, config, traffic


def in_scope(metric: dict, workload: str) -> bool:
    """Whether ``metric`` is read in ``workload``: listed there, or in
    every cell where it lists none."""
    return workload in metric.get("workloads", (workload,))


def reader(kind: str, name: str):
    """The ``read`` function of ``<kind>/<name>.py``."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    module.__package__ = f"{__package__}.{kind}"
    spec.loader.exec_module(module)
    return module.read


def pattern(traffic: dict):
    return importlib.import_module(
        f"{__package__}.patterns.{traffic['pattern']}").Pattern


def device_facts(device) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    count = torch.cuda.device_count()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": max(
                torch.cuda.max_memory_allocated(i) for i in range(count))}


def run(workload: str, seed: int, seconds: float, trace: bool, *, device,
        t0: float, config=None, traffic=None):
    """(the result line of one run, its window).  ``config`` and
    ``traffic`` replace the cell's files (the tests' small sizes); ``t0``
    is the process start."""
    bench, _entry, cfg, tfc = load(workload)
    config = config or cfg
    traffic = traffic or tfc
    runner = pattern(traffic)(config, traffic, seed, device)
    runner.setup()
    setup_s = time.perf_counter() - t0
    if trace:
        with devtrace.Capture() as cap:
            window = runner.window(seconds)
        window.device = cap.trace
    else:
        window = runner.window(seconds)
    facts = device_facts(device)
    window.device_name = facts["kind"]
    runner.release()
    began = time.perf_counter()
    correct, checks, window.checked = runner.check()
    window.check_s = time.perf_counter() - began

    e2e = [m for m in bench["end_to_end"] if in_scope(m, workload)]
    if trace:
        chosen = [("layers", m) for m in bench["per_layer"]
                  if in_scope(m, workload)]
    else:
        chosen = [("e2e", m) for m in e2e]
    metrics = {}
    for kind, m in chosen:
        value = setup_s if m["name"] == "setup_s" else \
            reader(kind, m["name"])(window)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {"correct": correct, "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics, "device": facts}
    if trace and window.device is not None:
        facts["busy_s"] = devtrace.busy_seconds(window.device)
        facts["window_s"] = window.end - window.start
        events = window.device.events
        result["breakdown"] = {
            "device_ops": stats.top_ops(events),
            "idle_gaps": stats.top_gaps(
                [(s, e) for _n, s, e in events], window.start, window.end,
                window.host_spans()) if window.device.aligned else []}
    result["checks"] = checks
    return result, window


SUMMARY_SPANS = ("open_session", "tensorize", "ship", "solver.dispatch",
                 "solver.fetch", "apply", "action.backfill", "close_session")


def summary(window) -> list:
    """Lines for standard error: each session of the window, with the
    port's main spans in ms."""
    lines = []
    for i, s in enumerate(window.sessions):
        parts = " ".join(f"{n} {1e3 * stats.span_seconds(s.spans, n):.1f}"
                         for n in SUMMARY_SPANS)
        lines.append(f"session {i}: ingest {1e3 * s.ingest_s:.1f} run_once "
                     f"{1e3 * s.wall_s:.1f} binds {s.placements} | {parts}")
    cycle = {}
    for name, a, b, _d in window.phases:
        cycle[name] = cycle.get(name, 0.0) + (b - a)
    lines.append("window: " + " ".join(
        f"{n} {1e3 * t:.1f}" for n, t in sorted(cycle.items()))
        + f" | collector {1e3 * window.gc_s:.1f} ms in all, "
        f"{sum(1 for p in window.phases if p[0] == 'gc')} full passes")
    lines.append(f"reference: waves {window.checked} judged in "
                 f"{window.check_s:.1f} s")
    return lines
