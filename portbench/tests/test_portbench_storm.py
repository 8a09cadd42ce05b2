"""The storm cell on the CPU at a small size: the port's cycles against
reference/evict.py, the faults the comparison has to catch, the
bfloat16 control, the reference's imports and the storm's layer
readers.  Sizes stay at 64 nodes or more, where the port's eviction
scanner engages as it does at the cell's size."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import cell, control_storm, generator, informer, storm_check
from portbench.cell import reader
from portbench.patterns import storm
from portbench.reference import evict
from portbench.window import Session, Window

ROOT = Path(__file__).resolve().parents[2]
WORKLOAD = "churn50k.storm"


def small(nodes=80, wave=80, sessions=8, warmup=1):
    """The cell's files at ``nodes`` nodes, four residents a node and
    ``wave`` preemptors; the check judges the window's first cycle."""
    _bench, _entry, config, traffic = cell.load(WORKLOAD)
    config["nodes"] = nodes
    config["residents"]["pods"] = 4 * nodes
    traffic.update(wave_pods=wave, warmup_cycles=warmup, prebuilt_cycles=1,
                   checked_cycles=1, checked_among=1, max_sessions=sessions)
    return config, traffic


def _run(seed=2 ** 33 + 9, **kw):
    config, traffic = small(**kw)
    return cell.run(WORKLOAD, seed, 0.01, False, device="cpu",
                    t0=time.perf_counter(), config=config, traffic=traffic)


@pytest.mark.parametrize("nodes,wave,seed", [(80, 80, 3),
                                             (120, 200, 2 ** 34 + 1)])
def test_the_port_agrees_with_the_reference(nodes, wave, seed):
    result, window = _run(seed, nodes=nodes, wave=wave)
    assert result["correct"] is True, result["checks"]
    assert all(c == {"value": 0, "limit": 0}
               for c in result["checks"].values())
    assert set(result["checks"]) == set(storm_check.LIMITS)
    assert set(result["metrics"]) == {"session_ms", "bind_p95_ms",
                                      "setup_s"}
    # One cycle judged, every one of its sessions counted in the window.
    assert window.checked == [1] and len(window.sessions) >= 2
    assert result["attempted"] == wave
    json.dumps(result)


def _victims_altered(how):
    def fault(monkeypatch):
        real = storm.BatchEvictor.evict_many

        def evict_many(self, pods):
            pods = list(pods)
            if len(pods) >= 2 and not getattr(self, "_faulted", False):
                self._faulted = True
                how(pods)
            return real(self, pods)
        monkeypatch.setattr(storm.BatchEvictor, "evict_many", evict_many)
    return fault


def _swap_order(pods):
    pods[0], pods[1] = pods[1], pods[0]


def _swap_victim(pods):
    """The first victim reported as another resident, one that stays."""
    from kube_batch_tpu_torch.api import ObjectMeta, Pod
    meta = pods[0].metadata
    pods[0] = Pod(metadata=ObjectMeta(name="r319", namespace=meta.namespace,
                                      uid=f"{meta.namespace}-r319"))


def _bind_elsewhere(monkeypatch):
    real = informer.StampBinder.bind_many

    def bind_many(self, pairs):
        pairs = list(pairs)
        if pairs:
            pod, node = pairs[0]
            pairs[0] = (pod, "n00" if node != "n00" else "n01")
        return real(self, pairs)
    monkeypatch.setattr(informer.StampBinder, "bind_many", bind_many)


def _never_deleted(monkeypatch):
    monkeypatch.setattr(storm.Storm, "_complete", lambda self, v: None)


@pytest.mark.parametrize("fault,check", [
    (_victims_altered(_swap_victim), "victim_mismatches"),
    (_victims_altered(_swap_order), "victim_order_mismatches"),
    (_bind_elsewhere, "bind_mismatches"),
    (_never_deleted, "node_mismatches")])
def test_a_fault_is_not_correct(monkeypatch, fault, check):
    fault(monkeypatch)
    result, _window = _run(nodes=80, wave=80, warmup=0)
    assert result["correct"] is False
    assert result["checks"][check]["value"] > 0


def test_an_unrun_cycle_is_not_correct(monkeypatch):
    monkeypatch.setattr(storm.Storm, "window", lambda self, s: Window(
        start=0.0, end=1.0, sessions=[], latencies=[], attempted=0,
        failed=0))
    result, _window = _run()
    assert result["correct"] is False
    assert result["checks"]["unrun_cycles"]["value"] == 1


def test_the_bfloat16_control_is_not_correct():
    config, traffic = small(nodes=200, wave=200)
    out = control_storm.control(WORKLOAD, 1, config, traffic)
    assert out["correct"] is False
    checks = out["checks"]
    assert (checks["victim_mismatches"]["value"]
            + checks["bind_mismatches"]["value"]) > 0


def test_the_reference_refuses_a_best_effort_wave():
    config, traffic = small()
    cluster = generator.make_cluster(config, 1)
    residents = storm_check.make_residents(config, cluster)
    wave = storm_check.make_wave(config, traffic, cluster, 1, 0)
    wave.pod_req[:] = 0
    with pytest.raises(evict.OutOfScope):
        evict.run_cycle(cluster, residents, wave)


def test_the_reference_strands_one_preemptor_a_gang():
    """reclaim runs before tpu-allocate and pipelines one pending task of
    every popped job each session, so the last task of each gang is
    pipelined again every session and never bound."""
    config, traffic = small(nodes=80, wave=100)
    cluster = generator.make_cluster(config, 5)
    residents = storm_check.make_residents(config, cluster)
    wave = storm_check.make_wave(config, traffic, cluster, 5, 0)
    sessions = evict.run_cycle(cluster, residents, wave, max_sessions=8)
    bound = sum(int((d.node >= 0).sum()) for d in sessions)
    assert len(sessions) == 8
    assert bound == 100 - len(wave.group_names)
    assert [a for _r, a in sessions[-1].victims] == \
        ["reclaim"] * len(wave.group_names)


def test_the_reference_imports_neither_package_nor_jax():
    code = ("import sys\n"
            "import portbench.reference.evict, portbench.control_storm\n"
            "names = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(names & {'jax', 'jaxlib', 'kube_batch_tpu',"
            " 'kube_batch_tpu_torch', 'torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def _session(due, start, spans):
    return Session(due=due, ingest_s=0.1, start=start, end=start + 2.0,
                   nodes=10_000, pods=10_000, jobs=400, queues=4,
                   placements=0,
                   spans=[(n, a + start, b + start, d)
                          for n, a, b, d in spans])


STORM = [("cache.delete", -0.5, -0.2, 0),
         ("action.reclaim", 0.0, 0.6, 0), ("reclaim.walk", 0.0, 0.5, 1),
         ("evict.batch_solve", 0.1, 0.3, 2), ("commit.flush", 0.5, 0.55, 1),
         ("action.preempt", 1.0, 1.9, 0), ("evict.recompute", 1.0, 1.1, 1),
         ("statement.commit", 1.2, 1.25, 2),
         ("statement.discard", 1.3, 1.32, 2),
         ("commit.flush", 1.8, 1.83, 1)]


def test_the_storm_readers():
    # Two cycles: the first session of each carries the restore.
    w = Window(start=0.0, end=40.0, sessions=[
        _session(0.0, 1.0, STORM), _session(0.0, 5.0, STORM),
        _session(10.0, 11.0, STORM), _session(10.0, 15.0, STORM)],
        latencies=[1.0], attempted=1, failed=0)
    assert reader("layers", "reclaim_ms")(w) == pytest.approx(600.0)
    assert reader("layers", "preempt_ms")(w) == pytest.approx(900.0)
    assert reader("layers", "evict_solve_ms")(w) == pytest.approx(300.0)
    assert reader("layers", "evict_commit_ms")(w) == pytest.approx(150.0)
    assert reader("layers", "release_ms")(w) == pytest.approx(300.0)


def test_the_storm_readers_find_nothing_where_nothing_is_recorded():
    plain = [("open_session", 0.0, 0.3, 0), ("apply", 0.8, 2.8, 1)]
    w = Window(start=0.0, end=30.0, sessions=[
        _session(0.0, 1.0, plain), _session(0.0, 5.0, plain)],
        latencies=[1.0], attempted=1, failed=0)
    for name in ("reclaim_ms", "preempt_ms", "evict_solve_ms",
                 "evict_commit_ms", "release_ms"):
        assert reader("layers", name)(w) is None


def test_the_cell_is_appended_to_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell_ = next(w for w in bench["workloads"] if w["name"] == WORKLOAD)
    assert cell_ == {**cell_, "config": "churn50k", "traffic": "storm",
                     "chips": 1}
    mine = [m for m in bench["per_layer"]
            if WORKLOAD in m.get("workloads", ())]
    assert [m["name"] for m in mine] == [
        "reclaim_ms", "preempt_ms", "evict_solve_ms", "evict_commit_ms",
        "release_ms"]
    assert all(m["workloads"] == [WORKLOAD] for m in mine)
