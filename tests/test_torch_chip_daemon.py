"""chip_smoke.py's daemon, warmup and tensorize-limit phases, rehearsed on
the CPU.

On the card the ``daemon`` phase boots ``python -m
kube_batch_tpu_torch.cli.main`` three times against a cluster-state
file and reads its HTTP surfaces; ``warmup`` runs SolverWarmup in
process before a live session; ``tensorize-limit`` drives a session
past the tensorizer's host-port limit.  Here, at small shapes with
``device="cpu"``: the cluster-state file loads into the cluster
make_synthetic_cache builds and binds as it does; the /metrics parser
reads the daemon's counters off a real exposition; the warmup phase
counts its session as a compile-cache hit and holds every launch; the
tensorize-limit drill moves only its own counter and binds as the CPU.
The guard (``fused_counters``) now counts tensorizer limits.
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

SHAPE = (300, 40, 12, 2)


def _lines(capsys, name):
    return [json.loads(raw) for raw in capsys.readouterr().out.splitlines()
            if raw.startswith("{") and json.loads(raw).get("phase") == name]


@pytest.fixture(autouse=True)
def _fresh():
    from kube_batch_tpu_torch.chaos import breaker, plan
    chip_smoke.LaunchLedger.HELD.clear()
    plan.disable()
    breaker.device_breaker().reset()
    yield
    chip_smoke.LaunchLedger.HELD.clear()
    chip_smoke.KEPT.clear()
    plan.disable()
    breaker.device_breaker().reset()
    gc.unfreeze()


def test_cluster_state_file_is_the_synthetic_cluster(tmp_path):
    """The daemon's state file, loaded as the daemon loads it, holds the
    synthetic cluster's nodes, queues, groups and pods, and the phase's
    reference cycle (the plain route) binds as many pods as a session on
    make_synthetic_cache, with nothing pending in its tenant table."""
    from kube_batch_tpu_torch.actions.tpu_allocate import TpuAllocateAction
    from kube_batch_tpu_torch.cache import Cluster
    from kube_batch_tpu_torch.cli.server import load_cluster_state
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_cache

    path = str(tmp_path / "state.json")
    chip_smoke.write_cluster_state(path, SHAPE)
    cluster = Cluster()
    load_cluster_state(cluster, path)
    assert (len(cluster.nodes), len(cluster.queues), len(cluster.pod_groups),
            len(cluster.pods)) == (SHAPE[1], SHAPE[3], SHAPE[2], SHAPE[0])
    cycle = chip_smoke.in_process_cycle(path)
    assert set(cycle["binds_by_queue"]) == {f"q{q}" for q in range(SHAPE[3])}
    assert all(r["pending_jobs"] == 0 for r in cycle["tenants"].values())

    synthetic, binder = make_synthetic_cache(*SHAPE)
    tiers = chip_smoke._register("cpu")
    chip_smoke._run_session(synthetic, tiers, TpuAllocateAction(
        device="cpu", dtype=torch.float32))
    assert sum(cycle["binds_by_queue"].values()) == len(binder.binds) > 0


def test_metrics_parser_reads_the_daemons_counters():
    from kube_batch_tpu_torch.metrics import metrics
    metrics.note_tensorize_limit("host_ports", "tpu-allocate")
    metrics.slo_time_to_bind.observe(0.5, "q-parse")
    parsed = chip_smoke.parse_metrics(metrics.registry.expose())
    assert chip_smoke.metric_total(
        parsed, "kube_batch_tensorize_limit_total") >= 1
    by_queue = chip_smoke.metric_by(
        parsed, "kube_batch_slo_time_to_bind_seconds_count", "queue")
    assert by_queue["q-parse"] >= 1
    assert "kube_batch_compile_cache_hits_total" in parsed


def _kept_session(shape):
    """KEPT["session"] as session_phase leaves it, at ``shape`` on the
    CPU: one session run and its binds echoed back."""
    from kube_batch_tpu_torch.actions.tpu_allocate import TpuAllocateAction
    from kube_batch_tpu_torch.api import pod_key
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_cache

    tiers = chip_smoke._register("cpu")
    cache, binder = make_synthetic_cache(*shape)
    pods = {pod_key(t.pod): t.pod for job in cache.jobs.values()
            for t in job.tasks.values()}
    action = TpuAllocateAction(device="cpu", dtype=torch.float32)
    runs = []
    with chip_smoke.incremental_arm(False):
        for _ in range(2):
            seen = len(binder.channel)
            stages, wall = chip_smoke._run_session(cache, tiers, action)
            binds = chip_smoke.echo_binds(cache, binder, pods, seen)
            runs.append((stages, wall, len(binds), 0.0))
    chip_smoke.KEPT["session"] = dict(cache=cache, binder=binder, pods=pods,
                                      action=action, tiers=tiers, runs=runs,
                                      binds=[binds])


def test_warmup_phase_counts_a_hit_and_holds_every_launch(capsys):
    _kept_session(SHAPE)
    launches = chip_smoke.warmup_phase(cuda_solver, "cpu", device="cpu",
                                       shape=SHAPE)
    (line,) = _lines(capsys, "warmup")
    assert launches == line["launches"] == 4
    assert (line["session_hits"], line["session_misses"]) == (1, 0)
    assert sum(line["held"]["held"].values()) == 4
    assert set(line["members_ms"]) == {"torch", "evict_batch", "candidate",
                                       "topo_box", "fused"}


def test_tensorize_limit_phase_moves_only_its_counter(capsys):
    assert chip_smoke.tensorize_limit_phase(
        cuda_solver, "cpu", shape=SHAPE, device="cpu") == 0
    (line,) = _lines(capsys, "tensorize-limit")
    assert line["limits"] == {"host_ports/tpu-allocate": 1}
    assert line["guards"] == {"tensorize_limits": 1}
    assert line["binds"] > chip_smoke.PORT_KEYS


def test_the_guard_fails_a_phase_at_a_tensorizer_limit():
    from kube_batch_tpu_torch.metrics import metrics

    def phase_at_the_limit():
        metrics.note_tensorize_limit("selectors", "scanner")

    with pytest.raises(AssertionError, match="tensorize_limits"):
        chip_smoke.guarded(phase_at_the_limit, where="limit")


def test_daemon_phase_holds_every_placement_on_the_cpu(tmp_path,
                                                       monkeypatch, capsys):
    """The daemon phase end to end at a small shape, its three boots on
    the CPU (the launcher's rehearsal device): every pod lands where the
    in-process cycle of the plain route puts it, and the control's first
    live solve is a miss."""
    monkeypatch.setattr(chip_smoke, "DAEMON_DIR", str(tmp_path / "daemon"))
    monkeypatch.setattr(cuda_solver, "BUILD_DIR", tmp_path / "kernels")
    assert chip_smoke.daemon_phase(cuda_solver, "cpu", shape=SHAPE,
                                   device="cpu") == 0
    (line,) = _lines(capsys, "daemon")
    assert line["placements_held"] == SHAPE[0]
    assert line["first_solve"]["control"] == "miss"
    assert line["k1_launches_in_daemons"] == dict(cold=0, warm=0, control=0)


def test_placements_differ_counts_every_moved_or_missing_pod():
    want = {"ns/a": "n1", "ns/b": "n2", "ns/c": ""}
    assert chip_smoke.placements_differ(dict(want), want) == 0
    assert chip_smoke.placements_differ(
        {"ns/a": "n2", "ns/b": "n2", "ns/c": ""}, want) == 1
    assert chip_smoke.placements_differ({"ns/a": "n1", "ns/b": "n2"},
                                        want) == 1
    assert chip_smoke.placements_differ(
        dict(want, **{"ns/d": "n1"}), want) == 1


def test_host_plains_equal_the_plain_version_in_process():
    """The kernel-vs-plain matrix's plain versions, computed in worker
    processes, are the plain version's results on the same inputs."""
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
    cases = [make_synthetic_inputs(200, 40, 20, 3, seed=seed,
                                   dtype=torch.float64, device="cpu")
             for seed in (0, 1)]
    got = chip_smoke.HostPlains(cases, workers=2).results(300)
    for (inp, cfg), pout in zip(cases, got):
        assert chip_smoke.compare(
            pout, cuda_solver.solve_allocate_plain(inp, cfg)) == 0
