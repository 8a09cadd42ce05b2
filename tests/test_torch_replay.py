"""The port's lineage-ring replay (kube_batch_tpu_torch/tools/replay.py)
against the reference's (tools/replay.py), on the CPU.

The four cases of tests/test_topology.py's ``TestReplayRoundTrip`` on the
port (a recorded run replays bit-identically, an overflowed ring and a
disabled ring are refused, a pod ingested after the last session lands
after the loop), then the trace format across packages: a trace the
reference records replays bit-identically in the port, and one the port
records replays bit-identically in the reference.  Last, the CLI's
self-test on the CPU and its refusal to start without a card.
"""

import json

import pytest
import torch

from kube_batch_tpu_torch.cache import Cluster
from kube_batch_tpu_torch.chaos import plan as chaos_plan
from kube_batch_tpu_torch.chaos.breaker import device_breaker
from kube_batch_tpu_torch.tools import replay as replay_mod
from kube_batch_tpu_torch.tools import scenario_gen as sg
from kube_batch_tpu_torch.trace.lineage import lineage
from tests.test_torch_utils import reference_gc_guard  # noqa: F401
from tools import replay as ref_replay
from tools import scenario_gen as ref_sg

ARM = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def _clean():
    chaos_plan.disable()
    device_breaker().reset()
    lineage.refresh()
    yield
    chaos_plan.disable()
    device_breaker().reset()
    lineage.refresh()


class TestReplayRoundTrip:
    def test_recorded_run_replays_bit_identically(self):
        spec = sg.gen_scenario("frag_pressure", 1)
        trace = sg.record_trace(spec, cycles_per_wave=2, **ARM)
        assert trace["recorded"]["bind_map"]  # non-vacuous
        trace = json.loads(json.dumps(trace))
        result = replay_mod.replay(trace, **ARM)
        assert replay_mod.compare(trace, result) == []

    def test_capture_refuses_overflowed_ring(self, monkeypatch):
        monkeypatch.setenv("KUBE_BATCH_TPU_LINEAGE_RING", "4")
        lineage.refresh()
        spec = sg.gen_scenario("frag_pressure", 0)
        with pytest.raises(RuntimeError, match="overflowed"):
            sg.record_trace(spec, cycles_per_wave=2, **ARM)
        monkeypatch.delenv("KUBE_BATCH_TPU_LINEAGE_RING")
        lineage.refresh()

    def test_pod_after_last_session_lands_after_the_loop(self):
        cluster = Cluster()
        archive = replay_mod.SpecArchive(cluster)
        lineage.note_session_open()
        lineage.note_session_open()
        cluster.create_pod(replay_mod.build_pod(sg._pod_op("early-0", "g0")))
        lineage.note_ingest(f"{sg.NS}/early-0", None)
        lineage.note_session_open()
        cluster.create_pod(replay_mod.build_pod(sg._pod_op("late-0", "g0")))
        lineage.note_ingest(f"{sg.NS}/late-0", None)
        trace = replay_mod.capture(archive, sg.BASE_CONF)
        by_name = {p["name"]: p for p in trace["pods"]}
        assert by_name["early-0"]["first_session"] == 3
        assert by_name["late-0"]["first_session"] == \
            int(trace["recorded_sessions"]) + 1

    def test_capture_requires_lineage_ring(self, monkeypatch):
        monkeypatch.setenv("KUBE_BATCH_TPU_LINEAGE", "0")
        lineage.refresh()
        archive = replay_mod.SpecArchive(Cluster())
        with pytest.raises(RuntimeError, match="LINEAGE"):
            replay_mod.capture(archive, sg.BASE_CONF)
        monkeypatch.delenv("KUBE_BATCH_TPU_LINEAGE")
        lineage.refresh()


def _recorded_by_reference(kind, seed):
    from kube_batch_tpu.trace.lineage import lineage as ref_lineage
    ref_lineage.refresh()
    try:
        trace = ref_sg.record_trace(ref_sg.gen_scenario(kind, seed),
                                    cycles_per_wave=2)
    finally:
        ref_lineage.refresh()
    return json.loads(json.dumps(trace))


def test_reference_trace_replays_in_the_port():
    """A trace the reference recorded (its batched arm, JAX x64) is the
    same format, and the port re-drives it to the recorded outcome."""
    trace = _recorded_by_reference("churn_storm", 2)
    assert trace["version"] == replay_mod.TRACE_VERSION
    assert trace["recorded"]["bind_map"] and trace["recorded"]["deleted"]
    result = replay_mod.replay(trace, **ARM)
    assert replay_mod.compare(trace, result) == []
    assert result["bind_map"] == trace["recorded"]["bind_map"]


def test_port_trace_replays_in_the_reference():
    trace = json.loads(json.dumps(sg.record_trace(
        sg.gen_scenario("priority_inversion", 1), cycles_per_wave=2,
        **ARM)))
    assert trace["recorded"]["bind_map"]
    assert sorted(trace) == sorted(_recorded_by_reference(
        "priority_inversion", 1))
    result = ref_replay.replay(trace)
    assert ref_replay.compare(trace, result) == []


def test_cli_selftest_on_the_cpu_and_no_card(capsys):
    assert replay_mod.main(["--selftest", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["errors"] == [] and out["recorded_binds"] > 0
    if not torch.cuda.is_available():
        assert replay_mod.main(["--selftest"]) == 1
        assert "CUDA" in capsys.readouterr().err
