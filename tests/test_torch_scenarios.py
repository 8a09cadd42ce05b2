"""The port's scenario generator (kube_batch_tpu_torch/tools/scenario_gen.py)
against the reference's (tools/scenario_gen.py), on the CPU.

* ``TestScenarioDeterminism``: the twin of tests/test_topology.py's class
  (same seed, same bytes; the canonical bytes round-trip), and the port's
  ``scenario_bytes(gen_scenario(kind, seed))`` equal to the reference's
  for every kind at seeds 0-2;
* ``TestE2ESlicePlacement``: the twin of tests/test_topology.py's class
  on the port's arms (the batched arm equals the sequential arm on the
  fragmentation-pressure scenario, the slice on one box, the SLO table,
  the ``TOPOLOGY=0`` / ``TOPO_DEFRAG=0`` / ``TOPO_MAX_NODES`` controls);
* the port's batched arm (bind map, surviving pods, deletes) equal to the
  reference's ``run_arm`` for ``frag_pressure`` 0 and
  ``priority_inversion`` 1, both with float64 keys (the tests run the JAX
  package with x64 on).
"""

import json

import pytest
import torch

from kube_batch_tpu_torch.chaos import plan as chaos_plan
from kube_batch_tpu_torch.chaos.breaker import device_breaker
from kube_batch_tpu_torch.metrics import metrics
from kube_batch_tpu_torch.models import topology as topo
from kube_batch_tpu_torch.tools import scenario_gen as sg
from tests.test_torch_utils import reference_gc_guard  # noqa: F401
from tools import scenario_gen as ref_sg

ARM = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos_plan.disable()
    device_breaker().reset()
    yield
    chaos_plan.disable()
    device_breaker().reset()


class TestScenarioDeterminism:
    @pytest.mark.parametrize("kind", sg.KINDS)
    def test_same_seed_byte_identical(self, kind):
        for seed in (0, 3):
            a = sg.scenario_bytes(sg.gen_scenario(kind, seed))
            b = sg.scenario_bytes(sg.gen_scenario(kind, seed))
            assert a == b

    def test_canonical_bytes_round_trip(self):
        spec = sg.gen_scenario("churn_storm", 5)
        rt = json.loads(sg.scenario_bytes(spec))
        assert sg.scenario_bytes(rt) == sg.scenario_bytes(spec)
        assert rt["seed"] == 5 and rt["kind"] == "churn_storm"

    @pytest.mark.parametrize("kind", ref_sg.KINDS)
    def test_bytes_equal_the_reference(self, kind):
        assert sg.KINDS == ref_sg.KINDS
        for seed in (0, 1, 2):
            assert sg.scenario_bytes(sg.gen_scenario(kind, seed)) == \
                ref_sg.scenario_bytes(ref_sg.gen_scenario(kind, seed))


@pytest.fixture(scope="module")
def frag_runs():
    """One frag_pressure scenario through both of the port's arms."""
    chaos_plan.disable()
    spec = sg.gen_scenario("frag_pressure", 0)
    batched = sg.run_arm(spec, sequential=False, cycles_per_wave=2, **ARM)
    oracle = sg.run_arm(spec, sequential=True, cycles_per_wave=2, **ARM)
    return spec, batched, oracle


class TestE2ESlicePlacement:
    def test_batched_equals_sequential_oracle(self, frag_runs):
        spec, batched, oracle = frag_runs
        assert sg.check_invariants(spec, batched) == []
        assert sg.check_invariants(spec, oracle) == []
        assert sg.compare_arms(batched, oracle) == []
        assert batched["breaker_trips"] == oracle["breaker_trips"] == 0
        assert batched["launches"] == oracle["launches"] == 0  # the CPU

    def test_slice_bound_contiguously(self, frag_runs):
        spec, batched, _ = frag_runs
        hosts = {node for key, node in batched["bind_map"].items()
                 if key.startswith(f"{sg.NS}/slice0-")}
        assert len(hosts) == 8  # the whole 2x2x2 box, one task per node
        coords = sorted(tuple(int(v) for v in h.split("-")[1:])
                        for h in hosts)
        x0, y0, z0 = coords[0]
        names = [d["name"] for d in spec["inventory"]["nodes"]]
        dx, dy, dz = (1 + max(int(n.split("-")[i]) for n in names)
                      for i in (1, 2, 3))
        want = sorted(((x0 + ox) % dx, (y0 + oy) % dy, (z0 + oz) % dz)
                      for ox in range(2) for oy in range(2)
                      for oz in range(2))
        assert coords == want

    def test_frag_slo_published(self, frag_runs):
        doc = topo.topo_table.snapshot()
        assert doc["pools"], "topo table never published"
        row = next(iter(doc["pools"].values()))
        assert {"free", "largest_block", "frag_ratio"} <= set(row)
        counts = metrics.topo_slice_counts()
        assert counts.get("placed", 0) + counts.get("defrag_placed", 0) >= 1

    def test_topology_off_is_bit_parity_with_unlisted_conf(self):
        spec = sg.gen_scenario("frag_pressure", 2)
        with sg._env({topo.TOPOLOGY_ENV: "0"}):
            off = sg.run_arm(spec, sequential=False, cycles_per_wave=2,
                             **ARM)
        control = sg.run_arm(dict(spec, conf="base"), sequential=False,
                             cycles_per_wave=2, **ARM)
        for key in ("bind_map", "pods", "deletes"):
            assert off[key] == control[key]

    def test_defrag_off_leaves_slice_pending(self):
        spec = sg.gen_scenario("frag_pressure", 0)
        with sg._env({topo.TOPO_DEFRAG_ENV: "0"}):
            arm = sg.run_arm(spec, sequential=False, cycles_per_wave=2,
                             **ARM)
        assert arm["quiesced"] and not arm["loop_deaths"]
        assert not [k for k in arm["bind_map"]
                    if k.startswith(f"{sg.NS}/slice0-")]

    def test_max_nodes_cap_degrades_not_dies_and_never_scatters(self):
        spec = sg.gen_scenario("frag_pressure", 0)
        before = metrics.topo_slice_counts().get("degraded", 0)
        with sg._env({topo.TOPO_MAX_NODES_ENV: "2"}):
            arm = sg.run_arm(spec, sequential=False, cycles_per_wave=2,
                             **ARM)
        assert arm["quiesced"] and not arm["loop_deaths"]
        assert metrics.topo_slice_counts().get("degraded", 0) > before
        assert not any(k.startswith(f"{sg.NS}/slice0-")
                       for k in arm["bind_map"])

    def test_departed_pool_gauges_zeroed(self):
        metrics.publish_topo_frag(
            {"pool-x": {"frag_ratio": 0.5, "largest_block": 3, "free": 6}})
        metrics.publish_topo_frag(
            {"pool-y": {"frag_ratio": 0.25, "largest_block": 6, "free": 8}})
        vals = {labels[0]: v
                for labels, v in metrics.topo_frag_ratio.values().items()}
        assert vals["pool-x"] == 0.0 and vals["pool-y"] == 0.25
        blocks = {labels[0]: v for labels, v in
                  metrics.topo_largest_free_block.values().items()}
        assert blocks["pool-x"] == 0.0 and blocks["pool-y"] == 6.0


@pytest.mark.parametrize("kind,seed", [("frag_pressure", 0),
                                       ("priority_inversion", 1)])
def test_batched_arm_equals_the_reference(kind, seed):
    """The same spec through the reference's batched arm (JAX, x64) and
    the port's (float64 keys on the CPU): the same binds, the same
    surviving pods, the same evictions."""
    spec = sg.gen_scenario(kind, seed)
    want = ref_sg.run_arm(spec, sequential=False)
    got = sg.run_arm(spec, sequential=False, **ARM)
    assert want["bind_map"], "vacuous scenario"
    for key in ("bind_map", "pods", "deletes", "violations", "loop_deaths",
                "quiesced"):
        assert got[key] == want[key], key


def test_cli_emit_and_no_card(capsysbinary):
    """``--emit`` writes the canonical spec; without a card the sweep
    refuses to start (exit 1) instead of running on the CPU."""
    assert sg.main(["--emit", "churn_storm:2"]) == 0
    out = capsysbinary.readouterr().out
    assert out == sg.scenario_bytes(sg.gen_scenario("churn_storm", 2)) + b"\n"
    if not torch.cuda.is_available():
        assert sg.main(["--seeds", "1"]) == 1
        assert b"CUDA" in capsysbinary.readouterr().err
