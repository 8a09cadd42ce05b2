"""The port's chaos soak (kube_batch_tpu_torch/tools/chaos_soak.py) against
the reference's (tools/chaos_soak.py), on the CPU.

* the twin of tests/test_chaos.py's ``TestSoakSmoke``: the single-seed
  smoke converges with faults fired, and its oracle and chaos arms equal
  the reference's (the same maps, deletes, injections and cycles);
* the card's rule forced on the CPU (``host_path_allowed`` answering as
  for a CUDA device, as tests/test_torch_card_failure.py does): a failed
  device stage raises and an open breaker refuses the device path, so
  the drain waits the breaker's cooldown out and its half-open probe
  closes it; the soak then converges with no host path run.  Under the
  reference's drain (no wait, the configured 30 s cooldown) the same
  soak fails: every drain cycle meets the open breaker, and the
  fault-free scheduler from the faults' state does not reach its map;
* the soak's divergence from its oracle, seed by seed: at the seeds
  below 37 where the card's rule fires ``commit.flush_error`` and
  diverges (8, 13, 20, 22, 36), the reference's own soak diverges too
  and the port without the card's rule equals it; at those and at the
  card's rule's only other divergences in seeds 1-60 (24, 58), the
  fault-free scheduler started on the truth each fault phase left
  reaches the chaos arm's maps (``fault_free_from``): the faults changed
  the path, the drain recovered;
* over the edge the drain reads the lazy mirror flushed, so it does not
  sit out its 15 s mirror wait;
* the soak's required sites against the reference's lists and against
  the port's own injection sites (graftlint's registry of
  ``plan.fire`` calls);
* ``CircuitBreaker.cooldown_left`` and the arm's breaker scope.
"""

import pytest
import torch

import kube_batch_tpu_torch.chaos.breaker as brk
from kube_batch_tpu_torch.actions import allocate
from kube_batch_tpu_torch.chaos import plan as chaos_plan
from kube_batch_tpu_torch.tools import chaos_soak as soak
from tests.test_torch_utils import reference_gc_guard  # noqa: F401
from tools import chaos_soak as ref_soak

SMOKE = dict(nodes=6, cycles=6, rate=0.3, budget=30, require_all_sites=False)
# The reference's chaos-smoke shape (Makefile ``chaos-smoke``).
CHAOS_SMOKE = dict(nodes=8, cycles=10, require_all_sites=False)


@pytest.fixture(autouse=True)
def _clean():
    from kube_batch_tpu.chaos import breaker as ref_brk
    from kube_batch_tpu.chaos import plan as ref_plan

    def clean():
        for plan, breaker in ((chaos_plan, brk), (ref_plan, ref_brk)):
            plan.disable()
            breaker.device_breaker().reset()
    clean()
    yield
    clean()


def _host_runs(monkeypatch):
    """Count the host allocate action's runs (the card never runs it)."""
    runs = []
    real = allocate.AllocateAction.execute
    monkeypatch.setattr(allocate.AllocateAction, "execute",
                        lambda self, ssn: (runs.append(1), real(self, ssn))[1])
    return runs


def test_soak_smoke_converges_and_equals_the_reference():
    got = soak.run_soak([11], device="cpu", dtype=torch.float64, **SMOKE)
    assert got["ok"], got["problems"]
    seed = got["seeds"][0]
    assert seed["injected_total"] > 0  # the storm actually fired
    assert seed["loop_deaths"] == seed["double_binds"] == 0
    assert seed["lost_evictions"] == 0
    want = ref_soak.run_soak([11], **SMOKE)
    assert want["ok"] and got["oracle"]["binds"] == want["oracle"]["binds"]
    for key in ("injected", "injected_total", "failed_cycles",
                "drain_cycles"):
        assert seed[key] == want["seeds"][0][key], key
    assert got["sites_fired"] == want["sites_fired"]


def test_oracle_arm_equals_the_reference():
    got = soak.run_arm((None, None), nodes=6, cycles=6, device="cpu",
                       dtype=torch.float64)
    want = ref_soak.run_arm((None, None), nodes=6, cycles=6)
    for key in ("phase_a_map", "bind_map", "pods", "deletes", "violations",
                "loop_deaths", "failed_cycles", "drain_cycles"):
        assert got[key] == want[key], key
    assert got["deletes"] and got["breaker"]["trips"] == 0


def test_card_rule_drain_waits_the_breaker_out(monkeypatch):
    monkeypatch.setattr(brk, "host_path_allowed", lambda device: False)
    host = _host_runs(monkeypatch)
    got = soak.run_soak([1], device="cpu", **CHAOS_SMOKE)
    assert got["ok"], got["problems"]
    arm = got["seeds"][0]
    assert arm["failed_cycles"] > 0 and arm["breaker"]["trips"] >= 1
    assert arm["breaker"]["probes"] >= 1 and arm["breaker"]["waited_s"] > 0
    assert arm["drain_failed_cycles"] == 0
    assert host == []
    assert brk.device_breaker().state() == "closed"
    assert brk.device_breaker().cooldown == \
        brk.knobs.BREAKER_COOLDOWN_S.value()


def test_card_rule_fails_under_the_reference_drain(monkeypatch):
    """The parent's rule: the drain neither waits nor shortens the
    cooldown, so after a trip every drain cycle meets the open breaker,
    the state looks stable, and the map is not the oracle's."""
    monkeypatch.setattr(brk, "host_path_allowed", lambda device: False)
    monkeypatch.setattr(soak, "wait_breaker", lambda br: 0.0)
    monkeypatch.setattr(soak, "BREAKER_COOLDOWN_S",
                        brk.knobs.BREAKER_COOLDOWN_S.value())
    got = soak.run_soak([1], device="cpu", **CHAOS_SMOKE)
    assert not got["ok"]
    assert any("diverged" in p or "never quiesced" in p
               for p in got["problems"]), got["problems"]
    assert got["seeds"][0]["path_problems"]


@pytest.mark.parametrize("seed,reference_diverges", [
    (8, True), (13, True), (20, True), (22, True), (36, True),
    (24, False), (58, False)])
def test_card_rule_divergence_is_the_path_the_faults_took(
        monkeypatch, seed, reference_diverges):
    want = ref_soak.run_soak([seed], **CHAOS_SMOKE)
    assert want["ok"] != reference_diverges
    if reference_diverges:
        host_rule = soak.run_soak([seed], device="cpu", **CHAOS_SMOKE)
        assert host_rule["problems"] == want["problems"]
    monkeypatch.setattr(brk, "host_path_allowed", lambda device: False)
    got = soak.run_soak([seed], device="cpu", **CHAOS_SMOKE)
    (arm,) = got["seeds"]
    assert arm["loop_deaths"] == arm["double_binds"] == 0
    assert [e for e in arm["errors"] if e not in arm["diverged"]] == []
    if arm["diverged"]:
        assert arm["path_problems"] == []


def test_edge_drain_reads_the_lazy_mirror_flushed():
    """A fault cycle's bind echoes wait in the lazy mirror; unflushed,
    the drain's first mirror check would time out after 15 s."""
    got = soak.run_soak([1], device="cpu", edge=True, **SMOKE)
    (arm,) = got["seeds"]
    assert got["ok"], got["problems"]
    assert arm["injected_total"] > 0 and arm["mirror_wait_s"] < 5.0


def test_required_sites_equal_the_reference_and_fire_in_the_port():
    from tests.test_torch_lint_clean import _collected, _port_files
    assert soak.FAKE_SITES == ref_soak.FAKE_SITES
    assert soak.EDGE_SITES == ref_soak.EDGE_SITES
    sites = set(_collected(_port_files()).chaos_sites)
    assert set(soak.EDGE_SITES) <= sites, set(soak.EDGE_SITES) - sites


def test_cooldown_left_and_the_arm_breaker():
    now = [100.0]
    br = brk.CircuitBreaker("t", threshold=1, cooldown=2.0,
                            clock=lambda: now[0])
    assert br.cooldown_left() == 0.0
    br.failure()
    assert br.state() == "open" and br.cooldown_left() == 2.0
    now[0] += 0.5
    assert br.cooldown_left() == 1.5
    now[0] += 2.0
    assert br.cooldown_left() == 0.0 and br.allow()
    assert br.state() == "half-open" and br.cooldown_left() == 0.0

    real = brk.device_breaker()
    saved = real.cooldown
    with soak.arm_breaker(0.25) as armed:
        assert armed is real and armed.cooldown == 0.25
        armed.failure(), armed.failure(), armed.failure()
        assert armed.state() == "open"
        assert 0.0 < soak.wait_breaker(armed) <= 0.25
        assert armed.allow() and armed.state() == "half-open"
    assert real.cooldown == saved and real.state() == "closed"


def test_cli_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    assert soak.main(["--seeds", "1"]) == 1
    assert "CUDA" in capsys.readouterr().err
