"""Sessions at the tensorizer's limits, the JAX package against the port,
on the CPU.

A session the tensorizer cannot stage — more than 64 host-port keys or
32 affinity selectors, a fractional pod-affinity weight, an int32
overflow, a conf it does not express (``snap.needs_fallback``) — runs
the host path in both packages: the reference's expressiveness boundary,
kept on the card too, so the binds are the reference's.  The port also
signals each such session, where the reference gives none:
``kube_batch_tensorize_limit_total{reason, site}``, a ``degraded`` note
on the session trace and a warning, at both call sites (tpu-allocate and
the eviction scanner).
"""

import logging

import pytest
import torch

import kube_batch_tpu_torch.chaos.breaker as brk
from kube_batch_tpu_torch.metrics import metrics
from kube_batch_tpu_torch.trace import flight_recorder
from tests.test_torch_e2e import CONF_TPU, Harness, mk_pod
from tests.test_torch_utils import Loop, Pkg, loop_twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

# One past the tensorizer's 64 host-port keys.
PORT_KEYS = 65


def _port_cluster(lp):
    """20 nodes of 4 cpu, and one gang-less job of PORT_KEYS pods, each
    asking for its own host port."""
    h = Harness(lp, conf=CONF_TPU)
    h.add_nodes(20)
    h.create_group("ports", 1)
    for i in range(PORT_KEYS):
        h.cluster.create_pod(mk_pod(
            lp, f"ports-{i}", "ports",
            ports=[lp.objects.ContainerPort(host_port=20000 + i)]))
    h.create_job("plain", 3, 3, queue="q2")
    return h


def _limits():
    return metrics.tensorize_limit_counts()


def _delta(before):
    return {k: v - before.get(k, 0) for k, v in _limits().items()
            if v != before.get(k, 0)}


def test_host_port_limit_is_signalled_and_binds_as_the_reference(caplog):
    """65 distinct host-port keys: tpu-allocate runs the host allocate
    action in both packages with the same binds; the port counts the
    session under its reason, notes it on the trace and logs it once."""
    seen = {}

    def body(lp):
        h = _port_cluster(lp)
        before = _limits() if lp.pkg == "torch" else None
        with caplog.at_level(logging.WARNING):
            h.cycle()
        if lp.pkg == "torch":
            seen["delta"] = _delta(before)
            tr = flight_recorder.latest()
            seen["notes"] = list(tr.meta.get("degraded", []))
            seen["warnings"] = [
                r.getMessage() for r in caplog.records
                if r.name == "kube_batch_tpu_torch.models.tensor_snapshot"]
        return h.outcome()

    outcome = loop_twin(body)
    assert len(outcome[0]) == PORT_KEYS + 3  # every pod bound
    assert seen["delta"] == {"host_ports/tpu-allocate": 1}
    assert seen["notes"] == [
        f"tensorizer limit ({PORT_KEYS} distinct host-port keys); "
        "tpu-allocate ran the host allocate action"]
    assert len(seen["warnings"]) == 1
    assert f"{PORT_KEYS} distinct host-port keys" in seen["warnings"][0]


def test_the_card_keeps_the_host_run(monkeypatch):
    """Under the card's rule (``host_path_allowed`` False, as on a CUDA
    device) the session at the limit still runs the host path and binds
    what the CPU binds: a limit is not a device failure, nothing
    raises and the breaker is not fed."""
    cpu = _port_cluster(Loop("torch"))
    cpu.cycle()
    monkeypatch.setattr(brk, "host_path_allowed", lambda device: False)
    brk.device_breaker().reset()
    failures = dict(metrics.device_solve_failures.values())
    card = _port_cluster(Loop("torch"))
    before = _limits()
    card.cycle()
    assert card.bound() == cpu.bound()
    assert _delta(before) == {"host_ports/tpu-allocate": 1}
    assert dict(metrics.device_solve_failures.values()) == failures
    assert brk.device_breaker().closed()


def test_scanner_signals_at_the_limit(monkeypatch):
    """The eviction scanner's tensorize at the limit returns no scanner
    in both packages (the eviction actions take their host walk); the
    port counts it under the scanner site."""
    monkeypatch.setenv("KUBE_BATCH_TPU_SCAN_MIN_NODES", "0")
    out = {}
    for pkg in ("jax", "torch"):
        p = Pkg(pkg)
        h = _port_cluster(Loop(pkg))
        ssn = p.m.framework.open_session(h.cache, p.tiers())
        try:
            before = _limits()
            out[pkg] = p.scanner(ssn)
            if pkg == "torch":
                delta = _delta(before)
        finally:
            p.m.framework.close_session(ssn)
    assert out == {"jax": None, "torch": None}
    assert delta == {"host_ports/scanner": 1}


CONF_FRACTIONAL = CONF_TPU.replace("  - name: nodeorder\n", """\
  - name: nodeorder
    arguments:
      leastrequested.weight: 1.5
""")


def _limit_cluster(lp, limit):
    """A cluster one session of which is past ``limit``."""
    if limit == "host_ports":
        return _port_cluster(lp)
    h = Harness(lp, conf=CONF_FRACTIONAL if limit == "conf" else CONF_TPU)
    h.add_nodes(4)
    if limit == "int32_overflow":
        h.create_job("huge", 1, 1, cpu="3000000")
    h.create_job("plain", 3, 3, queue="q2")
    return h


@pytest.mark.parametrize("limit", ["host_ports", "int32_overflow", "conf"])
def test_limit_reasons_are_the_reference_reasons(limit):
    """The port stages the same ``fallback_reason`` as the reference at
    each limit, and labels it where the limit is reached
    (``snap.limit``): the counter's label names the reference's limit."""
    reasons = {}
    for pkg in ("jax", "torch"):
        p = Pkg(pkg)
        h = _limit_cluster(Loop(pkg), limit)
        ssn = p.m.framework.open_session(h.cache, p.tiers(
            CONF_FRACTIONAL if limit == "conf" else CONF_TPU))
        try:
            with p.ctx():
                snap = (p.m.tensorize.tensorize_session(ssn)
                        if pkg == "jax" else
                        p.m.tensorize.tensorize_session(ssn, torch.float64))
            reasons[pkg] = snap.fallback_reason
        finally:
            p.m.framework.close_session(ssn)
        if pkg == "torch":
            assert snap.limit == limit
    assert reasons["torch"] == reasons["jax"] != ""
