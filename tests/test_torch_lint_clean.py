"""Tier-1 gate: the port's package has zero unsuppressed graftlint findings.

Twin of tests/test_lint_clean.py over ``kube_batch_tpu_torch/``.  The
rules (tools/graftlint) recognise some contract files by their path in
the reference package (memledger.py and metrics.py for
ledger-discipline, knobs.py for knob-registry, chaos/plan.py for
chaos-registry), so each port file is linted as if it stood at its
reference path: ``kube_batch_tpu_torch/x.py`` is seen as
``kube_batch_tpu/x.py``.  Every finding is reported under its real
path; none is filtered out, and every suppression carries a reason.
The cross-file checks against doc/CHAOS.md and tools/chaos_soak.py run
as in the reference's gate.
"""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tools.graftlint.core import (RULES, Context, SourceFile,  # noqa: E402
                                  iter_py_files, load_files, run_files)

PORT = str(ROOT / "kube_batch_tpu_torch")
AS_REFERENCE = str(ROOT / "kube_batch_tpu")
# The chaos sites of the wire (edge/client.py), catalogued in
# doc/CHAOS.md and required by tools/chaos_soak.py.
WIRE_SITES = {"watch.disconnect", "watch.stale", "watch.truncate",
              "ingest.handover_race"}


def _port_files():
    """The port's files, each at its reference path."""
    out = []
    for path in iter_py_files([PORT]):
        with open(path, encoding="utf-8") as f:
            text = f.read()
        out.append(SourceFile(AS_REFERENCE + path[len(PORT):], text))
    return out


def _real(path: str) -> str:
    return PORT + path[len(AS_REFERENCE):] if path.startswith(
        AS_REFERENCE) else path


@pytest.fixture(scope="module")
def lint():
    """One lint of the port, (findings, markers), read by each case
    that checks it: the run is the module's cost, and nothing mutates
    it."""
    return run_files(_port_files(), root=str(ROOT))


def _shown(items):
    return "\n".join(f"{_real(i.path)}:{i.line}: {str(i).split(': ', 1)[1]}"
                     for i in items)


def test_port_is_lint_clean(lint):
    findings, _markers = lint
    assert not findings, (
        "graftlint found unsuppressed contract violations in the port:\n"
        + _shown(findings))


def test_the_harnesses_are_linted(lint):
    """kube_batch_tpu_torch/tools/ is in the linted set (seen at
    kube_batch_tpu/tools/), clean, and its swallow markers reasoned."""
    files = {_real(sf.path) for sf in _port_files()}
    tools = {PORT + f"/tools/{name}.py" for name in (
        "__init__", "replay", "scenario_gen", "chaos_soak", "replica_soak")}
    assert tools <= files, sorted(tools - files)
    findings, markers = lint
    assert not [f for f in findings if _real(f.path) in tools]
    swallows = [m for m in markers if m.kind == "allow-swallow"
                and _real(m.path) in tools]
    assert len(swallows) >= 3 and all(m.reason for m in swallows)


def test_every_suppression_carries_a_reason(lint):
    _findings, markers = lint
    missing = [m for m in markers
               if m.kind in ("disable", "allow-swallow") and not m.reason]
    assert not missing, ("suppressions without a reason string:\n"
                         + _shown(missing))


def test_contract_annotations_cover_the_known_invariants(lint):
    """The annotations the reference's gate pins are present in the
    port too: losing one silently disables its rule for that file."""
    _findings, markers = lint
    by_kind = {}
    for m in markers:
        by_kind.setdefault(m.kind, []).append(m)

    def guarded_in(suffix):
        return [m for m in by_kind.get("guarded-by", [])
                if m.path.replace("\\", "/").endswith(suffix)]

    guarded_locks = {m.detail for m in by_kind.get("guarded-by", [])}
    assert {"mutex", "lock", "_lock", "_seen_lock", "_cache_lock",
            "_mutex"} <= guarded_locks, sorted(guarded_locks)
    assert len(guarded_in("models/victim_index.py")) >= 2
    frozen = {m.detail for m in by_kind.get("frozen-after", [])}
    assert {"ship", "scores", "occupancy", "stage"} <= frozen, sorted(frozen)
    stage_frozen = [m for m in by_kind.get("frozen-after", [])
                    if m.detail == "stage"
                    and m.path.replace("\\", "/").endswith(
                        "models/tensor_snapshot.py")]
    assert len(stage_frozen) >= 5
    assert len(guarded_in("cache/cache.py")) >= 12
    assert len(guarded_in("trace/recorder.py")) >= 2
    assert len(guarded_in("trace/lineage.py")) >= 4
    assert len(by_kind.get("allow-swallow", [])) >= 10


def test_registry_rules_are_wired(lint):
    """The registry rules exist and the port is clean under each."""
    rules = ("knob-registry", "metric-discipline", "chaos-registry",
             "thread-lifecycle", "ledger-discipline")
    assert set(rules) <= set(RULES), sorted(RULES)
    findings, _markers = lint
    for rule in rules:
        hits = [f for f in findings if f.rule == rule]
        assert not hits, _shown(hits)


def _collected(files):
    from tools.graftlint import knobs as knob_rule
    from tools.graftlint import ledger as ledger_rule
    from tools.graftlint import registry as registry_rule
    ctx = Context()
    ctx.root = str(ROOT)
    for sf in files:
        knob_rule.collect(sf, ctx)
        registry_rule.collect(sf, ctx)
        ledger_rule.collect(sf, ctx)
    return ctx


def test_registries_collected_equal_the_reference():
    """The cross-file registries see the port's contract files (an
    anchor-path regression would make a rule vacuously green) and hold
    what the reference's hold: the same knobs and ledgers, at least its
    metrics, and the same chaos sites, the wire's included."""
    port = _collected(_port_files())
    ref = _collected(load_files([AS_REFERENCE]))
    assert set(port.knob_decls) == set(ref.knob_decls)
    assert len(port.knob_decls) == 45
    assert set(ref.metric_decls) <= set(port.metric_decls)
    assert WIRE_SITES <= set(port.chaos_sites)
    assert set(port.chaos_sites) == set(ref.chaos_sites)
    assert set(port.ledger_catalogue) == set(ref.ledger_catalogue)
    assert len(port.ledger_catalogue) == 13
    marked = {name for _p, _l, _c, name in port.ledger_markers}
    # The wire's three ledgers (mirror, pending, baseline) are marked by
    # edge/client.py's classes; compile_cache's store is a module-level
    # set.
    assert {"mirror", "pending", "baseline"} <= marked
    assert set(port.ledger_catalogue) - marked == {"compile_cache"}
