"""The port's last three host tools (kube_batch_tpu_torch/tools/
fuzz_parity, fuzz_incremental, trace_demo) on the CPU at small seeds,
against the repo's tools/ of the same names driving the JAX package.

- fuzz_parity: the host allocate oracle equals tpu-allocate per seed in
  float64 and float32 keys, and the port's bind maps equal the
  reference's on the same seeds (float64, as the reference runs x64);
- fuzz_incremental: the long-lived cache equals the fresh rebuild cycle
  by cycle, and every cycle's binds and evictions equal the reference's;
- trace_demo: a trace is written with the session's phases, and the
  stuck gang's why-pending verdict equals the reference's.
Each tool's CLI exits 1 without a card unless ``--device cpu``.
"""

import json

import pytest
import torch

from kube_batch_tpu_torch.tools import fuzz_incremental, fuzz_parity
from kube_batch_tpu_torch.tools import trace_demo
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

torch.set_num_threads(1)

PARITY_SEEDS = [300, 301, 302, 303]


@pytest.mark.parametrize("seed", PARITY_SEEDS)
def test_fuzz_parity_seed_matches_the_reference(seed, monkeypatch):
    import tests.test_tpu_parity as jax_parity
    from kube_batch_tpu.actions.factory import \
        register_default_actions as jax_register_actions
    from kube_batch_tpu.plugins.factory import \
        register_default_plugins as jax_register_plugins
    from tools import fuzz_parity as jax_fuzz

    got = {}
    real = jax_parity.run_both_mutated

    def capture(mutate, spec):
        got["host"] = real(mutate, spec)
        return got["host"]

    monkeypatch.setattr(jax_parity, "run_both_mutated", capture)
    jax_register_actions()
    jax_register_plugins()
    jax_fuzz.run_seed(seed)
    port64 = fuzz_parity.run_seed(seed, "cpu", torch.float64)
    assert port64 == dict(got["host"])
    port32 = fuzz_parity.run_seed(seed, "cpu", torch.float32)
    assert port32 == port64


def _captured_sessions(module, monkeypatch):
    out = []
    real = module.run_session

    def capture(*args, **kw):
        binds, evicts = real(*args, **kw)
        out.append((sorted(binds.items()), list(evicts)))
        return binds, evicts

    monkeypatch.setattr(module, "run_session", capture)
    return out


def test_fuzz_incremental_cycles_match_the_reference(monkeypatch):
    from kube_batch_tpu.actions.factory import \
        register_default_actions as jax_register_actions
    from kube_batch_tpu.plugins.factory import \
        register_default_plugins as jax_register_plugins
    from kube_batch_tpu_torch.actions.factory import register_default_actions
    from kube_batch_tpu_torch.plugins.factory import register_default_plugins
    from tools import fuzz_incremental as jax_fuzz

    jax_register_actions()
    jax_register_plugins()
    ref = _captured_sessions(jax_fuzz, monkeypatch)
    for seed in (7000, 7001):
        jax_fuzz.run_seed(seed, 3)
    register_default_actions(device="cpu", dtype=torch.float64)
    register_default_plugins()
    port = _captured_sessions(fuzz_incremental, monkeypatch)
    for seed in (7000, 7001):
        fuzz_incremental.run_seed(seed, 3)
    assert len(port) == len(ref) == 12  # 2 seeds x 3 cycles x (A, B)
    assert [(b, [str(e) for e in ev]) for b, ev in port] == \
        [(b, [str(e) for e in ev]) for b, ev in ref]


def test_trace_demo_writes_the_session_and_the_verdict(tmp_path,
                                                       monkeypatch, capsys):
    import sys

    from tools import trace_demo as jax_demo

    out = tmp_path / "port.json"
    assert trace_demo.main([str(out), "--device", "cpu"]) == 0
    doc = json.loads(out.read_text())
    assert doc["traceEvents"]
    port_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["trace_demo",
                                      str(tmp_path / "ref.json")])
    assert jax_demo.main() == 0
    ref_lines = capsys.readouterr().out.splitlines()

    def verdict(lines):
        why = json.loads(next(line for line in lines
                              if line.startswith("why demo-stuck:"))
                         .split(":", 1)[1])
        return {k: why[k] for k in ("job", "reason", "message")}

    def phases(lines):
        return sorted(json.loads(next(
            line for line in lines if line.startswith("phases:"))
            .split(":", 1)[1]))

    assert verdict(port_lines) == verdict(ref_lines)
    assert phases(port_lines) == phases(ref_lines)


@pytest.mark.parametrize("tool", [fuzz_parity, fuzz_incremental,
                                  trace_demo])
def test_tools_refuse_the_cpu_unless_asked(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    assert tool.main([]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
