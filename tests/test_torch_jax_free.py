"""Gate: the PyTorch port imports no jax and nothing of kube_batch_tpu.

tests/conftest.py imports jax into this process, so the check runs in a
fresh interpreter.  A ``sys.meta_path`` hook there refuses ``jax``,
``jaxlib`` and ``kube_batch_tpu`` (and their submodules, but not
``kube_batch_tpu_torch``); under it the subprocess imports every module of
the port, runs one small ship -> dispatch -> fetch on the CPU, runs three
whole ``open_session -> tpu-allocate -> close_session`` sessions on one
cache with churn between them on the CPU (the third a micro session on
the candidate route), loads the default conf whole, runs one session of
the shipped four-action conf (reclaim, tpu-allocate, backfill, preempt) on
a small churn storm that must evict and bind, and checks that
``TpuAllocateAction()`` without a device raises when there is no CUDA.
"""

import pkgutil
import subprocess
import sys
from pathlib import Path

import kube_batch_tpu_torch

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, sys

BLOCKED = ("jax", "jaxlib", "kube_batch_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
for name in sys.argv[1:]:
    importlib.import_module(name)

import torch
torch.set_num_threads(1)
from kube_batch_tpu_torch.models.shipping import resident_shipper
from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
from kube_batch_tpu_torch.ops.solver import dispatch_solve, fetch_solve

inp, cfg = make_synthetic_inputs(120, 16, 8, 2, seed=4, dtype=torch.float32,
                                 device="cpu")
owner = type("Owner", (), {})()
shipped = resident_shipper(owner, device="cpu").ship(inp, cfg)
assignment, kind, order, ordered = fetch_solve(dispatch_solve(shipped, cfg))
assert ordered.size > 0 and (kind > 0).sum() == ordered.size

# One whole session through the port's entry path on the CPU.
from kube_batch_tpu_torch.actions.factory import register_default_actions
from kube_batch_tpu_torch.actions.tpu_allocate import TpuAllocateAction
from kube_batch_tpu_torch.framework import close_session, open_session
from kube_batch_tpu_torch.models import incremental
from kube_batch_tpu_torch.models.synthetic import (SteadyChurn,
                                                   make_synthetic_cache)
from kube_batch_tpu_torch.plugins.factory import register_default_plugins
from kube_batch_tpu_torch.scheduler import (DEFAULT_SCHEDULER_CONF,
                                            parse_scheduler_conf)

register_default_plugins()
register_default_actions(device="cpu")
cache, binder = make_synthetic_cache(300, 40, 12, 3)
churn = SteadyChurn(cache, binder, 300, 3, churn=0.02)
tiers = parse_scheduler_conf(DEFAULT_SCHEDULER_CONF).tiers
action = TpuAllocateAction(device="cpu", dtype=torch.float32)
for session in range(3):
    if session:
        churn.inject(session)
    ssn = open_session(cache, tiers)
    try:
        action.execute(ssn)
    finally:
        close_session(ssn)
    assert action.last.route == "torch" and len(binder.binds) > 0
state = incremental.state_for(cache)
assert state.last_kind == "micro", (state.last_kind, state.last_reason)
assert action.last.candidates is not None
assert action.last.candidates.count < len(cache.nodes)
# The default conf loads whole, and one session of the shipped four-action
# conf runs on a small churn storm (two empty nodes added, so tpu-allocate
# has room to bind) with the batched eviction engine on the CPU.
from kube_batch_tpu_torch.api import Node, NodeSpec, NodeStatus, ObjectMeta
from kube_batch_tpu_torch.models.synthetic import make_churn_cache
from kube_batch_tpu_torch.scheduler import load_scheduler_conf

names = [a.name() for a in load_scheduler_conf(DEFAULT_SCHEDULER_CONF)[0]]
assert names == ["tpu-allocate", "backfill"], names
with open("config/kube-batch-conf.yaml") as fh:
    conf = fh.read().replace('"reclaim, allocate, backfill, preempt"',
                             '"reclaim, tpu-allocate, backfill, preempt"')
actions, storm_tiers = load_scheduler_conf(conf)
names = [a.name() for a in actions]
assert names == ["reclaim", "tpu-allocate", "backfill", "preempt"], names
import os
os.environ["KUBE_BATCH_TPU_SCAN_MIN_NODES"] = "0"   # the scanner at 42 nodes
storm, storm_binder = make_churn_cache(300, 40, 12, 3)
for i in range(2):
    alloc = {"cpu": "32", "memory": "64Gi", "pods": 110}
    storm.add_node(Node(metadata=ObjectMeta(name=f"spare{i}", uid=f"spare{i}"),
                        spec=NodeSpec(),
                        status=NodeStatus(allocatable=dict(alloc),
                                          capacity=dict(alloc))))
ssn = open_session(storm, storm_tiers)
try:
    for a in actions:
        a.execute(ssn)
    scanner = ssn._shared_scanner
finally:
    close_session(ssn)
assert storm.evictor.evicts and storm_binder.binds
assert scanner is not None and scanner.stats["batch_dispatches"] == 1

if not torch.cuda.is_available():
    try:
        TpuAllocateAction()
    except RuntimeError as exc:
        assert "device='cpu'" in str(exc)
    else:
        raise AssertionError("TpuAllocateAction() ran without CUDA")

leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print("placed", ordered.size, "bound", len(binder.binds), "evicted",
      len(storm.evictor.evicts), "storm bound", len(storm_binder.binds))
"""


def port_modules():
    pkg = kube_batch_tpu_torch
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        names.append(info.name)
    return names


def test_port_runs_with_jax_and_the_reference_blocked():
    modules = port_modules()
    assert {"kube_batch_tpu_torch.ops.cuda_solver",
            "kube_batch_tpu_torch.models.shipping",
            "kube_batch_tpu_torch.knobs",
            "kube_batch_tpu_torch.models.tensor_snapshot",
            "kube_batch_tpu_torch.actions.tpu_allocate",
            "kube_batch_tpu_torch.cache.cache",
            "kube_batch_tpu_torch.framework.session",
            "kube_batch_tpu_torch.plugins.factory",
            "kube_batch_tpu_torch.scheduler",
            "kube_batch_tpu_torch.models.scanner",
            "kube_batch_tpu_torch.models.victim_index",
            "kube_batch_tpu_torch.ops.scan",
            "kube_batch_tpu_torch.ops.evict_solver",
            "kube_batch_tpu_torch.chaos.breaker",
            "kube_batch_tpu_torch.actions.preempt",
            "kube_batch_tpu_torch.actions.reclaim",
            "kube_batch_tpu_torch.actions.backfill"} <= set(modules)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, *modules],
                          cwd=str(ROOT), capture_output=True, text=True,
                          timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("placed ")


def test_the_hook_does_block_the_reference():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, "kube_batch_tpu.knobs"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300,
        check=False)
    assert proc.returncode != 0
    assert "blocked import of kube_batch_tpu" in proc.stderr
