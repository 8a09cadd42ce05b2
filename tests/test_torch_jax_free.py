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
a small churn storm that must evict and bind, runs one quiet session of
that conf under the fused one-dispatch program (one fused dispatch, its
allocate leg served, binds), checks that the C host walk
loaded and the session's apply runs it, runs the topology conf on a 4x4x2
torus until the slice binds, runs one global ``Scheduler.cycle()`` and one
tenancy cycle of the concurrent shard pipeline over two dirty shards (both
must bind), runs one session that degrades to the host path under
``solve.device_error`` and binds, checks that ``TpuAllocateAction()``
without a device raises
when there is no CUDA, and that no shared object of the reference was
loaded.
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

# One quiet session of the same conf under the fused one-dispatch
# program, the ladder stamped as the Scheduler stamps it: one fused
# dispatch, its alloc leg served to tpu-allocate, and binds.
from kube_batch_tpu_torch.metrics.metrics import (fused_leg_counts,
                                                  session_dispatch_counts)
os.environ["KUBE_BATCH_TPU_FUSED"] = "1"
quiet, quiet_binder = make_synthetic_cache(300, 32, 12, 2)
d0, l0 = session_dispatch_counts(), fused_leg_counts()
ssn = open_session(quiet, storm_tiers)
ssn._conf_actions = tuple(names)
try:
    for a in actions:
        a.execute(ssn)
finally:
    close_session(ssn)
d1, l1 = session_dispatch_counts(), fused_leg_counts()
disp = {k: d1[k] - d0.get(k, 0) for k in d1 if d1[k] != d0.get(k, 0)}
assert disp == {"fused": 1}, disp
assert l1.get("solve/served", 0) - l0.get("solve/served", 0) == 1
assert len(quiet_binder.binds) == 300, len(quiet_binder.binds)

# The C host walk is loaded and the session's apply runs it.
from kube_batch_tpu_torch import native
from kube_batch_tpu_torch.framework import session as session_mod
assert native.status()["loaded"], native.status()
assert session_mod.native_apply is native.apply_placements is not None

# One TOPO_CONF run on a 4x4x2 topo cache: cycle 1 evicts a contiguous
# box, the victims are echoed as deletions, cycle 2 binds the slice.
from kube_batch_tpu_torch.api import pod_key
from kube_batch_tpu_torch.models.synthetic import make_topo_cache
topo_conf = '''
actions: "topo-allocate, tpu-allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: topology
'''
topo, topo_binder = make_topo_cache()
topo_actions, topo_tiers = load_scheduler_conf(topo_conf)
pods = {pod_key(t.pod): t.pod for job in topo.jobs.values()
        for t in job.tasks.values()}
for cycle in range(2):
    ssn = open_session(topo, topo_tiers)
    try:
        for a in topo_actions:
            a.execute(ssn)
    finally:
        close_session(ssn)
    if cycle == 0:
        assert topo.evictor.evicts
        for key in topo.evictor.evicts:
            topo.delete_pod(pods.pop(key))
slice_binds = [k for k in topo_binder.binds if "slice0" in k]
assert len(slice_binds) == 8, topo_binder.binds

# The Scheduler loop: one global cycle, then one tenancy cycle with the
# concurrent shard pipeline over two dirty shards; both must bind.
from kube_batch_tpu_torch.metrics.metrics import shard_pipeline_counts
from kube_batch_tpu_torch.scheduler import Scheduler
loop_cache, loop_binder = make_synthetic_cache(300, 40, 12, 2)
sched = Scheduler(loop_cache, schedule_period=3600, device="cpu")
assert sched.tenancy is None
assert sched.cycle() and loop_binder.binds
os.environ["KUBE_BATCH_TPU_TENANCY"] = "2"
os.environ["KUBE_BATCH_TPU_SHARD_MAP"] = "q0:0|q1:1"
os.environ["KUBE_BATCH_TPU_CONCURRENT_SHARDS"] = "1"
shard_cache, shard_binder = make_synthetic_cache(300, 40, 12, 2)
sched = Scheduler(shard_cache, schedule_period=3600, device="cpu")
assert sched.tenancy is not None and sched.tenancy.pipeline is not None
begun = shard_pipeline_counts().get("begun", 0)
assert sched.cycle() and shard_binder.binds
assert shard_pipeline_counts().get("begun", 0) - begun == 2
bound_queues = {job.queue for job in shard_cache.jobs.values()
                for t in job.tasks.values() if t.node_name}
assert bound_queues == {"q0", "q1"}, bound_queues
for key in ("KUBE_BATCH_TPU_TENANCY", "KUBE_BATCH_TPU_SHARD_MAP",
            "KUBE_BATCH_TPU_CONCURRENT_SHARDS"):
    del os.environ[key]

# One session that degrades: solve.device_error at rate 1, the host
# allocate action binds, the failure is counted and the breaker fed.
from kube_batch_tpu_torch.chaos import plan as chaos_plan
from kube_batch_tpu_torch.chaos.breaker import device_breaker
from kube_batch_tpu_torch.metrics.metrics import device_solve_failures
degraded, degraded_binder = make_synthetic_cache(120, 16, 6, 2)
failures = device_solve_failures.value("solve")
plan = chaos_plan.install(chaos_plan.FaultPlan(
    seed=1, rate=1.0, sites=("solve.device_error",)))
ssn = open_session(degraded, tiers)
try:
    TpuAllocateAction(device="cpu").execute(ssn)
finally:
    close_session(ssn)
    chaos_plan.disable()
assert plan.injected().get("solve.device_error", 0) == 1
assert device_solve_failures.value("solve") == failures + 1
assert degraded_binder.binds and device_breaker()._failures == 1
device_breaker().reset()

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
# Nor a shared object of the reference (its C walk is _fastpath).
with open("/proc/self/maps") as fh:
    maps = fh.read()
assert "_fastpath." not in maps and "/kube_batch_tpu/" not in maps
assert "_fastpath" not in sys.modules
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
            "kube_batch_tpu_torch.actions.backfill",
            "kube_batch_tpu_torch.native",
            "kube_batch_tpu_torch.models.topology",
            "kube_batch_tpu_torch.ops.topo_solver",
            "kube_batch_tpu_torch.plugins.topology",
            "kube_batch_tpu_torch.actions.topo_allocate",
            "kube_batch_tpu_torch.cli.leader_election",
            "kube_batch_tpu_torch.cache.cluster",
            "kube_batch_tpu_torch.tenancy.engine",
            "kube_batch_tpu_torch.tenancy.pipeline",
            "kube_batch_tpu_torch.tenancy.leases",
            "kube_batch_tpu_torch.tenancy.view",
            "kube_batch_tpu_torch.tenancy.footprint"} <= set(modules)
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
