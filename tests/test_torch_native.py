"""The port's C host walk (kube_batch_tpu_torch/native) against its Python
loops and against the JAX package's C walk: the twin of
tests/test_native.py.

The session end state — job allocations and status indexes, node idle and
task maps, the binds — must be the same from the port's C pass, from the
port's Python loop (``KUBE_BATCH_TPU_NO_NATIVE=1``) and from the JAX
package's C pass, in both float modes.  Each arm runs in its own
interpreter: the knob is read when the native package is imported.  The
loader must build wherever these tests run (they need a C compiler and
``Python.h``): a build that fails is a failure of these tests, not a
skip.
"""

import dataclasses as dc
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import pytest

import kube_batch_tpu_torch.models.tensor_snapshot as ts
from kube_batch_tpu_torch import native
from kube_batch_tpu_torch.api import (Affinity, Container, ContainerPort,
                                      ObjectMeta, Pod, PodSpec, PodStatus,
                                      Toleration)

ROOT = Path(__file__).resolve().parents[1]

SESSION = r"""
import json, os, sys
pkg, arm = sys.argv[1], sys.argv[2]
no_native = arm == "1"
if no_native:
    os.environ["KUBE_BATCH_TPU_NO_NATIVE"] = "1"
if pkg == "jax":
    import jax
    jax.config.update("jax_platforms", "cpu")
    root = "kube_batch_tpu"
else:
    import torch
    torch.set_num_threads(1)
    root = "kube_batch_tpu_torch"
import importlib
native = importlib.import_module(root + ".native")
assert (native.apply_placements is None) == no_native
assert (native.clone_task_map is None) == no_native
ts = importlib.import_module(root + ".models.tensor_snapshot")
assert (ts._pod_static is native.pod_static) == (not no_native)
fw = importlib.import_module(root + ".framework")
syn = importlib.import_module(root + ".models.synthetic")
sched = importlib.import_module(root + ".scheduler")
acts = importlib.import_module(root + ".actions.factory")
plugs = importlib.import_module(root + ".plugins.factory")
tpu = importlib.import_module(root + ".actions.tpu_allocate")
plugs.register_default_plugins()
import contextlib
swap = contextlib.nullcontext()
if arm == "swap":
    # chip_smoke.py's in-process NO_NATIVE=1 arm.
    import chip_smoke
    swap = chip_smoke.native_arm(False)
swap.__enter__()
out = {}
for x64 in (True, False):
    if pkg == "jax":
        acts.register_default_actions()
        ctx = jax.enable_x64(x64)
        action = tpu.TpuAllocateAction()
    else:
        dtype = torch.float64 if x64 else torch.float32
        acts.register_default_actions(device="cpu", dtype=dtype)
        ctx = contextlib.nullcontext()
        action = tpu.TpuAllocateAction(device="cpu", dtype=dtype)
    with ctx:
        cache, binder = syn.make_synthetic_cache(600, 40, 30, 3,
                                                 n_signatures=4)
        _, tiers = sched.load_scheduler_conf(sched.DEFAULT_SCHEDULER_CONF)
        ssn = fw.open_session(cache, tiers)
        action.execute(ssn)
        jobs = {}
        for uid, job in ssn.jobs.items():
            jobs[uid] = dict(
                alloc=(job.allocated.milli_cpu, job.allocated.memory),
                index={st.name: sorted(b)
                       for st, b in job.task_status_index.items()})
        nodes = {}
        for name, node in ssn.nodes.items():
            nodes[name] = dict(
                idle=(node.idle.milli_cpu, node.idle.memory),
                tasks={k: (t.uid, t.status.name, t.node_name)
                       for k, t in sorted(node.tasks.items())})
        fw.close_session(ssn)
        statuses = [(pg.metadata.namespace, pg.metadata.name,
                     pg.status.phase, pg.status.running,
                     [(c.type, c.status, c.reason) for c in
                      pg.status.conditions])
                    for pg in cache.status_updater.pod_groups]
        out["x64" if x64 else "f32"] = dict(
            jobs=jobs, nodes=nodes, binds=list(binder.binds.items()),
            channel=list(binder.channel), statuses=statuses)
swap.__exit__(None, None, None)
print(json.dumps(out, sort_keys=True))
"""


def _session(pkg, arm):
    env = dict(os.environ)
    env.pop("KUBE_BATCH_TPU_NO_NATIVE", None)
    proc = subprocess.run([sys.executable, "-c", SESSION, pkg, arm],
                          cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def session_arms():
    return {arm: _session(*arm) for arm in
            (("torch", "0"), ("torch", "1"), ("jax", "0"), ("torch", "swap"))}


def test_the_walk_builds_and_loads_here():
    st = native.status()
    assert st["loaded"], st["error"]
    assert native.apply_placements is not None
    assert native.clone_task_map is not None
    assert Path(st["path"]) == native.library_path()
    assert Path(st["path"]).parent == native.BUILD_DIR


@pytest.mark.parametrize("mode", ["x64", "f32"])
def test_c_walk_equals_the_python_loop(session_arms, mode):
    c, py = session_arms["torch", "0"][mode], session_arms["torch", "1"][mode]
    assert c["binds"], "the session bound nothing"
    assert c == py


@pytest.mark.parametrize("mode", ["x64", "f32"])
def test_c_walk_equals_the_reference_c_walk(session_arms, mode):
    assert session_arms["torch", "0"][mode] == session_arms["jax", "0"][mode]


@pytest.mark.parametrize("mode", ["x64", "f32"])
def test_chip_smoke_control_arm_equals_the_no_native_import(session_arms,
                                                            mode):
    """chip_smoke.native_arm(False) swaps the bindings in one process;
    its sessions must end as a KUBE_BATCH_TPU_NO_NATIVE=1 import's."""
    assert session_arms["torch", "swap"][mode] == \
        session_arms["torch", "1"][mode]


# ---------------------------------------------------------------------
# pod_static


def _pods():
    def pod(uid, spec):
        return Pod(metadata=ObjectMeta(name=uid, namespace="n", uid=uid),
                   spec=spec, status=PodStatus(phase="Pending"))

    return [
        pod("plain", PodSpec(containers=[Container(requests={"cpu": "1"})])),
        pod("no-containers", PodSpec()),
        pod("zero-port", PodSpec(containers=[
            Container(requests={"cpu": "1"},
                      ports=[ContainerPort(host_port=0)])])),
        pod("host-port", PodSpec(containers=[
            Container(requests={"cpu": "1"},
                      ports=[ContainerPort(host_port=80,
                                           protocol="UDP")])])),
        pod("selector", PodSpec(node_selector={"zone": "z1", "a": "b"})),
        pod("tolerations", PodSpec(tolerations=[
            Toleration("k", "Equal", "v", "NoSchedule")])),
        pod("affinity", PodSpec(affinity=Affinity(
            required_node_terms=[{"x": "y"}],
            preferred_node_terms=[(3, {"p": "q"})]))),
        pod("empty-affinity", PodSpec(affinity=Affinity())),
    ]


@pytest.mark.parametrize("index", range(8))
def test_pod_static_matches_python_body(index):
    assert ts._pod_static is native.pod_static  # the C path is wired in
    pod = _pods()[index]
    got = ts._pod_static(pod)
    py = ts._pod_static_py(dc.replace(pod))
    assert got[1] == py[1]        # has_features
    assert got[2] == py[2]        # signature
    assert got[3] == py[3]        # port keys
    if not got[1]:
        assert got[2] is ts._EMPTY_SIG  # interned
    assert ts._pod_static(pod) is got   # a cache hit is the same tuple


def test_pod_static_equals_the_reference():
    from kube_batch_tpu import api as ref_api
    import kube_batch_tpu.models.tensor_snapshot as ref_ts
    for pod in _pods():
        ref_pod = ref_api.Pod(
            metadata=ref_api.ObjectMeta(name=pod.metadata.name,
                                        namespace="n", uid=pod.metadata.uid),
            spec=_ref_spec(ref_api, pod.spec),
            status=ref_api.PodStatus(phase="Pending"))
        assert ts._pod_static(pod)[1:] == ref_ts._pod_static(ref_pod)[1:], \
            pod.metadata.uid


def _ref_spec(ref_api, spec):
    return ref_api.PodSpec(
        containers=[ref_api.Container(
            requests=dict(c.requests),
            ports=[ref_api.ContainerPort(host_port=p.host_port,
                                         protocol=p.protocol)
                   for p in c.ports]) for c in spec.containers],
        node_selector=dict(spec.node_selector),
        tolerations=[ref_api.Toleration(t.key, t.operator, t.value,
                                        t.effect) for t in spec.tolerations],
        affinity=(None if spec.affinity is None else ref_api.Affinity(
            required_node_terms=list(spec.affinity.required_node_terms),
            preferred_node_terms=list(spec.affinity.preferred_node_terms))))


def test_pod_static_cache_invalidates_on_spec_replacement():
    pod = _pods()[0]
    first = ts._pod_static(pod)
    pod.spec = dc.replace(pod.spec, node_selector={"k": "v"})
    second = ts._pod_static(pod)
    assert second is not first
    assert second[1] is True and second[2][0] == (("k", "v"),)


# ---------------------------------------------------------------------
# the loader

STATUS = r"""
import json
from kube_batch_tpu_torch import native
print(json.dumps(native.status()))
"""

BUILD = r"""
import sys
from pathlib import Path
from kube_batch_tpu_torch import native
so = Path(sys.argv[1])
if not so.exists():
    assert native._build(so), native.status()["error"]
mod = native._import(so)
assert mod.apply_placements is not None and mod.pod_static is not None
print("loaded")
"""


def _python(code, *args, env=None, timeout=120):
    full = dict(os.environ)
    full.pop("KUBE_BATCH_TPU_NO_NATIVE", None)
    full.update(env or {})
    return subprocess.run([sys.executable, "-c", code, *args],
                          cwd=str(ROOT), env=full, capture_output=True,
                          text=True, timeout=timeout, check=False)


def test_a_second_loader_reuses_the_built_library():
    proc = _python(STATUS)
    assert proc.returncode == 0, proc.stderr[-2000:]
    st = json.loads(proc.stdout.strip().splitlines()[-1])
    assert st["loaded"] and st["path"] == native.status()["path"]
    assert st["build_seconds"] is None  # nothing was compiled


def test_no_native_yields_none():
    proc = _python(STATUS + "assert native.apply_placements is None\n"
                   "assert native.pod_static is None\n",
                   env={"KUBE_BATCH_TPU_NO_NATIVE": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    st = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not st["loaded"] and "NO_NATIVE" in st["error"]


def test_two_concurrent_first_builds_both_load(tmp_path):
    so = tmp_path / "race" / "_fastpath_torch_race.so"
    full = dict(os.environ)
    full.pop("KUBE_BATCH_TPU_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(so)],
                              cwd=str(ROOT), env=full,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err[-2000:]
        assert out.strip() == "loaded"
    assert [p.name for p in so.parent.iterdir()] == [so.name]  # no tmp left


def test_a_failed_build_is_loud(tmp_path, monkeypatch, caplog):
    bad = tmp_path / "fastpath.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_status", dict(native._status))
    with caplog.at_level(logging.WARNING,
                         logger="kube_batch_tpu_torch.native"):
        assert native._load() is None
    st = native.status()
    assert not st["loaded"] and "error" in st["error"]
    assert any("building" in r.message and "error" in r.message
               for r in caplog.records)
