"""Object builders and the session parity harness for the port's tests.

The twins of tests/test_utils.py (``build_node``, ``build_pod``,
``build_resource_list``) and of tests/test_tpu_parity.py's
``build_cache(spec)``, building kube_batch_tpu_torch objects from the same
spec tuples.  A spec — plain tuples and numbers, drawn from a seed — is
how a cluster crosses from the JAX package to the port: each package
builds its own objects from it, and no port module reads a JAX object.

``run_session`` drives one package's ``open_session -> tpu-allocate ->
close_session`` on a spec and returns what the tests compare: the binds in
order, the pod-group status writes, the pod conditions, and the tensorized
SolverInputs and SolverConfig.
"""

import contextlib
import copy
import dataclasses
import gc
import os
import types

import jax
import numpy as np
import pytest
import torch

import kube_batch_tpu_torch.actions.factory as torch_actions
import kube_batch_tpu_torch.api as torch_api
import kube_batch_tpu_torch.api.objects as torch_objects
import kube_batch_tpu_torch.api.queue_info as torch_queue_info
import kube_batch_tpu_torch.apis.scheduling.v1alpha1 as torch_v1alpha1
import kube_batch_tpu_torch.cache as torch_cache
import kube_batch_tpu_torch.framework as torch_framework
import kube_batch_tpu_torch.models.tensor_snapshot as torch_tensorize
import kube_batch_tpu_torch.plugins.factory as torch_plugins
import kube_batch_tpu_torch.scheduler as torch_scheduler
from kube_batch_tpu_torch.actions.tpu_allocate import TpuAllocateAction

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def reference_gc_guard():
    """The JAX package's memory ledger drops a dead store's bytes from a
    ``weakref.finalize`` callback that takes the ledger's own mutex
    (kube_batch_tpu/metrics/memledger.py ``Ledger.track`` -> ``drop``):
    a cyclic collection that starts at an allocation inside ``track``
    runs that callback with the mutex held, and the process waits on
    itself forever.  These tests build many stores of both packages in
    one process, which makes the collision likely, so each test runs
    with the collector off, and a full collection before and after it
    runs the finalizers outside every ledger lock.  The port's ledger
    queues drops without a lock (tests/test_torch_memledger.py).  A
    test module that builds the JAX package's stores imports this
    fixture."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def build_resource_list(cpu, memory, **scalars):
    rl = {"cpu": cpu, "memory": memory}
    rl.update(scalars)
    return rl


def build_pod(namespace, name, nodename, phase, req, groupname="",
              labels=None, selector=None, priority=None, uid=None, ts=0.0,
              priority_class_name="", pkg="torch"):
    m = _package(pkg)
    return m.api.Pod(
        metadata=m.api.ObjectMeta(
            name=name, namespace=namespace, uid=uid or f"{namespace}-{name}",
            annotations=({m.v1alpha1.GroupNameAnnotationKey: groupname}
                         if groupname else {}),
            labels=labels or {}, creation_timestamp=ts),
        spec=m.api.PodSpec(node_name=nodename, node_selector=selector or {},
                           priority=priority,
                           priority_class_name=priority_class_name,
                           containers=[m.api.Container(requests=req)]),
        status=m.api.PodStatus(phase=phase),
    )


def build_node(name, alloc, labels=None, pkg="torch"):
    api = _package(pkg).api
    return api.Node(
        metadata=api.ObjectMeta(name=name, uid=name, labels=labels or {}),
        spec=api.NodeSpec(),
        status=api.NodeStatus(allocatable=alloc, capacity=dict(alloc)),
    )


def _package(name):
    """The modules of one package the harness drives, by attribute."""
    if name == "torch":
        return types.SimpleNamespace(
            api=torch_api, objects=torch_objects, queue_info=torch_queue_info,
            v1alpha1=torch_v1alpha1, cache=torch_cache,
            framework=torch_framework, tensorize=torch_tensorize,
            scheduler=torch_scheduler, actions=torch_actions,
            plugins=torch_plugins)
    import kube_batch_tpu.actions.factory as actions
    import kube_batch_tpu.api as api
    import kube_batch_tpu.api.objects as objects
    import kube_batch_tpu.api.queue_info as queue_info
    import kube_batch_tpu.apis.scheduling.v1alpha1 as v1alpha1
    import kube_batch_tpu.cache as cache
    import kube_batch_tpu.framework as framework
    import kube_batch_tpu.models.tensor_snapshot as tensorize
    import kube_batch_tpu.plugins.factory as plugins
    import kube_batch_tpu.scheduler as scheduler
    return types.SimpleNamespace(
        api=api, objects=objects, queue_info=queue_info, v1alpha1=v1alpha1,
        cache=cache, framework=framework, tensorize=tensorize,
        scheduler=scheduler, actions=actions, plugins=plugins)


class Pkg:
    """One package for the eviction twins: its modules by attribute (as
    ``_package``), its registries filled, its actions by name (the port's
    on the CPU with float64 keys when ``x64`` else float32), and the
    float context to run a body in.  A twin runs one body per package and
    compares what the two return."""

    ACTIONS = ("allocate", "backfill", "preempt", "reclaim", "tpu_allocate")

    def __init__(self, pkg, x64=True):
        import importlib
        self.pkg = pkg
        self.x64 = x64
        self.m = _package(pkg)
        self.dtype = torch.float64 if x64 else torch.float32
        root = "kube_batch_tpu_torch" if pkg == "torch" else "kube_batch_tpu"
        self.mod = types.SimpleNamespace(**{
            name.replace(".", "_"): importlib.import_module(f"{root}.{name}")
            for name in ("models.scanner", "models.victim_index",
                         "models.synthetic", "models.tensor_snapshot",
                         "models.shipping", "framework.commit",
                         "framework.events", "framework.statement",
                         "metrics.metrics", "trace", "trace.spans",
                         "trace.lineage", "chaos.plan", "chaos.breaker",
                         "conf", "plugins.conformance",
                         "plugins.nodeorder", "plugins.priority",
                         "api.job_info", "utils.priority_queue",
                         "ops.solver")
            + tuple(f"actions.{a}" for a in self.ACTIONS)})
        self.register()

    def ctx(self):
        if self.pkg == "jax":
            return jax.enable_x64(self.x64)
        return contextlib.nullcontext()

    def register(self):
        self.m.plugins.register_default_plugins()
        if self.pkg == "jax":
            self.m.actions.register_default_actions()
        else:
            self.m.actions.register_default_actions(device="cpu",
                                                    dtype=self.dtype)

    def action(self, name):
        """A fresh action of this package: ``name`` is a module of
        ``actions/`` (allocate, backfill, preempt, reclaim,
        tpu_allocate)."""
        module = getattr(self.mod, f"actions_{name}")
        if self.pkg == "jax" or name == "allocate":
            return module.new()
        return module.new(device="cpu", dtype=self.dtype)

    def load(self, conf=None):
        """(actions, tiers) of ``conf`` (the default conf when None)."""
        self.register()
        return self.m.scheduler.load_scheduler_conf(
            conf or self.m.scheduler.DEFAULT_SCHEDULER_CONF)

    def tiers(self, conf=None):
        return self.load(conf)[1]

    def scanner(self, ssn, **kw):
        """models/scanner.maybe_scanner, the port's on the CPU."""
        if self.pkg == "torch":
            kw = dict(kw, device="cpu", dtype=self.dtype)
        return self.mod.models_scanner.maybe_scanner(ssn, **kw)

    def empty_cache(self):
        """(cache, binder, evictor) with the fake effectors."""
        c = self.m.cache
        binder, evictor = c.FakeBinder(), c.FakeEvictor()
        cache = c.SchedulerCache(binder=binder, evictor=evictor,
                                 status_updater=c.FakeStatusUpdater(),
                                 volume_binder=c.FakeVolumeBinder())
        return cache, binder, evictor

    def queue(self, name, weight=1, ts=None):
        meta = (self.m.api.ObjectMeta(name=name) if ts is None else
                self.m.api.ObjectMeta(name=name, creation_timestamp=ts))
        return self.m.queue_info.Queue(metadata=meta, weight=weight)

    def pod_group(self, name, namespace, min_member=1, queue="q1"):
        v1 = self.m.v1alpha1
        return v1.PodGroup(
            metadata=self.m.api.ObjectMeta(name=name, namespace=namespace),
            spec=v1.PodGroupSpec(min_member=min_member, queue=queue))

    def pod(self, *args, **kw):
        return build_pod(*args, pkg=self.pkg, **kw)

    def node(self, *args, **kw):
        return build_node(*args, pkg=self.pkg, **kw)


def session_state(ssn):
    """Comparable end state of a session: per task its status and node."""
    return sorted((t.uid, t.status.name, t.node_name)
                  for job in ssn.jobs.values() for t in job.tasks.values())


def twin(body, *, x64=True):
    """Run ``body(p)`` for the JAX package and the port (``p`` a Pkg) and
    assert the two return the same; returns the port's result."""
    out = {}
    for pkg in ("jax", "torch"):
        p = Pkg(pkg, x64)
        with p.ctx():
            out[pkg] = body(p)
    assert out["torch"] == out["jax"]
    return out["torch"]


def build_cache(spec, pkg="torch"):
    """spec: dict with queues [(name, weight)], pod_groups [(name, ns, min,
    queue)], pods [(ns, name, node, phase, cpu, mem, group)], nodes
    [(name, cpu, mem)]; optional ``scalars`` {node or pod name:
    {resource: quantity}}.  Returns (cache, binder, status_updater)."""
    m = _package(pkg)
    api = m.api
    binder = m.cache.FakeBinder()
    status = m.cache.FakeStatusUpdater()
    cache = m.cache.SchedulerCache(binder=binder,
                                   evictor=m.cache.FakeEvictor(),
                                   status_updater=status,
                                   volume_binder=m.cache.FakeVolumeBinder())
    scalars = spec.get("scalars", {})
    for i, (name, weight) in enumerate(spec["queues"]):
        cache.add_queue(m.queue_info.Queue(
            metadata=api.ObjectMeta(name=name, creation_timestamp=float(i)),
            weight=weight))
    for name, ns, min_member, queue in spec["pod_groups"]:
        cache.add_pod_group(m.v1alpha1.PodGroup(
            metadata=api.ObjectMeta(name=name, namespace=ns),
            spec=m.v1alpha1.PodGroupSpec(min_member=min_member,
                                         queue=queue)))
    for name, cpu, mem in spec["nodes"]:
        cache.add_node(build_node(
            name, build_resource_list(cpu, mem, pods=110,
                                      **scalars.get(name, {})), pkg=pkg))
    for i, (ns, name, node, phase, cpu, mem, group) in enumerate(
            spec["pods"]):
        cache.add_pod(build_pod(
            ns, name, node, phase,
            build_resource_list(cpu, mem, **scalars.get(name, {})), group,
            ts=float(i), pkg=pkg))
    return cache, binder, status


@contextlib.contextmanager
def environ(env):
    """Set the ``KUBE_BATCH_TPU_*`` variables of ``env`` for the block."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _status_record(pg):
    st = pg.status
    return (pg.metadata.namespace, pg.metadata.name, st.phase, st.running,
            st.failed, st.succeeded,
            [(c.type, c.status, c.reason, c.message) for c in st.conditions])


def _leaves(inputs):
    return {name: np.asarray(leaf) for name, leaf in
            zip(type(inputs)._fields, inputs)}


def synthetic_cache(shape):
    """A ``build`` for run_session: each package's own
    ``make_synthetic_cache(*shape)``."""
    def build(_spec, pkg):
        if pkg == "torch":
            from kube_batch_tpu_torch.models.synthetic import \
                make_synthetic_cache
        else:
            from kube_batch_tpu.models.synthetic import make_synthetic_cache
        cache, binder = make_synthetic_cache(*shape)
        return cache, binder, cache.status_updater
    return build


def run_session(spec, pkg, *, x64=True, mutate=None, cycles=1,
                add_pods=None, echo=False, env=None, tensorize=True,
                build=build_cache):
    """Drive ``cycles`` sessions of ``open_session -> tpu-allocate ->
    close_session`` of package ``pkg`` ("jax" or "torch") on ``spec``.

    ``build(spec, pkg)`` makes (cache, binder, status updater);
    ``mutate(cache, m)`` edits the built cache (``m`` holds the package's
    modules); ``add_pods(cycle)`` lists spec pod tuples added before each
    cycle after the first; ``echo`` echoes every new bind back between
    cycles as the informer would, the pod Running on its node.  The JAX
    side runs under ``jax.enable_x64(x64)``, the port with float64 keys
    when ``x64`` else float32.  Returns a dict of the observables."""
    m = _package(pkg)
    env = dict(env or {})
    x64_ctx = jax.enable_x64(x64) if pkg == "jax" else contextlib.nullcontext()
    with environ(env), x64_ctx:
        cache, binder, status = build(spec, pkg)
        if mutate is not None:
            mutate(cache, m)
        m.plugins.register_default_plugins()
        if pkg == "jax":
            m.actions.register_default_actions()
            from kube_batch_tpu.actions.tpu_allocate import \
                TpuAllocateAction as JaxTpuAllocate
            action = JaxTpuAllocate()
        else:
            dtype = torch.float64 if x64 else torch.float32
            m.actions.register_default_actions(device="cpu", dtype=dtype)
            action = TpuAllocateAction(device="cpu", dtype=dtype)
        tiers = m.scheduler.DEFAULT_SCHEDULER_CONF
        if pkg == "jax":
            _, tiers = m.scheduler.load_scheduler_conf(tiers)
        else:
            tiers = m.scheduler.parse_scheduler_conf(tiers).tiers
        snaps = []
        pods_by_key = {}
        for cycle in range(cycles):
            if cycle and add_pods is not None:
                for i, pod in enumerate(add_pods(cycle)):
                    ns, name, node, phase, cpu, mem, group = pod
                    cache.add_pod(build_pod(
                        ns, name, node, phase, build_resource_list(cpu, mem),
                        group, ts=1000.0 * cycle + i, pkg=pkg))
            if cycle and echo:
                # The informer confirms each new bind: the pod comes back
                # Running on its node.
                for key, host in list(binder.binds.items()):
                    pod = pods_by_key.get(key)
                    if pod is None or pod.spec.node_name:
                        continue
                    bound = copy.deepcopy(pod)
                    bound.spec.node_name = host
                    bound.status.phase = "Running"
                    cache.update_pod(pod, bound)
                    pods_by_key[key] = bound
            for job in cache.jobs.values():
                for t in job.tasks.values():
                    pods_by_key.setdefault(f"{t.pod.metadata.namespace}/"
                                           f"{t.pod.metadata.name}", t.pod)
            ssn = m.framework.open_session(cache, tiers)
            try:
                if tensorize:
                    if pkg == "jax":
                        snap = m.tensorize.tensorize_session(ssn)
                    else:
                        snap = m.tensorize.tensorize_session(
                            ssn, torch.float64 if x64 else torch.float32)
                    snaps.append(snap)
                action.execute(ssn)
            finally:
                m.framework.close_session(ssn)
    return dict(
        binds=list(binder.binds.items()), channel=list(binder.channel),
        statuses=[_status_record(pg) for pg in status.pod_groups],
        conditions=list(status.pod_conditions), events=list(cache.events),
        snaps=snaps, action=action)


def assert_same_snapshot(jax_snap, torch_snap):
    """The two tensorizations agree leaf by leaf and field by field."""
    assert jax_snap.needs_fallback == torch_snap.needs_fallback
    assert jax_snap.fallback_reason == torch_snap.fallback_reason
    if jax_snap.needs_fallback:
        return
    assert jax_snap.resource_names == torch_snap.resource_names
    assert jax_snap.node_names == torch_snap.node_names
    assert jax_snap.job_uids == torch_snap.job_uids
    a, b = _leaves(jax_snap.inputs), _leaves(torch_snap.inputs)
    assert list(a) == list(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert a[name].shape == b[name].shape, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    jcfg, tcfg = jax_snap.config, torch_snap.config
    assert jcfg._fields == tcfg._fields
    for field in jcfg._fields:
        jv, tv = getattr(jcfg, field), getattr(tcfg, field)
        if field == "weights":
            assert tuple(jv) == tuple(tv)
        else:
            assert jv == tv, field


def assert_session_parity(spec, *, x64=True, mutate=None, env=None,
                          jax_env=None, **kw):
    """JAX tpu-allocate and the port's on ``spec``: binds in order, pod
    group statuses, pod conditions and every tensorization equal."""
    jax_out = run_session(spec, "jax", x64=x64, mutate=mutate,
                          env=jax_env if jax_env is not None else env, **kw)
    torch_out = run_session(spec, "torch", x64=x64, mutate=mutate, env=env,
                            **kw)
    assert torch_out["binds"] == jax_out["binds"]
    assert torch_out["channel"] == jax_out["channel"]
    assert torch_out["statuses"] == jax_out["statuses"]
    assert torch_out["conditions"] == jax_out["conditions"]
    assert torch_out["events"] == jax_out["events"]
    assert len(jax_out["snaps"]) == len(torch_out["snaps"])
    for js, ts in zip(jax_out["snaps"], torch_out["snaps"]):
        assert_same_snapshot(js, ts)
    return jax_out, torch_out


class Arm:
    """One package's long-lived synthetic cluster, driven session by
    session for the incremental and candidate-row cases: the port
    (``pkg="torch"``, float64 keys when ``x64`` else float32) or the JAX
    package (every call under ``jax.enable_x64(x64)``).  Each step takes
    the same arguments in both packages, so two arms run one schedule of
    churn twice and the tests compare what they observe."""

    def __init__(self, pkg, shape, *, n_signatures=1, x64=True, conf=None):
        self.pkg = pkg
        self.x64 = x64
        self.m = m = _package(pkg)
        self.dtype = torch.float64 if x64 else torch.float32
        if pkg == "torch":
            from kube_batch_tpu_torch.models import incremental
            from kube_batch_tpu_torch.models.synthetic import \
                make_synthetic_cache
            m.plugins.register_default_plugins()
            m.actions.register_default_actions(device="cpu",
                                               dtype=self.dtype)
            self.action = TpuAllocateAction(device="cpu", dtype=self.dtype)
        else:
            from kube_batch_tpu.actions.tpu_allocate import \
                TpuAllocateAction as JaxTpuAllocate
            from kube_batch_tpu.models import incremental
            from kube_batch_tpu.models.synthetic import make_synthetic_cache
            m.plugins.register_default_plugins()
            m.actions.register_default_actions()
            self.action = JaxTpuAllocate()
        self.incremental = incremental
        self.tiers = self.tiers_of(conf or m.scheduler.DEFAULT_SCHEDULER_CONF)
        with self.ctx():
            self.cache, self.binder = make_synthetic_cache(
                *shape, n_signatures=n_signatures)

    def ctx(self):
        if self.pkg == "jax":
            return jax.enable_x64(self.x64)
        return contextlib.nullcontext()

    def tiers_of(self, conf):
        if self.pkg == "jax":
            return self.m.scheduler.load_scheduler_conf(conf)[1]
        return self.m.scheduler.parse_scheduler_conf(conf).tiers

    def open(self, tiers=None):
        with self.ctx():
            return self.m.framework.open_session(self.cache,
                                                 tiers or self.tiers)

    def close(self, ssn):
        with self.ctx():
            self.m.framework.close_session(ssn)

    def tensorize(self, ssn):
        with self.ctx():
            if self.pkg == "jax":
                return self.m.tensorize.tensorize_session(ssn)
            return self.m.tensorize.tensorize_session(ssn, self.dtype)

    def cycle(self, echo=True):
        """One open -> tpu-allocate -> close session; returns the new
        binds as a sorted tuple, then echoes them when ``echo``."""
        ssn = self.open()
        try:
            with self.ctx():
                self.action.execute(ssn)
        finally:
            self.close(ssn)
        binds = tuple(sorted(self.binder.binds.items()))
        if echo:
            self.echo()
        return binds

    def echo(self):
        """The informer echo: binds back as Running pods, pod-group
        status writes back into the cache."""
        api = self.m.api
        podmap = {api.pod_key(t.pod): t.pod
                  for job in self.cache.jobs.values()
                  for t in job.tasks.values()}
        for key, node in sorted(self.binder.binds.items()):
            old = podmap.get(key)
            if old is None:
                continue
            new = dataclasses.replace(
                old, spec=dataclasses.replace(old.spec, node_name=node),
                status=api.PodStatus(phase="Running"))
            self.cache.update_pod(old, new)
        self.binder.binds.clear()
        updater = self.cache.status_updater
        for pg in updater.pod_groups:
            self.cache.add_pod_group(pg)
        updater.pod_groups.clear()

    def pod_group(self, name, min_member=1, queue="q0", ns="bench"):
        v1 = self.m.v1alpha1
        return v1.PodGroup(
            metadata=self.m.api.ObjectMeta(name=name, namespace=ns),
            spec=v1.PodGroupSpec(min_member=min_member, queue=queue))

    def add_churn_job(self, tag, n_pods=3, cpu="500m", mem="1Gi",
                      queue="q0", ports=None, min_member=1, ts=1e6):
        api = self.m.api
        pg = f"churn-{tag}"
        self.cache.add_pod_group(self.pod_group(pg, min_member, queue))
        pods = []
        for i in range(n_pods):
            pod = api.Pod(
                metadata=api.ObjectMeta(
                    name=f"{pg}-{i}", namespace="bench", uid=f"{pg}-{i}",
                    annotations={
                        self.m.v1alpha1.GroupNameAnnotationKey: pg},
                    creation_timestamp=ts + i),
                spec=api.PodSpec(containers=[api.Container(
                    requests={"cpu": cpu, "memory": mem},
                    ports=[api.ContainerPort(host_port=p, protocol="TCP")
                           for p in (ports or [])])]),
                status=api.PodStatus(phase="Pending"))
            self.cache.add_pod(pod)
            pods.append(pod)
        return pg, pods

    def running_task(self):
        jobs = self.cache.jobs
        for uid in sorted(jobs):
            for tuid in sorted(jobs[uid].tasks):
                t = jobs[uid].tasks[tuid]
                if t.node_name:
                    return t
        raise AssertionError("no running task")

    def update_node_alloc(self, name, cpu="32", memory="128Gi", pods=200):
        node = self.cache.nodes[name].node
        alloc = {"cpu": cpu, "memory": memory, "pods": pods}
        self.cache.update_node(node, dataclasses.replace(
            node, status=self.m.api.NodeStatus(allocatable=dict(alloc),
                                               capacity=dict(alloc))))

    def add_node(self, name, alloc):
        api = self.m.api
        self.cache.add_node(api.Node(
            metadata=api.ObjectMeta(name=name, uid=name), spec=api.NodeSpec(),
            status=api.NodeStatus(allocatable=dict(alloc),
                                  capacity=dict(alloc))))

    def state(self):
        return self.incremental.state_for(self.cache, create=False)

    def oracle_snapshot(self, ssn):
        """From-scratch tensorize of the SAME session: every persistent
        cache detached and KUBE_BATCH_TPU_INCREMENTAL=0."""
        cache = ssn.cache
        saved = {}
        attrs = ("_tensor_cache", "_inc_state", "_ship_cache")
        for attr in attrs:
            if hasattr(cache, attr):
                saved[attr] = getattr(cache, attr)
                delattr(cache, attr)
        try:
            with environ({self.incremental.INCREMENTAL_ENV: "0"}):
                return self.tensorize(ssn)
        finally:
            for attr in attrs:
                if hasattr(cache, attr):
                    delattr(cache, attr)
            for attr, value in saved.items():
                setattr(cache, attr, value)


def assert_same_inputs(a, b, ctx=""):
    """Two tensorizations of one package (or of both) equal: names,
    orders, config and every SolverInputs leaf, dtype included."""
    assert a.needs_fallback == b.needs_fallback, ctx
    if a.needs_fallback:
        return
    assert a.node_names == b.node_names, ctx
    assert a.job_uids == b.job_uids, ctx
    assert a.queue_ids == b.queue_ids, ctx
    assert list(a.resource_names) == list(b.resource_names), ctx
    assert [t.uid for t in a.tasks] == [t.uid for t in b.tasks], ctx
    assert [t.uid for t in a.tasks_extra] == \
        [t.uid for t in b.tasks_extra], ctx
    assert np.array_equal(a.task_job, b.task_job), ctx
    assert np.array_equal(a.task_res_f64, b.task_res_f64), ctx
    assert tuple(a.config.job_key_order) == tuple(b.config.job_key_order)
    for field in ("queue_key_order", "has_gang", "has_proportion",
                  "has_ports", "has_pod_affinity", "has_pod_affinity_score"):
        assert getattr(a.config, field) == getattr(b.config, field), \
            (ctx, field)
    assert tuple(a.config.weights) == tuple(b.config.weights), ctx
    la, lb = _leaves(a.inputs), _leaves(b.inputs)
    assert list(la) == list(lb), ctx
    for name in la:
        assert la[name].dtype == lb[name].dtype, (ctx, name)
        assert np.array_equal(la[name], lb[name]), (ctx, name)


class Loop:
    """One package's modules for the Scheduler-loop twins (tenancy, the
    concurrent shard pipeline, federation, the end-to-end harness), by
    attribute: ``objects`` (api.objects), ``v1alpha1``, ``v1alpha2``,
    ``cache`` (Cluster, new_scheduler_cache), ``tenancy``, ``leases``,
    ``shards``, ``chaos_plan``, ``metrics``, ``tenants``, ``lineage``
    (the pod-lineage ring), ``spans``, ``solver``, ``shipping``,
    ``incremental``, ``synthetic``, ``job_info``, ``api``, ``sched_mod``
    (the scheduler module).
    ``scheduler(cache, **kw)`` builds the package's Scheduler: the
    port's on the CPU with float64 keys when ``x64`` else float32.  A
    body runs once per package (``loop_twin``) and must set every env
    var it reads at its own start."""

    def __init__(self, pkg, x64=True):
        import importlib
        self.pkg = pkg
        self.x64 = x64
        self.dtype = torch.float64 if x64 else torch.float32
        root = "kube_batch_tpu_torch" if pkg == "torch" else "kube_batch_tpu"

        def mod(name):
            return importlib.import_module(f"{root}.{name}")

        self.api = mod("api")
        self.objects = mod("api.objects")
        self.job_info = mod("api.job_info")
        self.v1alpha1 = mod("apis.scheduling.v1alpha1")
        self.v1alpha2 = mod("apis.scheduling.v1alpha2")
        self.cache = mod("cache")
        self.tenancy = mod("tenancy")
        self.leases = mod("tenancy.leases")
        self.shards = mod("tenancy.shards")
        self.chaos_plan = mod("chaos.plan")
        self.metrics = mod("metrics.metrics")
        self.tenants = mod("metrics.tenants")
        self.lineage = mod("trace.lineage").lineage
        self.spans = mod("trace.spans")
        self.solver = mod("ops.solver")
        self.shipping = mod("models.shipping")
        self.incremental = mod("models.incremental")
        self.synthetic = mod("models.synthetic")
        self.sched_mod = mod("scheduler")

    def ctx(self):
        if self.pkg == "jax":
            return jax.enable_x64(self.x64)
        return contextlib.nullcontext()

    def scheduler(self, cache, **kw):
        if self.pkg == "torch":
            kw.setdefault("device", "cpu")
            kw.setdefault("dtype", self.dtype)
        return self.sched_mod.Scheduler(cache, **kw)

    def queue(self, cluster, name, weight=1):
        o, v1 = self.objects, self.v1alpha1
        cluster.create_queue(v1.Queue(metadata=o.ObjectMeta(name=name),
                                      spec=v1.QueueSpec(weight=weight)))

    def node(self, name, labels=None, cpu="4", mem="8Gi", pods=110):
        o = self.objects
        alloc = {"cpu": cpu, "memory": mem, "pods": pods}
        return o.Node(metadata=o.ObjectMeta(name=name, uid=name,
                                            labels=dict(labels or {})),
                      spec=o.NodeSpec(),
                      status=o.NodeStatus(allocatable=alloc,
                                          capacity=dict(alloc)))

    def pod_group(self, name, ns, min_member, queue, **spec):
        o, v1 = self.objects, self.v1alpha1
        return v1.PodGroup(
            metadata=o.ObjectMeta(name=name, namespace=ns),
            spec=v1.PodGroupSpec(min_member=min_member, queue=queue, **spec))


def loop_twin(body, *, x64=True):
    """Run ``body(lp)`` for the JAX package and the port (``lp`` a Loop)
    and assert the two return the same; returns the port's result."""
    out = {}
    for pkg in ("jax", "torch"):
        lp = Loop(pkg, x64)
        with lp.ctx():
            out[pkg] = body(lp)
    assert out["torch"] == out["jax"]
    return out["torch"]


def bind_map(cluster):
    """{pod key: node} of every bound pod in a Cluster."""
    with cluster.lock:
        return {k: p.spec.node_name for k, p in cluster.pods.items()
                if p.spec.node_name}


# -- fused one-dispatch sessions (tests/test_torch_fused*.py) -------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def storm_conf_text():
    """The shipped four-action conf with tpu-allocate in place of
    allocate (tests/test_fused.py's ``_storm_conf``)."""
    with open(os.path.join(REPO, "config", "kube-batch-conf.yaml")) as fh:
        return fh.read().replace('"reclaim, allocate, backfill, preempt"',
                                 '"reclaim, tpu-allocate, backfill, preempt"')


def drive_stamped(p, cache, actions, tiers):
    """One manually driven session of package ``p`` (a Pkg), the conf's
    ladder stamped on it as Scheduler.session_once stamps it (the fused
    dispatcher keys on it).  Returns the end state."""
    fw = p.m.framework
    ssn = fw.open_session(cache, tiers)
    ssn._conf_actions = tuple(a.name() for a in actions)
    try:
        for a in actions:
            a.execute(ssn)
        return session_state(ssn)
    finally:
        fw.close_session(ssn)


def fused_deltas(p, fn):
    """Run ``fn`` and return (result, session-dispatch delta, fused-leg
    outcome delta, fused route delta) of package ``p``.  Only the
    ``fused/*`` routes are compared across packages: the per-family
    route labels differ by design (``xla`` vs ``torch``)."""
    mm = p.mod.metrics_metrics
    before = (mm.session_dispatch_counts(), mm.fused_leg_counts(),
              mm.route_counts())
    result = fn()
    after = (mm.session_dispatch_counts(), mm.fused_leg_counts(),
             mm.route_counts())

    def delta(a, b):
        return {k: b[k] - a.get(k, 0) for k in sorted(b)
                if b[k] - a.get(k, 0)}
    disp, legs, routes = (delta(a, b) for a, b in zip(before, after))
    return result, disp, legs, {k: v for k, v in routes.items()
                                if k.startswith("fused/")}
