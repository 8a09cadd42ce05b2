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
import os
import types

import jax
import numpy as np
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
